"""ANSI terminal colors (reference parity: feh::TermColor, core/utils.cpp:18-28).
A copy of visma_tpu/utils/term.py: the reference's `utils` package imports
jax."""


class TermColor:
    red = "\033[91m"
    green = "\033[92m"
    yellow = "\033[93m"
    blue = "\033[94m"
    magenta = "\033[95m"
    cyan = "\033[96m"
    white = "\033[97m"
    bold = "\033[1m"
    end = "\033[0m"
    endl = "\033[0m\n"

    @staticmethod
    def wrap(text: str, color: str) -> str:
        return f"{color}{text}{TermColor.end}"
