"""Host ms a frame in the program's `semantic.dedup` spans: each
detection's `_covered` test against the tracks. None where the program
records no such span."""
from portbench.program_trace import span_count, span_ms_per_unit


def read(run):
    if not span_count(run, "semantic.dedup"):
        return None
    return span_ms_per_unit(run, ("semantic.dedup",))
