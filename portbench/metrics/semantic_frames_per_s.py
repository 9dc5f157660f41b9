"""Frames through `SemanticMapper.step` over the whole measured window,
the mapper drained inside it, host clock."""


def read(run):
    if run.window_s is None or run.trace:
        return None
    return run.frames / run.window_s
