"""Host ms a frame in the program's `semantic.spawn` spans: the spawns of
new objects, each its retrieval and the track it makes. None where the
program records no such span."""
from portbench.program_trace import span_count, span_ms_per_unit


def read(run):
    if not span_count(run, "semantic.spawn"):
        return None
    return span_ms_per_unit(run, ("semantic.spawn",))
