"""Host ms a frame in the program's `semantic.readback` spans: the sync
step's read of the refined poses and scores, which waits for the frame's
CEM. None where the program records no such span."""
from portbench.program_trace import span_count, span_ms_per_unit


def read(run):
    if not span_count(run, "semantic.readback"):
        return None
    return span_ms_per_unit(run, ("semantic.readback",))
