"""Device ms a frame of the operations between the program's `frontend`
stage marks: the tracker's pyramid, K2, K1 and their glue."""
from portbench.program_trace import stage_ms_per_unit


def read(run):
    return stage_ms_per_unit(run, "frontend")
