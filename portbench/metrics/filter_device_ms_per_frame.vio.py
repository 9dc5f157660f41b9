"""Device ms a frame (a stream-frame in the fleet) of the operations
between the program's `filter` stage marks: the MSCKF frame step."""
from portbench.program_trace import stage_ms_per_unit


def read(run):
    return stage_ms_per_unit(run, "filter")
