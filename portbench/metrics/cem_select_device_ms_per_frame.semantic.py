"""Device ms a frame of the operations between the program's
`cem.select` stage marks: the CEM's sampling, elite sort and refit."""
from portbench.program_trace import stage_ms_per_unit


def read(run):
    return stage_ms_per_unit(run, "cem.select")
