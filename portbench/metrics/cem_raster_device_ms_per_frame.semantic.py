"""Device ms a frame of the operations between the program's
`cem.raster` stage marks: the hypothesis windows' triangle set-up and
K4."""
from portbench.program_trace import stage_ms_per_unit


def read(run):
    return stage_ms_per_unit(run, "cem.raster")
