"""Host ms a frame (a stream-frame in the fleet) in the program's
`graph.copy_in` and `graph.copy_out` spans: StepGraph's copies around
each replay, from the program's own recorder."""
from portbench.program_trace import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("graph.copy_in", "graph.copy_out"))
