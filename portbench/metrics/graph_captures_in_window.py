"""The program's `graph.capture` spans (a warm-up step or a capture of
the graph runtime) that start inside the kept traced window: 0 when
nothing is built again there."""
from portbench.program_trace import span_count


def read(run):
    return span_count(run, "graph.capture")
