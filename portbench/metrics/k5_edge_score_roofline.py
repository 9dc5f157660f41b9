"""k5_edge_score's share of its roofline over the traced window, in %."""
from portbench.roofline import share


def read(run):
    return share(run, "k5_edge_score")
