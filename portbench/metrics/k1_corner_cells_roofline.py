"""k1_corner_cells's share of its roofline over the traced window, in %."""
from portbench.roofline import share


def read(run):
    return share(run, "k1_corner_cells")
