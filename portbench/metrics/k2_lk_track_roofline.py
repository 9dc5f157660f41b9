"""k2_lk_track's share of its roofline over the traced window, in %."""
from portbench.roofline import share


def read(run):
    return share(run, "k2_lk_track")
