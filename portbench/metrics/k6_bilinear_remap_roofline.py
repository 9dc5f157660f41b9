"""k6_bilinear_remap's share of its roofline over the traced window, in %."""
from portbench.roofline import share


def read(run):
    return share(run, "k6_bilinear_remap")
