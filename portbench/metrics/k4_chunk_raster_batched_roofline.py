"""k4_chunk_raster_batched's share of its roofline over the traced window, in %."""
from portbench.roofline import share


def read(run):
    return share(run, "k4_chunk_raster_batched")
