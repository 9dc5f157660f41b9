"""95th percentile over every step of the window, each timed from handing
the frame to `VioPipeline.step` until its pose is on the host."""
from portbench.readers import percentile


def read(run):
    return None if run.trace else percentile(run.latencies_ms, 95.0)
