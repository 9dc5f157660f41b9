"""Set-up time: from the process start to the first timed frame: the
kernels loaded (built on a checkout's first run), the inputs made, the
cell's shapes warmed up and captured."""


def read(run):
    return run.setup_s
