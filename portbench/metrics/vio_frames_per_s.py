"""Camera frames (stream-frames in a fleet) whose pose the entry produced
and handed back, over the whole measured window, host clock."""


def read(run):
    if run.window_s is None or run.trace:
        return None
    return run.frames / run.window_s
