"""frame_ms (ms): the window's seconds over the frames it completed."""


def read(run):
    return run.window_s / run.calls * 1e3
