"""mrays_per_s (Mrays/s): every ray of every call that the window
completed, over the window's seconds."""


def read(run):
    return run.calls * run.rays_per_call / run.window_s / 1e6
