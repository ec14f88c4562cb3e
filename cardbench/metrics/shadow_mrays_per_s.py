"""shadow_mrays_per_s (Mrays/s): every shadow ray of every any_hit call
that the window completed, over the window's seconds."""


def read(run):
    return run.calls * run.rays_per_call / run.window_s / 1e6
