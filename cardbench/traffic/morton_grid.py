"""Primary rays: a side x side grid of origins at height z over
[-half, half]^2 looking straight down, each jittered inside its pixel,
in Morton pixel order; ``batches`` such grids, each with its own jitter
(``bench.py``'s and ``chip_smoke.py:morton_grid_rays``'s headline rays,
jittered)."""
from __future__ import annotations

import numpy as np

from cardbench.core.grids import as_batch, jittered_grid, seed_rng

STREAM = 3


def generate(params: dict, seed: int, scene: dict, device) -> list:
    side, half, z = params["side"], params["half"], params["z"]
    out = []
    for b in range(params["batches"]):
        xy = jittered_grid(side, half, seed_rng(seed, STREAM, b))
        o = np.concatenate([xy, np.full((xy.shape[0], 1), z)], 1)
        d = np.broadcast_to(np.array([0.0, 0.0, -1.0]), o.shape)
        out.append(as_batch(o, d, 0.0, np.inf, device))
    return out

