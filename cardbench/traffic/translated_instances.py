"""An instanced scene moved as Raycore.jl's ``wavefront_dynamic.jl``
refit experiment moves it (``examples/dynamic_refit.py:36``: every
instance shifted by ``step`` a frame), under one downward ray grid
(``side`` x ``side`` origins at height z over [-half, half]^2, each
jittered inside its pixel from the seed, in row order as a camera
scans). ``sets`` frames of transforms: set s holds the poses after s + 1
frames, ``initial`` those at rest (identity rotation, at the scene's
centres)."""
from __future__ import annotations

import numpy as np

from cardbench.core.grids import as_batch, seed_rng

STREAM = 5


def pose(centers):
    """(N, 3, 4) float32 transforms: the identity rotation and a
    translation to ``centers`` (N, 3)."""
    m = np.zeros((centers.shape[0], 3, 4))
    m[:, :, :3] = np.eye(3)
    m[:, :, 3] = centers
    return m.astype(np.float32)


def generate(params: dict, seed: int, scene: dict, device) -> dict:
    side, half, z = params["side"], params["half"], params["z"]
    xs = np.linspace(-half, half, side)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    xy = np.stack([X, Y], -1).reshape(-1, 2)
    xy = xy + (seed_rng(seed, STREAM).random(xy.shape) - 0.5) * (xs[1] - xs[0])
    o = np.concatenate([xy, np.full((xy.shape[0], 1), z)], 1)
    d = np.broadcast_to(np.array([0.0, 0.0, -1.0]), o.shape)
    centers = scene["centers"].astype(np.float64)
    step = np.asarray(params["step"], np.float64)
    transforms = np.stack([pose(centers + k * step)
                           for k in range(1, params["sets"] + 1)])
    return dict(rays=as_batch(o, d, 0.0, np.inf, device),
                transforms=transforms, initial=pose(centers))
