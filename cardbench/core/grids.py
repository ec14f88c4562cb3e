"""What the traffic generators share: the seed streams they draw from,
a side x side grid of pixel positions jittered inside each pixel in
Morton pixel order, and the ray batch they hand over.
"""
from __future__ import annotations

import numpy as np
import torch


def seed_rng(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one stream of a run's seed: any whole number
    (negative ones wrap to 64 bits), and small integer tags."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, *tags]))


def morton_order(side: int) -> np.ndarray:
    """The row-major pixel indices of a side x side grid (side a power
    of two) in Morton order, x (the first index) on the odd bits."""
    def spread(v):
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    z = spread(np.arange(side, dtype=np.uint64))
    code = (z[:, None] << np.uint64(1)) | z[None, :]
    return np.argsort(code.reshape(-1), kind="stable")


def jittered_grid(side: int, half: float, rng) -> np.ndarray:
    """(side^2, 2) float64 positions in Morton pixel order: pixel centres
    on ``np.linspace(-half, half, side)`` in x and y, each moved
    uniformly within its pixel."""
    xs = np.linspace(-half, half, side)
    step = xs[1] - xs[0]
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    xy = np.stack([X, Y], -1).reshape(-1, 2)
    xy = xy + (rng.random(xy.shape) - 0.5) * step
    return xy[morton_order(side)]


def as_batch(o, d, t_min, t_max, device) -> dict:
    """A ray batch: float32 tensors ``o``, ``d`` (R, 3) and ``t_min``,
    ``t_max`` (R,) on ``device``."""
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=device)
    R = o.shape[0]
    return dict(o=f32(o), d=f32(d),
                t_min=f32(np.broadcast_to(np.float32(t_min), (R,))),
                t_max=f32(np.broadcast_to(t_max, (R,)).astype(np.float32)))
