"""The displaced heightfield grid: an (n + 1)^2 vertex grid over
[-extent/2, extent/2]^2 with heights from six random smooth waves, two
triangles a cell, 2 n^2 triangles. A frozen copy of the arithmetic of
``raycore_tpu_torch/scene/mesh.py:displaced_grid_mesh``; the waves are
drawn from the configuration's ``seed`` (0: the repository's headline
scene of ``bench.py`` and ``chip_smoke.py``), not from the run's, so
every run does the same work.

Cell (i, j) spans vertices a = (i, j), b = (i+1, j), c = (i+1, j+1),
d = (i, j+1) (i along x); its triangles are (a, b, c), face i n + j,
and (a, c, d), face n^2 + i n + j, both wound upward.
"""
from __future__ import annotations

import numpy as np


def generate(params: dict) -> dict:
    n, extent, amplitude = (params["n"], params["extent"],
                            params["amplitude"])
    rng = np.random.default_rng(params["seed"])
    xs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = np.zeros_like(X)
    for _ in range(6):
        fx, fy = rng.uniform(0.5, 4.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        Z += np.sin(fx * X * np.pi + ph[0]) * np.sin(fy * Y * np.pi + ph[1])
    Z *= amplitude / 6.0
    verts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([a, c, d], -1)]).astype(np.int64)
    return dict(verts=verts, faces=faces, normals=None,
                face_under=lambda xy: face_under(n, xs, xy))


def face_under(n: int, xs: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """The face whose xy projection holds each point of ``xy`` (P, 2)
    inside the grid of vertex coordinates ``xs``."""
    xs = xs.astype(np.float64)
    i, j = (np.clip(np.searchsorted(xs, xy[:, k], "right") - 1, 0, n - 1)
            for k in (0, 1))
    fx = (xy[:, 0] - xs[i]) / (xs[i + 1] - xs[i])
    fy = (xy[:, 1] - xs[j]) / (xs[j + 1] - xs[j])
    upper = fy > fx                      # (a, c, d)
    return np.where(upper, n * n, 0) + i * n + j
