"""Shadow rays from a surface toward point lights (a renderer's
next-event estimation): under each jittered Morton grid position the
surface point of the face below it, lifted ``lift`` along that face's
unit normal turned toward the ray's light; the ray aims at one of the
``lights``, drawn per ray, with t_max the distance to it. ``batches``
such sets, each with its own jitter and draws. The scene supplies
``face_under`` (grid position -> face)."""
from __future__ import annotations

import numpy as np

from cardbench.core.grids import as_batch, jittered_grid, seed_rng

STREAM = 4


def surface_points(verts, faces, face, xy):
    """(P, 3) points of faces ``face`` above ``xy`` and their upward unit
    normals, in float64."""
    tri = verts[faces[face]].astype(np.float64)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    e1, e2 = b - a, c - a
    # Barycentric coordinates of xy in the triangle's xy projection.
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    p = xy - a[:, :2]
    u = (p[:, 0] * e2[:, 1] - p[:, 1] * e2[:, 0]) / det
    w = (e1[:, 0] * p[:, 1] - e1[:, 1] * p[:, 0]) / det
    z = a[:, 2] + u * e1[:, 2] + w * e2[:, 2]
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n *= np.sign(n[:, 2:3])
    return np.concatenate([xy, z[:, None]], 1), n


def generate(params: dict, seed: int, scene: dict, device) -> list:
    lights = np.asarray(params["lights"], np.float64)
    out = []
    for b in range(params["batches"]):
        rng = seed_rng(seed, STREAM, b)
        xy = jittered_grid(params["side"], params["half"], rng)
        p, n = surface_points(scene["verts"], scene["faces"],
                              scene["face_under"](xy), xy)
        light = lights[rng.integers(0, len(lights), xy.shape[0])]
        n = np.where(((light - p) * n).sum(1, keepdims=True) < 0, -n, n)
        o = p + params["lift"] * n
        to = light - o.astype(np.float32).astype(np.float64)
        dist = np.linalg.norm(to, axis=1)
        out.append(as_batch(o, to / dist[:, None], 0.0, dist, device))
    return out
