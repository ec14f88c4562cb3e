"""Instances of a few base meshes, placed from the configuration's seed
(the source's draw: ``examples/dynamic_refit.py:28``), not from the
run's, so every run does the same work.

Base meshes are UV spheres and axis-aligned boxes, frozen copies of the
arithmetic of ``raycore_tpu_torch/scene/mesh.py`` (``uv_sphere``,
``box_mesh``). Instance i takes base ``i % len(bases)`` and a centre
drawn uniformly from the box ``centers``; a face's index in its base mesh
is its metadata.
"""
from __future__ import annotations

import numpy as np


def uv_sphere(center, radius, n_theta, n_phi):
    """(vertices, faces, normals) of a UV sphere, faces wound outward,
    the pole rows' degenerate halves left out."""
    center = np.asarray(center, np.float32)
    thetas = np.linspace(0, np.pi, n_theta + 1)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(thetas, phis, indexing="ij")
    pts = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)],
                   -1).reshape(-1, 3).astype(np.float32)
    verts = center + radius * pts
    I, J = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a = I * n_phi + J
    b = I * n_phi + (J + 1) % n_phi
    c = (I + 1) * n_phi + (J + 1) % n_phi
    d = (I + 1) * n_phi + J
    cell = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)],
                    axis=2)
    valid = np.stack([I > 0, I < n_theta - 1], axis=2)
    faces = cell.reshape(-1, 3)[valid.ravel()].astype(np.int64)
    tv = verts[faces]
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    flip = np.einsum("ij,ij->i", n, tv.mean(1) - center) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces, pts


def box(p_min, p_max):
    """(vertices, faces, None) of an axis-aligned box, 12 triangles
    wound outward."""
    p0 = np.asarray(p_min, np.float32)
    p1 = np.asarray(p_max, np.float32)
    corners = np.array([[p1[0] if i & 1 else p0[0], p1[1] if i & 2 else p0[1],
                         p1[2] if i & 4 else p0[2]] for i in range(8)],
                       np.float32)
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3),
             (0, 4, 6, 2), (1, 3, 7, 5)]
    faces = [f for a, b, c, d in quads for f in ((a, b, c), (a, c, d))]
    return corners, np.asarray(faces, np.int64), None


def base_mesh(spec: dict):
    if spec["kind"] == "sphere":
        return uv_sphere(spec.get("center", (0, 0, 0)), spec["radius"],
                         spec["n_theta"], spec["n_phi"])
    if spec["kind"] == "box":
        return box(spec["p_min"], spec["p_max"])
    raise ValueError(f"unknown base mesh kind {spec['kind']!r}")


def generate(params: dict) -> dict:
    """``bases``: [(vertices, faces, normals)], ``base_of`` (N,),
    ``centers`` (N, 3) float32, drawn uniformly in the box ``centers``
    instance after instance, x, y, z each."""
    rng = np.random.default_rng(params["seed"])
    bases = [base_mesh(b) for b in params["bases"]]
    N = params["count"]
    lo, hi = (np.asarray(c, np.float64) for c in params["centers"])
    centers = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    base_of = np.arange(N) % len(bases)
    return dict(bases=bases, base_of=base_of, centers=centers)


def world_triangles(scene: dict, transforms: np.ndarray):
    """(T, 3, 3) float64 world-space triangles of every instance in turn
    under ``transforms`` (N, 3, 4), and the first row of each instance."""
    out, first, row = [], [], 0
    for i, b in enumerate(scene["base_of"]):
        v, f, _ = scene["bases"][b]
        m = transforms[i].astype(np.float64)
        tri = v.astype(np.float64)[f]
        out.append(tri @ m[:, :3].T + m[:, 3])
        first.append(row)
        row += f.shape[0]
    return np.concatenate(out), np.asarray(first, np.int64)
