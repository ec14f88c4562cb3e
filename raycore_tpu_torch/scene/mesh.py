"""Procedural meshes (counterpart of ``raycore_tpu/scene/mesh.py``,
partial: ``build_triangles``, ``build_triangle``, ``is_degenerate_face``,
``uv_sphere``, ``sphere_mesh``, ``box_mesh``, ``plane_mesh``,
``blobby_mesh`` and ``displaced_grid_mesh``).

The geometry is built on the host in NumPy with the same code and the same
``default_rng(seed)`` draws as the JAX package, so both packages get the
same bits; the result is handed over as tensors on the requested device,
the CUDA card unless the caller passes another.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import default_device
from ..core.triangle import Triangle


def build_triangles(vertices, faces, normals=None, uvs=None, metadata=None,
                    drop_degenerate=True, device=None) -> Triangle:
    """Triangle SoA from indexed mesh data.

    ``vertices``: (V, 3) float; ``faces``: (F, 3) int (0-based);
    ``normals``/``uvs``: optional per-vertex data; ``metadata``: (F,) uint32
    values or a callable ``face_idx -> int``, defaulting to the face index.
    Faces with a zero cross product are dropped. ``device`` defaults to
    the CUDA card (``core/device.py``)."""
    device = default_device(device)
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    tri_v = vertices[faces]                      # (F, 3, 3)

    if metadata is None:
        meta = np.arange(len(faces), dtype=np.uint32)
    elif callable(metadata):
        meta = np.asarray([metadata(i) for i in range(len(faces))], np.uint32)
    else:
        meta = np.asarray(metadata, np.uint32)

    if normals is not None:
        tri_n = np.asarray(normals, np.float32)[faces]
    else:
        e1 = tri_v[:, 1] - tri_v[:, 0]
        e2 = tri_v[:, 2] - tri_v[:, 0]
        fn = np.cross(e1, e2)
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.where(ln > 0, ln, 1.0)
        tri_n = np.repeat(fn[:, None, :], 3, axis=1)

    tri_uv = (np.asarray(uvs, np.float32)[faces] if uvs is not None
              else np.zeros((len(faces), 3, 2), np.float32))

    if drop_degenerate:
        cr = np.cross(tri_v[:, 2] - tri_v[:, 0], tri_v[:, 1] - tri_v[:, 0])
        keep = np.einsum("ij,ij->i", cr, cr) > 0.0
        tri_v, tri_n, tri_uv, meta = (tri_v[keep], tri_n[keep], tri_uv[keep],
                                      meta[keep])

    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=device)
    return Triangle(vertices=f32(tri_v), normals=f32(tri_n),
                    tangents=f32(np.zeros_like(tri_v)), uv=f32(tri_uv),
                    metadata=torch.as_tensor(meta.astype(np.int64),
                                             device=device))


def build_triangle(v0, v1, v2, metadata=0, device=None) -> Triangle:
    """A batch of one triangle from three points, with its face normal at
    every vertex; ``device`` defaults to the CUDA card."""
    device = default_device(device)
    v = np.stack([np.asarray(v0, np.float32), np.asarray(v1, np.float32),
                  np.asarray(v2, np.float32)])[None]
    n = np.cross(v[0, 1] - v[0, 0], v[0, 2] - v[0, 0])
    ln = np.linalg.norm(n)
    n = n / ln if ln > 0 else n
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Triangle(vertices=f32(v), normals=f32(np.tile(n, (1, 3, 1))),
                    tangents=f32(np.zeros((1, 3, 3))),
                    uv=f32(np.zeros((1, 3, 2))),
                    metadata=torch.as_tensor(np.asarray(
                        [metadata], np.uint32).astype(np.int64),
                        device=device))


def is_degenerate_face(vertices, face) -> bool:
    """Whether a face of an indexed mesh has a zero cross product (host
    NumPy)."""
    v = np.asarray(vertices, np.float32)[np.asarray(face)]
    cr = np.cross(v[2] - v[0], v[1] - v[0])
    return bool(np.dot(cr, cr) <= 0.0)


def uv_sphere(center=(0, 0, 0), radius=1.0, n_theta=16, n_phi=32):
    """UV sphere -> (vertices, faces, normals) as NumPy arrays."""
    center = np.asarray(center, np.float32)
    thetas = np.linspace(0, np.pi, n_theta + 1)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(thetas, phis, indexing="ij")
    x = np.sin(T) * np.cos(P)
    y = np.sin(T) * np.sin(P)
    z = np.cos(T)
    pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    verts = center + radius * pts

    # Emission order: per cell upper then lower, row-major over (i, j);
    # face order defines the default metadata ids.
    I, J = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a = I * n_phi + J
    b = I * n_phi + (J + 1) % n_phi
    c = (I + 1) * n_phi + (J + 1) % n_phi
    d = (I + 1) * n_phi + J
    cell = np.stack([np.stack([a, b, c], -1),
                     np.stack([a, c, d], -1)], axis=2)   # (nt, np, 2, 3)
    valid = np.stack([I > 0, I < n_theta - 1], axis=2)   # (nt, np, 2)
    faces = cell.reshape(-1, 3)[valid.ravel()].astype(np.int64)
    # Orient faces so geometric normals point away from the center.
    tv = verts[faces]
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    outward = tv.mean(1) - center
    flip = np.einsum("ij,ij->i", n, outward) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces, pts


def sphere_mesh(center=(0, 0, 0), radius=1.0, n_theta=16, n_phi=32,
                metadata=None, device=None) -> Triangle:
    """A UV sphere with its unit per-vertex normals."""
    v, f, n = uv_sphere(center, radius, n_theta, n_phi)
    return build_triangles(v, f, normals=n, metadata=metadata, device=device)


def box_mesh(p_min=(-1, -1, -1), p_max=(1, 1, 1), metadata=None,
             device=None) -> Triangle:
    """An axis-aligned box, 12 triangles wound outward."""
    p0 = np.asarray(p_min, np.float32)
    p1 = np.asarray(p_max, np.float32)
    corners = np.array([[p1[0] if i & 1 else p0[0],
                         p1[1] if i & 2 else p0[1],
                         p1[2] if i & 4 else p0[2]] for i in range(8)],
                       np.float32)
    quads = [(0, 2, 3, 1), (4, 5, 7, 6),     # -z, +z
             (0, 1, 5, 4), (2, 6, 7, 3),     # -y, +y
             (0, 4, 6, 2), (1, 3, 7, 5)]     # -x, +x
    faces = [f for a, b, c, d in quads for f in ((a, b, c), (a, c, d))]
    return build_triangles(corners, np.asarray(faces, np.int64),
                           metadata=metadata, device=device)


def plane_mesh(center=(0, 0, 0), u=(1, 0, 0), v=(0, 1, 0), metadata=None,
               device=None) -> Triangle:
    """A 2-triangle quad: center +- u +- v."""
    c = np.asarray(center, np.float32)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    faces = np.asarray([(0, 1, 2), (0, 2, 3)], np.int64)
    return build_triangles(verts, faces, metadata=metadata, device=device)


def blobby_mesh(n_theta=354, n_phi=354, radius=1.0, amplitude=0.25,
                seed=0, octaves=8, metadata=None, device=None) -> Triangle:
    """A closed surface: a UV sphere displaced radially by multi-octave
    smooth noise, about 2*n_theta*n_phi triangles. Every ray through it
    crosses at least two surface layers and the silhouette mixes hits and
    misses."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    v, f, _ = uv_sphere((0.0, 0.0, 0.0), 1.0, n_theta, n_phi)
    p = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    disp = np.zeros(p.shape[0], np.float32)
    for i in range(octaves):
        k = rng.normal(size=3).astype(np.float32) * (1.3 ** i + 1.0)
        ph = np.float32(rng.uniform(0, 2 * np.pi))
        disp += np.sin(p @ k * np.pi + ph).astype(np.float32) / (1.25 ** i)
    disp *= amplitude / octaves * 2.0
    verts = (p * (radius * (1.0 + disp))[:, None]).astype(np.float32)
    return build_triangles(verts, f, metadata=metadata, device=device)


def displaced_grid_mesh(n=128, extent=2.0, amplitude=0.35, seed=0,
                        metadata=None, device=None) -> Triangle:
    """A bumpy heightfield grid with 2*n^2 triangles, spatially coherent
    like a scanned surface."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = np.zeros_like(X)
    # Sum of random smooth waves.
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
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)])
    return build_triangles(verts, faces, metadata=metadata, device=device)
