"""Triangles, the watertight and the Möller–Trumbore tests and the
triangle helpers (counterpart of ``raycore_tpu/core/triangle.py``).

The reference evaluates every cross product and 3-term dot product with
fused multiply-adds: its CPU compiler turns ``a1*b2 - a2*b1`` into
``fma(a1, b2, -(a2*b1))`` and a sum of three products into the chain
``fma(a2, b2, fma(a1, b1, a0*b0))``. ``cross`` and ``dot3`` below evaluate
the same chains with ``fma``, a fused multiply-add rounded once to
float32 as the reference's and the card's are, so the results match the
reference's bit for bit. The one-time build tables (accel/dense.py), the
brute-force oracle, the plain models of the sweep kernels and the helpers
below whose exact zeros matter (``is_degenerate``) use them; the
per-query code (ray features, the exact finalize) runs in plain float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .device import as_f32, default_device


@dataclasses.dataclass
class Triangle:
    """Struct-of-arrays triangle bundle. ``metadata`` holds uint32 payload
    values in an int64 tensor (the face index by default)."""

    vertices: torch.Tensor  # (..., 3, 3) float32 — 3 vertices x xyz
    normals: torch.Tensor   # (..., 3, 3) float32
    tangents: torch.Tensor  # (..., 3, 3) float32
    uv: torch.Tensor        # (..., 3, 2) float32
    metadata: torch.Tensor  # (...,) int64 holding uint32 values

    @classmethod
    def create(cls, vertices, normals=None, tangents=None, uv=None,
               metadata=None, device=None) -> "Triangle":
        """``device`` defaults to the device of ``vertices`` when it is a
        tensor, else to the CUDA card."""
        if device is None and isinstance(vertices, torch.Tensor):
            device = vertices.device
        device = default_device(device)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        vertices = f32(vertices)
        batch = tuple(vertices.shape[:-2])
        z = lambda shape: torch.zeros(batch + shape, dtype=torch.float32,
                                      device=device)
        meta = (torch.zeros(batch, dtype=torch.int64, device=device)
                if metadata is None else
                torch.as_tensor(metadata, device=device).to(torch.int64))
        return cls(vertices=vertices,
                   normals=z((3, 3)) if normals is None else f32(normals),
                   tangents=z((3, 3)) if tangents is None else f32(tangents),
                   uv=z((3, 2)) if uv is None else f32(uv),
                   metadata=meta)

    @property
    def batch_shape(self):
        return tuple(self.vertices.shape[:-2])

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def __len__(self):
        return self.vertices.shape[0]


def fma(a, b, c):
    """``a*b + c`` rounded once to float32, as the card's ``fmaf`` and
    XLA's fused multiply-add. The product of two float32 values is exact in
    float64; the sum is taken in float64 rounded to odd (rounded to
    nearest, then moved one ulp toward the exact sum where that leaves the
    last bit even), and a float64 rounded to odd rounds to float32 as the
    exact sum would. Rounding the float64 sum to nearest instead can round
    twice: the exact sum just past a float32 halfway point lands on it,
    then goes to even."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    # TwoSum: s + e == p + c exactly.
    pp = s - c
    e = (p - pp) + (c - (s - pp))
    nudge = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, math.inf), e)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def cross(a, b):
    """Cross product over the last axis, each component as
    ``fma(a_i, b_j, -(a_j*b_i))``."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma(a1, b2, -(a2 * b1)),
                        fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], dim=-1)


def dot3(a, b):
    """Dot product over a last axis of 3 as
    ``fma(a2, b2, fma(a1, b1, a0*b0))``."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return fma(a2, b2, fma(a1, b1, a0 * b0))


_EPS = 1e-5


def safe_invdir(d):
    """1/d with |d| clamped away from zero at 1e-5, preserving sign. The
    float32 clamp is made on d's device, so no upload waits for it."""
    eps = torch.full((), _EPS, dtype=torch.float32, device=d.device)
    clamped = torch.where(d.abs() > eps, d, torch.copysign(eps, d))
    return 1.0 / clamped


# Exact magnitude safe_invdir gives a clamped component; every genuine
# component (|d| > 1e-5) inverts to at most this value, so slab tests
# detect clamped axes with |inv_d| >= INV_DIR_CLAMP.
INV_DIR_CLAMP = float(np.float32(1.0) / np.float32(_EPS))


def fast_intersect_triangle(ray_o, ray_d, v0, v1, v2, t_min, closest_t):
    """Möller–Trumbore with no degenerate guard: ``1/det`` may be inf and
    the u/v/t range tests reject. Returns ``(hit, t, u, v)`` with zeros on
    a miss."""
    e1 = v1 - v0
    e2 = v2 - v0
    s1 = cross(ray_d, e2)
    det = dot3(s1, e1)
    invd = 1.0 / det
    dvec = ray_o - v0
    u = dot3(dvec, s1) * invd
    s2 = cross(dvec, e1)
    v = dot3(ray_d, s2) * invd
    t = dot3(e2, s2) * invd
    hit = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= t_min) & (t <= closest_t)
    z = torch.zeros_like(t)
    return (hit, torch.where(hit, t, z), torch.where(hit, u, z),
            torch.where(hit, v, z))


def empty_triangle(batch_shape=(), metadata=None, device=None) -> Triangle:
    """The zero-filled no-hit sentinel; ``device`` defaults to the device
    of ``metadata`` when it is a tensor, else to the CUDA card."""
    if device is None and isinstance(metadata, torch.Tensor):
        device = metadata.device
    device = default_device(device)
    shape = tuple(batch_shape)
    z = lambda tail: torch.zeros(shape + tail, dtype=torch.float32,
                                 device=device)
    meta = (torch.zeros(shape, dtype=torch.int64, device=device)
            if metadata is None else
            torch.as_tensor(metadata, device=device).to(torch.int64))
    return Triangle(vertices=z((3, 3)), normals=z((3, 3)),
                    tangents=z((3, 3)), uv=z((3, 2)), metadata=meta)


def _unit_or_zero(n):
    ln = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(ln > 0, ln, 1.0)


def area(t: Triangle):
    vs = t.vertices
    return 0.5 * torch.linalg.vector_norm(
        cross(vs[..., 1, :] - vs[..., 0, :], vs[..., 2, :] - vs[..., 0, :]),
        dim=-1)


def normal(t: Triangle):
    """The unit geometric normal (right-handed winding); zero for a
    degenerate triangle."""
    vs = t.vertices
    return _unit_or_zero(cross(vs[..., 1, :] - vs[..., 0, :],
                               vs[..., 2, :] - vs[..., 0, :]))


def is_degenerate(vertices):
    """The cross product of the edges is exactly zero (its squared length
    is at most 0)."""
    v = cross(vertices[..., 2, :] - vertices[..., 0, :],
              vertices[..., 1, :] - vertices[..., 0, :])
    return (v * v).sum(dim=-1) <= 0.0


def object_bound(t: Triangle):
    from .bounds import Bounds3
    return Bounds3(p_min=t.vertices.amin(dim=-2),
                   p_max=t.vertices.amax(dim=-2))


world_bound = object_bound


# --- the watertight test -----------------------------------------------------

def _to_ray_coordinate_space(vertices, ray_o, ray_d):
    """Permute the axes so that the largest |d| component is z (the
    first among equal ones), then shear so that d = (0, 0, 1). Returns
    the (..., 3 vertices, 3) sheared vertices and the shear."""
    from .bounds import first_argmax
    kz = first_argmax(ray_d.abs())
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    perm = torch.stack([kx, ky, kz], dim=-1)                  # (..., 3)
    d = torch.gather(ray_d, -1, perm)
    denom = 1.0 / d[..., 2]
    shear = torch.stack([-d[..., 0] * denom, -d[..., 1] * denom, denom], -1)
    vo = vertices - ray_o[..., None, :]                       # (..., 3, 3)
    batch = torch.broadcast_shapes(vo.shape[:-2], perm.shape[:-1])
    vo = vo.expand(batch + vo.shape[-2:])
    vo = torch.gather(vo, -1, perm[..., None, :].expand(batch + (3, 3)))
    sx = vo[..., 0] + shear[..., None, 0] * vo[..., 2]
    sy = vo[..., 1] + shear[..., None, 1] * vo[..., 2]
    return torch.stack([sx, sy, vo[..., 2]], dim=-1), shear


def _edge_function(tv):
    """The 2-D edge functions of the sheared triangle."""
    x, y = tv[..., 0], tv[..., 1]
    return torch.stack([x[..., 1] * y[..., 2] - y[..., 1] * x[..., 2],
                        x[..., 2] * y[..., 0] - y[..., 2] * x[..., 0],
                        x[..., 0] * y[..., 1] - y[..., 0] * x[..., 1]], -1)


def intersect_triangle(vertices, ray_o, ray_d, t_max):
    """The watertight ray-triangle test: ``(hit, t_hit, barycentric)``.
    A degenerate triangle, edge functions of mixed sign or all zero,
    det == 0 or a scaled t outside (0, t_max] is a miss; misses give
    zeros."""
    dev = vertices.device
    ray_o, ray_d = as_f32(ray_o, dev), as_f32(ray_d, dev)
    t_max = as_f32(t_max, dev)
    tv, shear = _to_ray_coordinate_space(vertices, ray_o, ray_d)
    edges = _edge_function(tv)
    all_zero = (edges == 0.0).all(dim=-1)
    mixed = (edges < 0.0).any(dim=-1) & (edges > 0.0).any(dim=-1)
    det = edges.sum(dim=-1)
    t_scaled = (edges * tv[..., 2] * shear[..., 2][..., None]).sum(dim=-1)
    neg_ok = (det < 0.0) & (t_scaled < 0.0) & (t_scaled >= t_max * det)
    pos_ok = (det > 0.0) & (t_scaled > 0.0) & (t_scaled <= t_max * det)
    hit = ~is_degenerate(vertices) & ~all_zero & ~mixed & (det != 0.0) \
        & (neg_ok | pos_ok)
    inv_det = 1.0 / torch.where(det != 0.0, det, 1.0)
    bary = torch.where(hit[..., None], edges * inv_det[..., None], 0.0)
    return hit, torch.where(hit, t_scaled * inv_det, 0.0), bary


def intersect(t: Triangle, ray):
    """The watertight test against a ``Ray``: (hit, t_hit, barycentric)."""
    return intersect_triangle(t.vertices, ray.o, ray.d, ray.t_max)


def intersect_p(t: Triangle, ray):
    return intersect(t, ray)[0]


# --- shading helpers ---------------------------------------------------------

def _coordinate_system(v1):
    """Two vectors orthogonal to v1 and to each other."""
    x, y, z = v1.unbind(-1)
    use_x = x.abs() > y.abs()
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, x * x + z * z,
                                         y * y + z * z))
    zero = torch.zeros_like(x)
    v2 = torch.where(use_x[..., None],
                     torch.stack([-z * inv_a, zero, x * inv_a], -1),
                     torch.stack([zero, z * inv_a, -y * inv_a], -1))
    return v2, cross(v1, v2)


def partial_derivatives(vertices, uv):
    """(dp/du, dp/dv, p0 - p2, p1 - p2) from the vertex and uv
    differences; where the uv's determinant is zero, an orthonormal frame
    around the normal instead."""
    duv13 = uv[..., 0, :] - uv[..., 2, :]
    duv23 = uv[..., 1, :] - uv[..., 2, :]
    dp13 = vertices[..., 0, :] - vertices[..., 2, :]
    dp23 = vertices[..., 1, :] - vertices[..., 2, :]
    det = duv13[..., 0] * duv23[..., 1] - duv13[..., 1] * duv23[..., 0]
    ok = det != 0.0
    inv_det = (1.0 / torch.where(ok, det, 1.0))[..., None]
    dpdu = (duv23[..., 1:2] * dp13 - duv13[..., 1:2] * dp23) * inv_det
    dpdv = (-duv23[..., 0:1] * dp13 + duv13[..., 0:1] * dp23) * inv_det
    n = _unit_or_zero(cross(vertices[..., 2, :] - vertices[..., 0, :],
                            vertices[..., 1, :] - vertices[..., 0, :]))
    fb_u, fb_v = _coordinate_system(n)
    return (torch.where(ok[..., None], dpdu, fb_u),
            torch.where(ok[..., None], dpdv, fb_v), dp13, dp23)


def normal_derivatives(t: Triangle):
    """(dn/du, dn/dv); zero where the uv's determinant is zero or every
    normal is a NaN placeholder."""
    uv, ns = t.uv, t.normals
    duv13 = uv[..., 0, :] - uv[..., 2, :]
    duv23 = uv[..., 1, :] - uv[..., 2, :]
    dn13 = ns[..., 0, :] - ns[..., 2, :]
    dn23 = ns[..., 1, :] - ns[..., 2, :]
    det = duv13[..., 0] * duv23[..., 1] - duv13[..., 1] * duv23[..., 0]
    ok = (det != 0.0) & ~torch.isnan(ns).all(dim=-1).all(dim=-1)
    inv_det = (1.0 / torch.where(ok, det, 1.0))[..., None]
    dndu = (duv23[..., 1:2] * dn13 - duv13[..., 1:2] * dn23) * inv_det
    dndv = (-duv23[..., 0:1] * dn13 + duv13[..., 0:1] * dn23) * inv_det
    return (torch.where(ok[..., None], dndu, 0.0),
            torch.where(ok[..., None], dndv, 0.0))


def bary_interp(bary, vals):
    """sum_k bary[..., k] * vals[..., k, :], an elementwise multiply and
    sum in float32 (a matrix product on the card could take TF32)."""
    return (bary[..., None] * vals).sum(dim=-2)
