"""Triangles and the Möller–Trumbore test (counterpart of
``raycore_tpu/core/triangle.py``, partial: ``Triangle``, ``safe_invdir``,
``INV_DIR_CLAMP`` and ``fast_intersect_triangle``).

The reference evaluates every cross product and 3-term dot product with
fused multiply-adds: its CPU compiler turns ``a1*b2 - a2*b1`` into
``fma(a1, b2, -(a2*b1))`` and a sum of three products into the chain
``fma(a2, b2, fma(a1, b1, a0*b0))``. ``cross`` and ``dot3`` below evaluate
the same chains with ``fma``, a fused multiply-add rounded once to
float32 as the reference's and the card's are, so the results match the
reference's bit for bit. The one-time build tables (accel/dense.py), the
brute-force oracle and the plain models of the sweep kernels use them; the
per-query code (ray features, the exact finalize) runs in plain float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .device import default_device


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
    """1/d with |d| clamped away from zero at 1e-5, preserving sign."""
    eps = torch.tensor(_EPS, dtype=torch.float32, device=d.device)
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
