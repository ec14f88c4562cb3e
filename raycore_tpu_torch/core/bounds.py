"""Axis-aligned bounding boxes, 2-D and 3-D (counterpart of
``raycore_tpu/core/bounds.py``).

A ``Bounds3`` holds ``p_min``/``p_max`` tensors with any leading batch
dimensions; every function works elementwise over them and keeps their
device. The empty box (``p_min = +inf``, ``p_max = -inf``) is the
identity of ``union``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .device import as_f32, default_device
from .triangle import INV_DIR_CLAMP

INF = math.inf


@dataclasses.dataclass
class Bounds3:
    p_min: torch.Tensor  # (..., 3) float32
    p_max: torch.Tensor  # (..., 3) float32

    @classmethod
    def empty(cls, batch_shape=(), device=None) -> "Bounds3":
        """The empty box; ``device`` defaults to the CUDA card."""
        device = default_device(device)
        shape = tuple(batch_shape) + (3,)
        return cls(p_min=torch.full(shape, INF, device=device),
                   p_max=torch.full(shape, -INF, device=device))

    @classmethod
    def from_point(cls, p, device=None) -> "Bounds3":
        """The box of one point (``device`` as in ``as_f32``)."""
        p = as_f32(p, device)
        return cls(p_min=p, p_max=p)

    @classmethod
    def from_points(cls, a, b, device=None) -> "Bounds3":
        """The box spanned by two points (``device`` as in ``as_f32``)."""
        a, b = as_f32(a, device), as_f32(b, device)
        return cls(p_min=torch.minimum(a, b), p_max=torch.maximum(a, b))

    @property
    def batch_shape(self):
        return tuple(self.p_min.shape[:-1])


@dataclasses.dataclass
class Bounds2:
    p_min: torch.Tensor  # (..., 2)
    p_max: torch.Tensor  # (..., 2)

    @classmethod
    def empty(cls, batch_shape=(), device=None) -> "Bounds2":
        """The empty box; ``device`` defaults to the CUDA card."""
        device = default_device(device)
        shape = tuple(batch_shape) + (2,)
        return cls(p_min=torch.full(shape, INF, device=device),
                   p_max=torch.full(shape, -INF, device=device))

    @classmethod
    def from_points(cls, a, b, device=None) -> "Bounds2":
        """The box spanned by two points (``device`` as in ``as_f32``)."""
        a, b = as_f32(a, device), as_f32(b, device)
        return cls(p_min=torch.minimum(a, b), p_max=torch.maximum(a, b))


# --- operations on Bounds2 and Bounds3 ---------------------------------------

def union(a, b):
    """Union of two boxes, or of a box and a point tensor."""
    if isinstance(b, (Bounds2, Bounds3)):
        return type(a)(p_min=torch.minimum(a.p_min, b.p_min),
                       p_max=torch.maximum(a.p_max, b.p_max))
    b = as_f32(b, a.p_min.device)
    return type(a)(p_min=torch.minimum(a.p_min, b),
                   p_max=torch.maximum(a.p_max, b))


def intersect_bounds(a, b):
    return type(a)(p_min=torch.maximum(a.p_min, b.p_min),
                   p_max=torch.minimum(a.p_max, b.p_max))


def overlaps(a, b):
    """The boxes overlap on every axis (closed intervals)."""
    return ((a.p_max >= b.p_min) & (a.p_min <= b.p_max)).all(dim=-1)


def inside(b, p):
    p = as_f32(p, b.p_min.device)
    return ((p >= b.p_min) & (p <= b.p_max)).all(dim=-1)


def inside_exclusive(b, p):
    p = as_f32(p, b.p_min.device)
    return ((p >= b.p_min) & (p < b.p_max)).all(dim=-1)


def expand(b, delta):
    delta = as_f32(delta, b.p_min.device)
    return type(b)(p_min=b.p_min - delta, p_max=b.p_max + delta)


def diagonal(b):
    return b.p_max - b.p_min


def surface_area(b: Bounds3):
    d = diagonal(b)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


def area(b: Bounds2):
    d = diagonal(b)
    return d[..., 0] * d[..., 1]


def volume(b: Bounds3):
    d = diagonal(b)
    return d[..., 0] * d[..., 1] * d[..., 2]


def first_argmax(x):
    """Index of the largest value over the last axis, the first among
    equal ones (``torch.argmax`` does not promise the first on every
    device)."""
    axes = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == x.amax(dim=-1, keepdim=True), axes,
                       x.shape[-1]).amin(dim=-1)


def maximum_extent(b):
    """Index of the longest axis, the first among equal ones."""
    return first_argmax(diagonal(b))


def _corner_bits(c):
    return torch.stack([(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1], dim=-1)


def corner(b: Bounds3, c):
    """The c-th corner, c in [0, 8): bit i of c picks p_max on axis i."""
    c = torch.as_tensor(c, dtype=torch.int32, device=b.p_min.device)
    return torch.where(_corner_bits(c) == 1, b.p_max, b.p_min)


def corners(b: Bounds3):
    """All 8 corners, shape (..., 8, 3)."""
    bits = _corner_bits(torch.arange(8, dtype=torch.int32,
                                     device=b.p_min.device))
    return torch.where(bits == 1, b.p_max[..., None, :],
                       b.p_min[..., None, :])


def lerp(b, t):
    t = as_f32(t, b.p_min.device)
    return b.p_min + t * (b.p_max - b.p_min)


def offset(b, p):
    """Coordinates of p within the box, in [0, 1] on each axis (no
    division on a degenerate axis)."""
    p = as_f32(p, b.p_min.device)
    d = b.p_max - b.p_min
    o = p - b.p_min
    return torch.where(d > 0, o / torch.where(d > 0, d, 1.0), o)


def bounding_sphere(b: Bounds3):
    """(center, radius); radius 0 when the box does not contain its own
    center (an empty or invalid box)."""
    center = (b.p_min + b.p_max) * 0.5
    radius = torch.where(inside(b, center),
                         torch.linalg.vector_norm(b.p_max - center, dim=-1),
                         0.0)
    return center, radius


def is_valid(b):
    return (b.p_min <= b.p_max).all(dim=-1)


# --- ray against box ---------------------------------------------------------

def intersect_ray(b: Bounds3, ray_o, ray_d, t_max):
    """Slab test: ``(hit, t0, t1)`` with the interval clipped to
    ``[0, t_max]``. A zero direction component divides to +-inf, which
    the min/max handle."""
    dev = b.p_min.device
    ray_o, ray_d = as_f32(ray_o, dev), as_f32(ray_d, dev)
    inv_d = 1.0 / ray_d
    t_near = (b.p_min - ray_o) * inv_d
    t_far = (b.p_max - ray_o) * inv_d
    lo = torch.minimum(t_near, t_far)
    hi = torch.maximum(t_near, t_far)
    t0 = torch.maximum(lo.amax(dim=-1), torch.zeros((), device=lo.device))
    t1 = torch.minimum(hi.amin(dim=-1), as_f32(t_max, dev))
    hit = t0 <= t1
    return hit, torch.where(hit, t0, 0.0), torch.where(hit, t1, 0.0)


def intersect_p(b: Bounds3, ray_o, t_max, inv_dir, dir_is_negative=None):
    """The slab predicate with a precomputed inverse direction."""
    dev = b.p_min.device
    ray_o, inv_dir = as_f32(ray_o, dev), as_f32(inv_dir, dev)
    neg = inv_dir < 0 if dir_is_negative is None else dir_is_negative
    near = torch.where(neg, b.p_max, b.p_min)
    far = torch.where(neg, b.p_min, b.p_max)
    t0 = ((near - ray_o) * inv_dir).amax(dim=-1)
    t1 = ((far - ray_o) * inv_dir).amin(dim=-1)
    return (t0 <= t1) & (t0 < as_f32(t_max, dev)) & (t1 > 0.0)


def fast_intersect_bbox(ray_o, ray_inv_d, p_min, p_max, t_min, t_max):
    """The slab test of the BVH traversal on raw tensors: ``(entry_t,
    exit_t)``, a hit where entry <= exit. An axis whose inverse direction
    was clamped by ``safe_invdir`` (|inv_d| >= INV_DIR_CLAMP) and whose
    origin lies inside the slab never leaves it, so that axis spans all
    t; with the origin outside, the clamped interval is kept, as it
    underestimates the true entry."""
    oxinv = -ray_o * ray_inv_d
    f = p_max * ray_inv_d + oxinv
    n = p_min * ray_inv_d + oxinv
    hi = torch.maximum(f, n)
    lo = torch.minimum(f, n)
    par = ray_inv_d.abs() >= INV_DIR_CLAMP
    all_t = par & (ray_o >= p_min) & (ray_o <= p_max)
    lo = torch.where(all_t, -INF, lo)
    hi = torch.where(all_t, INF, hi)
    max_t = torch.minimum(hi.amin(dim=-1), as_f32(t_max, hi.device))
    min_t = torch.maximum(lo.amax(dim=-1), as_f32(t_min, lo.device))
    return min_t, max_t
