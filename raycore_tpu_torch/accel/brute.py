"""Brute-force closest hit, the oracle (counterpart of
``raycore_tpu/accel/brute.py``: ``HitResult``, ``closest_hit_brute`` and
``any_hit_brute``).

Every ray is tested against every triangle with ``fast_intersect_triangle``;
the smallest t wins and ties go to the lowest triangle index. Triangles
are swept in chunks so that a few thousand rays against a million
triangles fit in device memory.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import triangle as _tri
from ..core.ray import Ray


@dataclasses.dataclass
class HitResult:
    """Batched hit record. ``prim_idx``/``instance_idx`` are 0-based and
    -1 on a miss; the triangle is the zero sentinel on a miss."""

    hit: torch.Tensor            # (...,) bool
    triangle: _tri.Triangle      # (...,) SoA
    t: torch.Tensor              # (...,) float32, 0 on a miss
    barycentric: torch.Tensor    # (..., 3) float32 (w, u, v), 0 on a miss
    prim_idx: torch.Tensor       # (...,) int32
    instance_idx: torch.Tensor   # (...,) int32

    def map(self, fn) -> "HitResult":
        """Apply ``fn`` to every tensor leaf (e.g. a reshape)."""
        tri = self.triangle
        return HitResult(
            hit=fn(self.hit),
            triangle=_tri.Triangle(vertices=fn(tri.vertices),
                                   normals=fn(tri.normals),
                                   tangents=fn(tri.tangents), uv=fn(tri.uv),
                                   metadata=fn(tri.metadata)),
            t=fn(self.t), barycentric=fn(self.barycentric),
            prim_idx=fn(self.prim_idx), instance_idx=fn(self.instance_idx))


def _masked_rows(tris: _tri.Triangle, idx, hit) -> _tri.Triangle:
    """Rows ``idx`` of a Triangle SoA, zeroed where ``hit`` is False."""
    m = hit[:, None, None]
    return _tri.Triangle(
        vertices=torch.where(m, tris.vertices[idx], 0.0),
        normals=torch.where(m, tris.normals[idx], 0.0),
        tangents=torch.where(m, tris.tangents[idx], 0.0),
        uv=torch.where(m, tris.uv[idx], 0.0),
        metadata=torch.where(hit, tris.metadata[idx], 0))


def closest_over(o, d, t_min, t_max, v, tri_chunk: int = 8192):
    """Each ray's closest hit among triangles ``v`` (T, 3, 3) by exhaustive
    ``fast_intersect_triangle``, ``tri_chunk`` triangles at a time: the
    smallest t wins and the lowest index among equal t. ``o``/``d`` (R, 3),
    ``t_min``/``t_max`` (R,). Returns (hit, t, u, v, idx) of shape (R,)
    with idx int64, each undefined where hit is False."""
    o, d = o.reshape(-1, 1, 3), d.reshape(-1, 1, 3)
    t_min, t_max = t_min.reshape(-1, 1), t_max.reshape(-1, 1)
    R = o.shape[0]
    dev = o.device
    inf = torch.tensor(float("inf"), device=dev)
    best_t = torch.full((R,), float("inf"), device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    best_i = torch.zeros(R, dtype=torch.int64, device=dev)
    any_h = torch.zeros(R, dtype=torch.bool, device=dev)
    for lo in range(0, v.shape[0], tri_chunk):
        vc = v[lo:lo + tri_chunk]
        hit, t, u, vv = _tri.fast_intersect_triangle(
            o, d, vc[:, 0], vc[:, 1], vc[:, 2], t_min, t_max)
        t_for_min = torch.where(hit, t, inf)
        tmin = t_for_min.amin(dim=1)
        # Lowest index among the minima: an explicit min over indices,
        # since argmin does not promise the first index on every device.
        cols = torch.arange(vc.shape[0], device=dev)
        arg = torch.where(t_for_min == tmin[:, None], cols,
                          vc.shape[0]).amin(dim=1)
        take = lambda a: a.gather(1, arg[:, None])[:, 0]
        h = take(hit)
        # Strict < keeps the earlier chunk on equal t.
        better = h & (~any_h | (take(t) < best_t))
        best_t = torch.where(better, take(t), best_t)
        best_u = torch.where(better, take(u), best_u)
        best_v = torch.where(better, take(vv), best_v)
        best_i = torch.where(better, arg + lo, best_i)
        any_h = any_h | h
    return any_h, best_t, best_u, best_v, best_i


def closest_hit_brute(tris: _tri.Triangle, rays: Ray,
                      tri_chunk: int = 8192) -> HitResult:
    """Closest hit by exhaustive Möller–Trumbore, ``tri_chunk`` triangles at
    a time. Ties resolve to the lowest triangle index, as in the
    reference's first-wins argmin."""
    batch = rays.batch_shape
    any_h, best_t, best_u, best_v, best_i = closest_over(
        rays.o, rays.d, rays.t_min, rays.t_max, tris.vertices, tri_chunk)
    bary = torch.where(any_h[:, None],
                       torch.stack([1.0 - best_u - best_v, best_u, best_v],
                                   -1), 0.0)
    idx = torch.where(any_h, best_i, -1).to(torch.int32)
    res = HitResult(hit=any_h, triangle=_masked_rows(tris, best_i, any_h),
                    t=torch.where(any_h, best_t, 0.0), barycentric=bary,
                    prim_idx=idx,
                    instance_idx=torch.where(any_h, 0, -1).to(torch.int32))
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))


def any_hit_brute(tris: _tri.Triangle, rays: Ray) -> HitResult:
    """Occlusion by exhaustive Möller–Trumbore: ``closest_hit_brute`` with
    t_min forced to 0, as any_hit does. It reports the lowest-index among
    the closest hits; only the hit mask is the occlusion contract."""
    rays0 = dataclasses.replace(rays, t_min=torch.zeros_like(rays.t_min))
    return closest_hit_brute(tris, rays0)
