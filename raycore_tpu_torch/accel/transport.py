"""Batched ray and hit transport records (counterpart of
``raycore_tpu/accel/transport.py``): fixed-width structs of arrays in the
field layout of the reference's 32-byte ``RTRay`` and ``RTHitResult``,
the second query API of the AbstractAccel contract.

``trace_closest_hits`` and ``trace_any_hits`` query a ``StaticTLAS``
through the BVH traversal (``accel/traversal.py``), as the reference
does. ``instance_custom_index`` is uint32 in the reference; here its
values are held in int64, as ``Instances.instance_id`` and the triangle
metadata hold theirs.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.ray import Ray
from .brute import HitResult


@dataclasses.dataclass
class RTRay:
    """origin + t_min, direction + t_max (reference RTRay, 32 bytes a
    row)."""

    origin: torch.Tensor     # (N, 3) float32
    t_min: torch.Tensor      # (N,) float32
    direction: torch.Tensor  # (N, 3) float32
    t_max: torch.Tensor      # (N,) float32

    @classmethod
    def from_rays(cls, rays: Ray) -> "RTRay":
        nb = len(rays.batch_shape)
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[nb:]))
        return cls(origin=flat(rays.o), t_min=flat(rays.t_min),
                   direction=flat(rays.d), t_max=flat(rays.t_max))

    def to_rays(self) -> Ray:
        return Ray.create(self.origin, self.direction, t_min=self.t_min,
                          t_max=self.t_max)

    def pack(self) -> torch.Tensor:
        """(N, 8) float32 rows in the reference's byte layout:
        [ox oy oz tmin dx dy dz tmax]."""
        return torch.cat([self.origin, self.t_min[:, None], self.direction,
                          self.t_max[:, None]], dim=1)


@dataclasses.dataclass
class RTHitResult:
    """hit flag, t, primitive id, instance custom index, barycentric u and
    v, instance id (reference RTHitResult, 32 bytes a row)."""

    hit: torch.Tensor                    # (N,) bool
    t: torch.Tensor                      # (N,) float32
    primitive_id: torch.Tensor           # (N,) int32
    instance_custom_index: torch.Tensor  # (N,) int64 holding uint32
    bary_u: torch.Tensor                 # (N,) float32
    bary_v: torch.Tensor                 # (N,) float32
    instance_id: torch.Tensor            # (N,) int32, 0-based, -1 on a miss

    @classmethod
    def from_hit_result(cls, res: HitResult, instances=None) -> "RTHitResult":
        """Flatten a HitResult. The custom index is the hit instance's
        ``instance_id`` where that is nonzero, else the triangle's
        metadata (an instance_id of 0 inherits), and 0 on a miss."""
        nb = res.hit.dim()
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[nb:]))
        hit = flat(res.hit)
        bary = flat(res.barycentric)
        inst = flat(res.instance_idx)
        custom = flat(res.triangle.metadata).to(torch.int64) & 0xFFFFFFFF
        if instances is not None:
            override = instances.instance_id[inst.clamp_min(0).long()]
            custom = torch.where(override != 0, override, custom)
        return cls(hit=hit, t=flat(res.t), primitive_id=flat(res.prim_idx),
                   instance_custom_index=torch.where(hit, custom, 0),
                   bary_u=bary[:, 1], bary_v=bary[:, 2], instance_id=inst)


def trace_closest_hits(scene, rt_rays: RTRay, **kw) -> RTHitResult:
    """Closest hits of a batch in transport form on a ``StaticTLAS``;
    ``kw`` goes to ``traversal.closest_hit``."""
    from . import traversal
    res = traversal.closest_hit(scene, rt_rays.to_rays(), **kw)
    return RTHitResult.from_hit_result(res, scene.instances)


def trace_any_hits(scene, rt_rays: RTRay, **kw) -> RTHitResult:
    """Occlusion of a batch in transport form on a ``StaticTLAS``."""
    from . import traversal
    res = traversal.any_hit(scene, rt_rays.to_rays(), **kw)
    return RTHitResult.from_hit_result(res, scene.instances)
