"""Ray types and helpers (counterpart of ``raycore_tpu/core/ray.py``).

Rays are structs of arrays: every field is a tensor whose leading
dimensions are an arbitrary batch shape, so one ``Ray`` holds one ray or a
whole wavefront. All float fields are float32.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .device import as_f32, default_device

INF = math.inf


@dataclasses.dataclass
class Ray:
    """A ray ``o + t*d`` active on ``t in [t_min, t_max]``."""

    o: torch.Tensor      # (..., 3) float32
    d: torch.Tensor      # (..., 3) float32
    t_min: torch.Tensor  # (...,) float32
    t_max: torch.Tensor  # (...,) float32
    time: torch.Tensor   # (...,) float32

    @classmethod
    def create(cls, o, d, t_min=0.0, t_max=INF, time=0.0,
               device=None) -> "Ray":
        """Broadcast origins, directions and the scalar fields to one batch
        shape. ``device`` defaults to the device of ``o`` when it is a
        tensor, else to the CUDA card."""
        if device is None and isinstance(o, torch.Tensor):
            device = o.device
        device = default_device(device)
        o = torch.as_tensor(o, dtype=torch.float32, device=device)
        d = torch.as_tensor(d, dtype=torch.float32, device=device)
        batch = torch.broadcast_shapes(o.shape[:-1], d.shape[:-1])
        o = o.expand(batch + (3,))
        d = d.expand(batch + (3,))

        def as_scalar(x):
            if isinstance(x, (int, float)):
                # Filled on the device: uploading a number from the host
                # would wait there for the work already queued.
                x = torch.full((), x, dtype=torch.float32, device=device)
            else:
                x = torch.as_tensor(x, dtype=torch.float32, device=device)
            return x.expand(batch)

        return cls(o=o, d=d, t_min=as_scalar(t_min), t_max=as_scalar(t_max),
                   time=as_scalar(time))

    @property
    def batch_shape(self):
        return tuple(self.o.shape[:-1])


@dataclasses.dataclass
class RayDifferentials:
    """A ray plus the screen-space differential rays of its neighbours
    in x and y. ``has_differentials`` is a bool tensor."""

    o: torch.Tensor
    d: torch.Tensor
    t_max: torch.Tensor
    time: torch.Tensor
    has_differentials: torch.Tensor  # (...,) bool
    rx_origin: torch.Tensor
    ry_origin: torch.Tensor
    rx_direction: torch.Tensor
    ry_direction: torch.Tensor

    @classmethod
    def create(cls, o, d, t_max=INF, time=0.0, has_differentials=False,
               rx_origin=None, ry_origin=None, rx_direction=None,
               ry_direction=None, device=None) -> "RayDifferentials":
        """Broadcast every field to one batch shape; missing differentials
        are zeros. ``device`` defaults to the device of ``o`` when it is a
        tensor, else to the CUDA card."""
        if device is None and isinstance(o, torch.Tensor):
            device = o.device
        device = default_device(device)
        o, d = as_f32(o, device), as_f32(d, device)
        batch = torch.broadcast_shapes(o.shape[:-1], d.shape[:-1])
        vec = lambda x: (torch.zeros(batch + (3,), device=device)
                         if x is None else as_f32(x, device).expand(
                             batch + (3,)))
        return cls(o=o.expand(batch + (3,)), d=d.expand(batch + (3,)),
                   t_max=as_f32(t_max, device).expand(batch),
                   time=as_f32(time, device).expand(batch),
                   has_differentials=torch.as_tensor(
                       has_differentials, dtype=torch.bool,
                       device=device).expand(batch),
                   rx_origin=vec(rx_origin), ry_origin=vec(ry_origin),
                   rx_direction=vec(rx_direction),
                   ry_direction=vec(ry_direction))

    @classmethod
    def from_ray(cls, r: Ray) -> "RayDifferentials":
        return cls.create(r.o, r.d, t_max=r.t_max, time=r.time)

    def as_ray(self) -> Ray:
        return Ray.create(self.o, self.d, t_max=self.t_max, time=self.time)


def set_direction(r, d):
    """``r`` with direction ``d``, its -0.0 components turned into +0.0."""
    d = as_f32(d, r.o.device)
    return dataclasses.replace(r, d=torch.where(d == 0.0, 0.0, d))


def check_direction(r):
    return set_direction(r, r.d)


def apply(r, t):
    """The point at parameter t: o + d*t."""
    return r.o + r.d * as_f32(t, r.o.device)[..., None]


def increase_hit(r, t_hit):
    """``r`` with t_max shrunk to a found hit."""
    return dataclasses.replace(r, t_max=as_f32(t_hit, r.o.device))


def scale_differentials(rd: RayDifferentials, s):
    """Move the differential rays toward (s < 1) or away from the main
    ray by the factor s."""
    s = as_f32(s, rd.o.device)[..., None]
    return dataclasses.replace(
        rd,
        rx_origin=rd.o + (rd.rx_origin - rd.o) * s,
        ry_origin=rd.o + (rd.ry_origin - rd.o) * s,
        rx_direction=rd.d + (rd.rx_direction - rd.d) * s,
        ry_direction=rd.d + (rd.ry_direction - rd.d) * s)
