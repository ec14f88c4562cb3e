"""Ray types (counterpart of ``raycore_tpu/core/ray.py``).

Rays are structs of arrays: every field is a tensor whose leading
dimensions are an arbitrary batch shape, so one ``Ray`` holds one ray or a
whole wavefront. All float fields are float32.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .device import default_device

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
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            return x.expand(batch)

        return cls(o=o, d=d, t_min=as_scalar(t_min), t_max=as_scalar(t_max),
                   time=as_scalar(time))

    @property
    def batch_shape(self):
        return tuple(self.o.shape[:-1])
