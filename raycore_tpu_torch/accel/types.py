"""Acceleration-structure helpers (counterpart of
``raycore_tpu/accel/types.py``, partial: ``PAD_COORD``, the bit-level
helpers, ``next_pow2`` and ``pad_triangles``).

Capacities are padded to powers of two with far-away sentinel triangles
whose vertices sit at ``PAD_COORD``; they never intersect a real ray.
"""
from __future__ import annotations

import torch

from ..core.triangle import Triangle

PAD_COORD = 1.0e30


def i32_as_f32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret int32 bits as float32 (no value conversion)."""
    return x.view(torch.float32)


def f32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret float32 bits as int32 (no value conversion)."""
    return x.view(torch.int32)


def next_pow2(n: int) -> int:
    n = max(int(n), 2)
    return 1 << (n - 1).bit_length()


def pad_triangles(tris: Triangle, capacity: int) -> Triangle:
    """Pad a Triangle SoA to ``capacity`` rows with far-away sentinels."""
    n = tris.vertices.shape[0]
    if n == capacity:
        return tris
    pad = capacity - n

    def pad_leaf(a, fill):
        tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, tail])

    return Triangle(vertices=pad_leaf(tris.vertices, PAD_COORD),
                    normals=pad_leaf(tris.normals, 0),
                    tangents=pad_leaf(tris.tangents, 0),
                    uv=pad_leaf(tris.uv, 0),
                    metadata=pad_leaf(tris.metadata, 0))
