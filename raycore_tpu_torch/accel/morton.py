"""Morton (Z-order) codes and ``clz32`` (counterpart of
``raycore_tpu/accel/morton.py``).

Codes are 30-bit values held in int64: every mask below keeps only bits of
the low 32, so the results equal the reference's wrapping uint32 math.
"""
from __future__ import annotations

import torch


def expand_bits(x: torch.Tensor) -> torch.Tensor:
    """3-dilate the low 10 bits of x."""
    x = x.to(torch.int64)
    x = (x * 0x00010001) & 0xFF0000FF
    x = (x * 0x00000101) & 0x0F00F00F
    x = (x * 0x00000011) & 0xC30C30C3
    x = (x * 0x00000005) & 0x49249249
    return x


def morton_code_30bit(p: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of a point normalized to [0,1]^3 on a 1024^3 grid
    with clamping. Bit order: x takes the top bit of each triad."""
    q = (p.to(torch.float32) * 1024.0).clamp(0.0, 1023.0).to(torch.int64)
    return (expand_bits(q[..., 0]) << 2) | (expand_bits(q[..., 1]) << 1) \
        | expand_bits(q[..., 2])


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each value read as a uint32 (int32 bit patterns
    and non-negative int64 below 2^32 alike); 32 for 0. torch has no
    count-leading-zeros, so the bit length comes from the exponent of an
    exact float64 (``frexp``: x = m * 2^e with m in [0.5, 1), so e is the
    bit length of x > 0)."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    _, e = torch.frexp(u.to(torch.float64))
    return torch.where(u == 0, 32, 32 - e).to(torch.int32)
