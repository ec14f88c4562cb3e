"""Acceleration-structure types (counterpart of
``raycore_tpu/accel/types.py``).

Nodes are rows of a packed ``(N, 16)`` int32 matrix, float fields carried
as their bits (``f32_as_i32``), so one traversal step costs one row
gather and the sentinel -1 (a NaN pattern as float32) keeps its bits:

    cols 0:3   aabb0_min   | leaf: v0  (BLAS leaves hold their vertices)
    cols 3:6   aabb0_max   | leaf: v1
    cols 6:9   aabb1_min   | leaf: v2
    cols 9:12  aabb1_max   | leaf: unused
    col  12    child0      (INVALID_NODE marks a leaf)
    col  13    child1      (leaf: sorted prim index (BLAS) / original
                            instance index (TLAS))
    col  14    parent      (root: INVALID_NODE)
    col  15    padding

For capacity n, internal nodes are rows [0, n-2] (the root is row 0) and
leaves rows [n-1, 2n-2]. Indices are 0-based int32; ``INVALID_NODE`` is -1
and ``TOP_LEVEL_SENTINEL`` -2. Capacities are padded to powers of two with
far-away sentinel triangles whose vertices sit at ``PAD_COORD``; they
never intersect a real ray.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.triangle import Triangle

INVALID_NODE = -1
TOP_LEVEL_SENTINEL = -2
PAD_COORD = 1.0e30
NODE_COLS = 16


def i32_as_f32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret int32 bits as float32 (no value conversion)."""
    return x.view(torch.float32)


def f32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret float32 bits as int32 (no value conversion)."""
    return x.view(torch.int32)


# The smallest normal float32; smaller magnitudes are denormal.
FLT_MIN = 2.0 ** -126


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each denormal float32 replaced by a zero of its sign, as
    XLA's float32 arithmetic on the CPU and the TPU flushes its results
    (ROADMAP T9); the reference's min/max reductions of bounds do too."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


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


@dataclasses.dataclass
class BLAS:
    """Bottom-level acceleration structure over one mesh. ``prims`` are in
    Morton order (a leaf's child1 indexes them); rows past ``n_prims``
    hold sentinel triangles."""

    nodes: torch.Tensor       # (2*capacity-1, 16) int32
    prims: Triangle           # (capacity, ...) sorted
    root_aabb: torch.Tensor   # (2, 3) float32 over the real prims
    n_prims: int
    capacity: int

    @property
    def n_nodes(self) -> int:
        return 2 * self.capacity - 1


@dataclasses.dataclass
class Instances:
    """Per-instance descriptors: a row-major 3x4 transform and its affine
    inverse, the BLAS index, and the ``instance_id`` override (0 inherits
    from the triangle metadata, any other value is forwarded; uint32
    values in int64)."""

    transform: torch.Tensor      # (I, 3, 4) float32
    inv_transform: torch.Tensor  # (I, 3, 4) float32
    blas_index: torch.Tensor     # (I,) int32
    instance_id: torch.Tensor    # (I,) int64 holding uint32
    mask: torch.Tensor           # (I,) bool, False on capacity padding


@dataclasses.dataclass
class StaticTLAS:
    """A frozen scene for the traversal: the TLAS node rows followed by
    every BLAS's node rows in ``unified_nodes`` (``blas_nodes_offset``
    holds absolute base rows), and every BLAS's prims concatenated."""

    unified_nodes: torch.Tensor      # (2*icap-1 + sum nodes, 16) int32
    instances: Instances             # (icap, ...)
    prims: Triangle                  # (sum capacities, ...)
    blas_nodes_offset: torch.Tensor  # (B,) int32
    blas_prims_offset: torch.Tensor  # (B,) int32
    blas_root_aabb: torch.Tensor     # (B, 2, 3) float32
    root_aabb: torch.Tensor          # (2, 3) float32 over real instances
    n_instances: int
    instance_capacity: int
    n_blas: int

    @property
    def n_tlas_nodes(self) -> int:
        return 2 * self.instance_capacity - 1
