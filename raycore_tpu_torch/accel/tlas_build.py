"""The TLAS topology: an LBVH over instances (counterpart of
``raycore_tpu/accel/tlas_build.py``).

Each instance's world AABB is the box of its BLAS root's 8 corners under
its transform. The boxes' centres are Morton-coded in the real
instances' box (an extent clamped to ``DEGENERATE_EXTENT``), sorted
stably and built into the same Karras tree and refit as a BLAS. Leaves
hold the world AABB and the ORIGINAL instance index (instances are not
permuted). Padding instances (mask False) sit at PAD_COORD.
"""
from __future__ import annotations

import torch

from ..core.transforms import _apply_mat3_fused
from . import morton as _morton
from .lbvh import MAX_DEPTH, karras_topology, refit_aabbs
from .types import INVALID_NODE, PAD_COORD, Instances, f32_as_i32

DEGENERATE_EXTENT = 1e-6


def box_corners(lo, hi):
    """(..., 8, 3) corners of boxes (..., 3): corner i takes hi on axis a
    where bit a of i is set. The pattern is made on the boxes' device."""
    ar = lambda n: torch.arange(n, device=lo.device)
    bits = ((ar(8)[:, None] >> ar(3)) & 1).bool()
    return torch.where(bits, hi[..., None, :], lo[..., None, :])


def transformed_aabbs(transforms, lo, hi):
    """World (min, max) of boxes (I, 3) under row-major 3x4 transforms
    (I, 3, 4): the 8 corners through R as the fused chains of the JAX
    package's compiled programs (never a matrix product, which could
    round the corners), plus t."""
    wc = _apply_mat3_fused(transforms[:, None, :, :3], box_corners(lo, hi)) \
        + transforms[:, None, :, 3]
    return wc.amin(dim=1), wc.amax(dim=1)


def instance_world_aabbs(instances: Instances, blas_root_aabb):
    """World AABB per instance from its BLAS root box; padding instances
    land at PAD_COORD."""
    bi = instances.blas_index.long().clamp(0, blas_root_aabb.shape[0] - 1)
    root = blas_root_aabb[bi]                                  # (I, 2, 3)
    wmin, wmax = transformed_aabbs(instances.transform, root[:, 0],
                                   root[:, 1])
    pad = ~instances.mask[:, None]
    return (torch.where(pad, PAD_COORD, wmin),
            torch.where(pad, PAD_COORD, wmax))


def build_tlas_nodes(instances: Instances, blas_root_aabb):
    """The packed (2*icap-1, 16) int32 TLAS node matrix and the (2, 3)
    scene AABB over the real instances."""
    wmin, wmax = instance_world_aabbs(instances, blas_root_aabb)
    icap = wmin.shape[0]
    dev = wmin.device
    inf = torch.tensor(float("inf"), device=dev)
    m = instances.mask[:, None]
    scene_min = torch.where(m, wmin, inf).amin(0)
    scene_max = torch.where(m, wmax, -inf).amax(0)
    extent = torch.maximum(scene_max - scene_min,
                           torch.tensor(DEGENERATE_EXTENT, device=dev))
    centers = 0.5 * (wmin + wmax)
    codes = _morton.morton_code_30bit((centers - scene_min) / extent)
    perm = torch.sort(codes, stable=True).indices
    smin, smax = wmin[perm], wmax[perm]

    child0, child1, parent = karras_topology(codes[perm])
    node_min, node_max = refit_aabbs(child0, child1, smin, smax,
                                     n_passes=min(MAX_DEPTH, icap))
    c0, c1 = child0.long(), child1.long()
    col = lambda a: a.to(torch.int32)[:, None]
    zero = torch.zeros((icap - 1, 1), dtype=torch.int32, device=dev)
    internal = torch.cat([
        f32_as_i32(torch.cat([node_min[c0], node_max[c0], node_min[c1],
                              node_max[c1]], dim=1).contiguous()),
        col(child0), col(child1), col(parent[:icap - 1]), zero], dim=1)
    # Leaves: the world AABB in the aabb0 slots and the original instance
    # index in child1.
    leaves = torch.cat([
        f32_as_i32(torch.cat([smin, smax, torch.zeros((icap, 6), device=dev)],
                             dim=1).contiguous()),
        torch.full((icap, 1), INVALID_NODE, dtype=torch.int32, device=dev),
        col(perm), col(parent[icap - 1:]),
        torch.zeros((icap, 1), dtype=torch.int32, device=dev)], dim=1)
    return torch.cat([internal, leaves]), torch.stack([scene_min, scene_max])
