"""Broad-phase instance collision detection over the TLAS tree
(counterpart of ``raycore_tpu/analysis/collision.py``).

One lane per TLAS leaf walks the TLAS with a stack, testing AABB overlap;
a pair is kept once (``instance_b > instance_a``) when both instances are
real. Exact two passes: count per lane, exclusive cumsum, then write
each lane's pairs at its offset. Contact indices are 0-based original
instance indices. The walk is a Python loop of tensor steps that asks
once a step whether any lane is still walking.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.tlas_build import instance_world_aabbs
from ..accel.types import INVALID_NODE, StaticTLAS, i32_as_f32


@dataclasses.dataclass
class CollisionResult:
    """contacts (M, 2) int32 with M the exact total, and that total."""
    contacts: torch.Tensor
    num_contacts: int


def _tlas_leaf_blocks(scene: StaticTLAS):
    icap = scene.instance_capacity
    return scene.unified_nodes[: 2 * icap - 1], icap


def _collide_pass(nodes, icap, mask, offsets, max_contacts: int,
                  stack_size: int = 32):
    """One lane per TLAS leaf, walking the TLAS. With max_contacts == 0
    the counting pass: (counts, None); otherwise the pairs are written at
    offsets[lane] + local count: (counts, contacts)."""
    dev = nodes.device
    leafi = nodes[icap - 1: 2 * icap - 1]
    leaff = i32_as_f32(leafi[:, :6].contiguous())
    a_min, a_max = leaff[:, 0:3], leaff[:, 3:6]
    inst_a = leafi[:, 13]
    a_real = mask[inst_a.long().clamp(0, icap - 1)]

    node = torch.where(a_real, 0, INVALID_NODE).to(torch.int32)
    stack = torch.full((icap, stack_size), INVALID_NODE, dtype=torch.int32,
                       device=dev)
    sptr = torch.zeros((icap,), dtype=torch.int32, device=dev)
    count = torch.zeros((icap,), dtype=torch.int32, device=dev)
    contacts = (torch.full((max_contacts, 2), -1, dtype=torch.int32,
                           device=dev) if max_contacts > 0 else None)
    slots = torch.arange(stack_size, dtype=torch.int32, device=dev)[None, :]
    lanes = torch.arange(icap, device=dev)

    def overlaps(bmin, bmax):
        return ((a_max >= bmin) & (a_min <= bmax)).all(dim=-1)

    while bool((node != INVALID_NODE).any()):
        active = node != INVALID_NODE
        nfi = nodes[node.long().clamp(0, nodes.shape[0] - 1)]
        nf = i32_as_f32(nfi[:, :12].contiguous())
        c0, c1 = nfi[:, 12], nfi[:, 13]
        is_leaf = c0 == INVALID_NODE
        ov0 = overlaps(nf[:, 0:3], nf[:, 3:6]) & active & ~is_leaf
        ov1 = overlaps(nf[:, 6:9], nf[:, 9:12]) & active & ~is_leaf

        # Leaf: count the pair once (b > a) if both are real instances.
        inst_b = c1
        b_real = mask[inst_b.long().clamp(0, icap - 1)]
        pair = active & is_leaf & (inst_b > inst_a) & b_real \
            & overlaps(nf[:, 0:3], nf[:, 3:6])
        if contacts is not None:
            rows = (offsets + count)[pair].long()
            contacts[rows] = torch.stack([inst_a, inst_b], -1)[pair]
        count = count + pair.to(torch.int32)

        # Descend: both -> push c1 and visit c0; one -> visit it; none ->
        # pop.
        both = ov0 & ov1
        sptr1 = torch.where(both, sptr + 1, sptr)
        top_slot = sptr1.clamp(0, stack_size - 1)
        stack = torch.where((slots == top_slot[:, None]) & both[:, None],
                            c1[:, None], stack)
        descend = ov0 | ov1
        need_pop = active & ~descend
        top = stack[lanes, top_slot.long()]
        node = torch.where(descend, torch.where(ov0, c0, c1),
                           torch.where(need_pop,
                                       torch.where(sptr1 > 0, top,
                                                   INVALID_NODE), node))
        sptr = torch.where(need_pop & (sptr1 > 0), sptr1 - 1, sptr1)
    return count, contacts


def collide_instances(scene: StaticTLAS) -> CollisionResult:
    """All instance pairs whose world AABBs overlap. Exact two-pass:
    count, exclusive cumsum, write, sized to the true total."""
    nodes, icap = _tlas_leaf_blocks(scene)
    mask = scene.instances.mask
    counts, _ = _collide_pass(nodes, icap, mask, None, 0)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    total = int(counts.sum())
    if total == 0:
        return CollisionResult(contacts=torch.zeros(
            (0, 2), dtype=torch.int32, device=nodes.device), num_contacts=0)
    _, contacts = _collide_pass(nodes, icap, mask, offsets, total)
    return CollisionResult(contacts=contacts, num_contacts=total)


def collide_instances_any(tlas, handle_a, handle_b) -> bool:
    """Whether any instance of ``handle_a`` overlaps any of ``handle_b``
    (world AABBs, on the host)."""
    scene = tlas.sync()
    wmin, wmax = instance_world_aabbs(scene.instances, scene.blas_root_aabb)
    wmins, wmaxs = wmin.cpu().numpy(), wmax.cpu().numpy()
    for ia in tlas._require(handle_a):
        for ib in tlas._require(handle_b):
            if np.all(wmaxs[ia] >= wmins[ib]) and np.all(
                    wmins[ia] <= wmaxs[ib]):
                return True
    return False
