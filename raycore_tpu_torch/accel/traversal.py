"""Two-level BVH traversal as a lane-parallel stack machine (counterpart
of ``raycore_tpu/accel/traversal.py``).

Every ray of a tile advances one traversal step per iteration: near/far
child ordering at internal nodes, the instance transition at a TLAS leaf
(push ``TOP_LEVEL_SENTINEL``, move the ray into the instance's local
space), the Möller–Trumbore test against a BLAS leaf's vertices with
t_max shrinking on a hit, and the pop back to world space at the
sentinel. Masks stand in for branches, and one row gather from
``unified_nodes`` (the TLAS block, then every BLAS block) fetches a
node. any_hit forces t_min = 0 and retires a lane at its first hit.

The JAX package runs the steps in a ``lax.while_loop``; here they are a
Python loop of tensor steps that asks whether any lane is still active
once every ``substeps`` steps, so one host sync covers ``substeps``
steps. Plain torch ops: a hand kernel waits for a profile (ROADMAP.md).

The arithmetic is the reference's compiled arithmetic: the slab test's
``p * inv_d + (-o * inv_d)`` and the transforms' dots are fused
multiply-adds (``core/triangle.py:fma``), as its compiler fuses them.
"""
from __future__ import annotations

import math

import torch

from ..core.ray import Ray
from ..core.transforms import _apply_mat3_fused
from ..core.triangle import (INV_DIR_CLAMP, fast_intersect_triangle, fma,
                             safe_invdir)
from .brute import HitResult, _masked_rows
from .types import INVALID_NODE, TOP_LEVEL_SENTINEL, StaticTLAS

_INF = float("inf")


def _slab(o, invd, p_min, p_max, t_min, t_max):
    """``core/bounds.py:fast_intersect_bbox`` with its two products fused
    into the adds: (entry_t, exit_t), a hit where entry <= exit."""
    oxinv = -o * invd
    f = fma(p_max, invd, oxinv)
    n = fma(p_min, invd, oxinv)
    hi = torch.maximum(f, n)
    lo = torch.minimum(f, n)
    all_t = (invd.abs() >= INV_DIR_CLAMP) & (o >= p_min) & (o <= p_max)
    lo = torch.where(all_t, -_INF, lo)
    hi = torch.where(all_t, _INF, hi)
    return (torch.maximum(lo.amax(dim=-1), t_min),
            torch.minimum(hi.amin(dim=-1), t_max))


def _to_local(inv, o, d):
    """World rays into an instance's local space through its inverse
    (R, 3, 4): o_l = R o + t, d_l = R d, the dots fused (both in one
    call)."""
    od = _apply_mat3_fused(inv[:, None, :, :3], torch.stack([o, d], dim=1))
    return od[:, 0] + inv[:, :, 3], od[:, 1]


def _traverse_tile(tlas: StaticTLAS, o_w, d_w, t_min, t_max0, *,
                   any_hit: bool, stack_size: int, max_iters: int,
                   substeps: int = 4):
    """Run the stack machine on one tile of rays (flat (R, ...) tensors).
    Returns (best_inst, best_prim, t, u, v, overflowed): the indices are -1
    on a miss; ``overflowed`` says whether a push ran past the stack top
    (the tile then stops at once and its results are void)."""
    R = o_w.shape[0]
    dev = o_w.device
    nodes = tlas.unified_nodes
    n_rows = nodes.shape[0]
    inst_inv = tlas.instances.inv_transform
    inst_blas = tlas.instances.blas_index.long()
    blas_base = tlas.blas_nodes_offset.long()
    n_inst, n_blas = inst_inv.shape[0], blas_base.shape[0]
    invd_w = safe_invdir(d_w)
    lanes = torch.arange(R, device=dev)
    i32 = lambda v: torch.full((R,), v, dtype=torch.int64, device=dev)

    node, base, inst = i32(0), i32(0), i32(-1)
    stack = torch.full((R, stack_size), INVALID_NODE, dtype=torch.int64,
                       device=dev)
    sptr = i32(0)
    o, d, invd, t_max = o_w, d_w, invd_w, t_max0
    best_inst, best_prim = i32(-1), i32(-1)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    top_slot = stack_size - 1

    def step():
        nonlocal node, base, inst, stack, sptr, o, d, invd, t_max
        nonlocal best_inst, best_prim, best_u, best_v, ovf
        active = node != INVALID_NODE
        nfi = nodes[(base + node).clamp(0, n_rows - 1)]       # (R, 16)
        nf = nfi[:, :12].contiguous().view(torch.float32)
        c0, c1 = nfi[:, 12].long(), nfi[:, 13].long()
        is_leaf = c0 == INVALID_NODE
        is_top = inst < 0
        case_internal = active & ~is_leaf
        case_tlas_leaf = active & is_leaf & is_top
        case_blas_leaf = active & is_leaf & ~is_top

        # Internal node: the ordered two-child slab test, both children in
        # one call (aabb k's min and max are rows (k, 0) and (k, 1)).
        boxes = nf.reshape(R, 2, 2, 3)
        tmin2, tmax2 = _slab(o[:, None], invd[:, None], boxes[:, :, 0],
                             boxes[:, :, 1], t_min[:, None], t_max[:, None])
        t0min, t1min = tmin2.unbind(1)
        t0max, t1max = tmax2.unbind(1)
        trav0 = torch.where(t0min <= t0max, c0, INVALID_NODE)
        trav1 = torch.where(t1min <= t1max, c1, INVALID_NODE)
        first0 = (t0min < t1min) & (trav0 != INVALID_NODE)
        near = torch.where(first0, trav0, trav1)
        far = torch.where(first0, trav1, trav0)

        # BLAS leaf: Möller–Trumbore on the leaf's vertices.
        h, t, u, v = fast_intersect_triangle(
            o, d, nf[:, 0:3], nf[:, 3:6], nf[:, 6:9], t_min, t_max)
        h = h & case_blas_leaf
        t_max = torch.where(h, t, t_max)
        best_inst = torch.where(h, inst, best_inst)
        best_prim = torch.where(h, c1, best_prim)
        best_u = torch.where(h, u, best_u)
        best_v = torch.where(h, v, best_v)

        # TLAS leaf: enter the instance.
        enter = case_tlas_leaf
        new_inst = c1.clamp(0, n_inst - 1)
        inv_t = inst_inv[new_inst]
        new_base = blas_base[inst_blas[new_inst].clamp(0, n_blas - 1)]
        o_loc, d_loc = _to_local(inv_t, o_w, d_w)

        # Push the far child or the sentinel. A push past the top would
        # overwrite the top slot and drop a far child: flag it; the query
        # re-runs with the proven-depth stack.
        do_push = (case_internal & (far != INVALID_NODE)) | enter
        push_val = torch.where(enter, TOP_LEVEL_SENTINEL, far)
        sptr1 = torch.where(do_push, sptr + 1, sptr)
        ovf = ovf | (do_push & (sptr1 > top_slot)).any()
        widx = sptr1.clamp(0, top_slot)
        old_top = stack[lanes, widx]
        stack[lanes, widx] = torch.where(do_push, push_val, old_top)

        # Descend, or pop (past a sentinel back to the top level).
        lane_done = h if any_hit else torch.zeros_like(h)
        descend = ((case_internal & (near != INVALID_NODE)) | enter) \
            & ~lane_done
        need_pop = active & ~descend & ~lane_done
        top = stack[lanes, widx]
        sptr2 = sptr1 - 1
        hit_sent = need_pop & (top == TOP_LEVEL_SENTINEL)
        top2 = stack[lanes, sptr2.clamp(0, top_slot)]
        popped = torch.where(hit_sent, top2, top)
        sptr2 = torch.where(hit_sent, sptr2 - 1, sptr2)

        node = torch.where(lane_done, INVALID_NODE, torch.where(
            descend, torch.where(enter, 0, near),
            torch.where(need_pop, popped, node)))
        sptr = torch.where(need_pop, sptr2, sptr1)
        leave = hit_sent
        inst = torch.where(enter, new_inst, torch.where(leave, -1, inst))
        base = torch.where(enter, new_base, torch.where(leave, 0, base))
        en, lv = enter[:, None], leave[:, None]
        o = torch.where(en, o_loc, torch.where(lv, o_w, o))
        d = torch.where(en, d_loc, torch.where(lv, d_w, d))
        invd = torch.where(en, safe_invdir(d_loc),
                           torch.where(lv, invd_w, invd))

    iters = 0
    # The JAX loop's condition, read on the host once per ``substeps``
    # steps: some lane active, under max_iters, no overflow.
    while iters < max_iters and bool(
            ((node != INVALID_NODE).any() & ~ovf).item()):
        for _ in range(substeps):
            step()
        iters += substeps
    return best_inst, best_prim, t_max, best_u, best_v, bool(ovf.item())


def _finalize(tlas: StaticTLAS, best_inst, best_prim, t_maxed, u, v):
    hit = best_inst >= 0
    bidx = tlas.instances.blas_index[best_inst.clamp_min(0)].long() \
        .clamp(0, tlas.blas_prims_offset.shape[0] - 1)
    prim_row = tlas.blas_prims_offset[bidx].long() + best_prim.clamp_min(0)
    prim_row = prim_row.clamp(0, tlas.prims.vertices.shape[0] - 1)
    bary = torch.where(hit[:, None], torch.stack([1.0 - u - v, u, v], -1),
                       0.0)
    return HitResult(hit=hit, triangle=_masked_rows(tlas.prims, prim_row, hit),
                     t=torch.where(hit, t_maxed, 0.0), barycentric=bary,
                     prim_idx=torch.where(hit, best_prim, -1).to(torch.int32),
                     instance_idx=torch.where(hit, best_inst, -1)
                     .to(torch.int32))


def _trace(tlas: StaticTLAS, o, d, t_min, t_max, *, any_hit: bool,
           stack_size: int, max_iters: int, tile_size: int,
           substeps: int = 4, force_tmin0: bool = False):
    """Turn -0 directions into +0, pad to whole tiles with rays that
    retire at once (t_max = -1), run the tiles one after another and
    finalize. Returns (HitResult of the R rows, whether a tile
    overflowed)."""
    R0 = o.shape[0]
    d = torch.where(d == 0.0, 0.0, d)
    if force_tmin0:
        t_min = torch.zeros_like(t_min)
    n_tiles = max(1, -(-R0 // tile_size))
    padded = n_tiles * tile_size
    if padded != R0:
        padf = lambda a, fill: torch.cat(
            [a, torch.full((padded - R0,) + tuple(a.shape[1:]), fill,
                           dtype=a.dtype, device=a.device)])
        o, d = padf(o, 0.0), padf(d, 1.0)
        t_min, t_max = padf(t_min, 0.0), padf(t_max, -1.0)
    outs, ovf = [], False
    for k in range(n_tiles):
        s = slice(k * tile_size, (k + 1) * tile_size)
        *res, tile_ovf = _traverse_tile(
            tlas, o[s], d[s], t_min[s], t_max[s], any_hit=any_hit,
            stack_size=stack_size, max_iters=max_iters, substeps=substeps)
        outs.append(res)
        ovf = ovf or tile_ovf
    flat = [torch.cat(parts)[:R0] for parts in zip(*outs)]
    return _finalize(tlas, *flat), ovf


def stack_depth_bound(tlas: StaticTLAS) -> int:
    """Proven worst-case stack need: a Karras tree over n leaves with
    30-bit codes and the index tiebreak is at most 30 + ceil(log2 n) deep,
    and the stack holds at most the TLAS depth, one sentinel and the BLAS
    depth; the unified node count bounds both leaf counts."""
    n = max(int(tlas.unified_nodes.shape[0]), 2)
    per_level = 30 + math.ceil(math.log2(n))
    return 2 * per_level + 2


def _query(tlas, rays: Ray, *, any_hit: bool, stack_size: int,
           tile_size: int, max_iters: int, substeps: int,
           force_tmin0: bool) -> HitResult:
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[len(batch):]))
    o = flat(rays.o)
    args = (tlas, o, flat(rays.d), flat(rays.t_min), flat(rays.t_max))
    kw = dict(any_hit=any_hit, max_iters=max_iters,
              tile_size=min(tile_size, max(o.shape[0], 8)),
              substeps=substeps, force_tmin0=force_tmin0)
    bound = stack_depth_bound(tlas)
    res, ovf = _trace(*args, stack_size=stack_size, **kw)
    if ovf and stack_size < bound:
        # A push ran past the stack top, so far children may be lost:
        # re-run once with the proven-depth stack, which cannot overflow.
        res, ovf = _trace(*args, stack_size=bound, **kw)
        assert not ovf, "traversal overflowed its proven stack bound"
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))


def closest_hit(tlas: StaticTLAS, rays: Ray, *, stack_size: int = 64,
                tile_size: int = 16384, max_iters: int = 1 << 17,
                substeps: int = 4) -> HitResult:
    """Closest hit over a batched Ray; the result has the ray batch shape,
    with the zero triangle and -1 indices on a miss. An overflow of the
    ``stack_size``-slot stack is detected and the query re-runs with the
    proven-depth stack (``stack_depth_bound``)."""
    return _query(tlas, rays, any_hit=False, stack_size=stack_size,
                  tile_size=tile_size, max_iters=max_iters,
                  substeps=substeps, force_tmin0=False)


def any_hit(tlas: StaticTLAS, rays: Ray, *, stack_size: int = 64,
            tile_size: int = 16384, max_iters: int = 1 << 17,
            substeps: int = 4) -> HitResult:
    """Occlusion: t_min forced to 0, each lane retired at its first hit in
    traversal order. Only the hit mask and the occluder's ids are the
    contract."""
    return _query(tlas, rays, any_hit=True, stack_size=stack_size,
                  tile_size=tile_size, max_iters=max_iters,
                  substeps=substeps, force_tmin0=True)
