"""Wide (4-ary) BVH: the collapse of a binary BVH and the 4-wide traversal
(counterpart of ``raycore_tpu/accel/wide.py``).

Every internal row i of the binary BVH becomes BVH4 row i, whose 4 slots
are its children where they are leaves and its grandchildren where they
are not; rows at odd depth are never referenced. Where exactly one child
is a leaf, the first internal grandchild is expanded once more, so all 4
slots fill. The collapse is gathers and min/max only, so its rows equal
the JAX package's bit for bit.

Packed BVH4 row layout, (n-1, 32) int32 with float fields as their bits:

    cols [6k, 6k+3)   slot k's AABB min   (k = 0..3; empty slot: +inf)
    cols [6k+3, 6k+6) slot k's AABB max   (empty slot: -inf)
    cols 24:28        slot refs: -1 empty; bit 30 set: a leaf, the low
                      bits its sorted prim index; else a BVH4 row
    cols 28:32        padding

As in Raycore.jl, ``TLAS4`` is a type with no build and no traversal;
``closest_hit4`` and ``any_hit4`` query one ``BLAS4``. The traversal is
``accel/traversal.py``'s stack machine on 4-wide rows: the 4 slab tests,
a 5-comparator network that orders the slots near to far, the far slots
pushed farthest first, and one host sync per ``substeps`` steps.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.triangle import Triangle, fast_intersect_triangle, safe_invdir
from .brute import HitResult, _masked_rows
from .lbvh import build_blas
from .traversal import _slab
from .types import (BLAS, INVALID_NODE, f32_as_i32, flush_denormals,
                    i32_as_f32)

LEAF_BIT = 1 << 30
_INVALID = -1


@dataclasses.dataclass
class BLAS4:
    """4-wide BLAS (reference BLAS4)."""

    nodes4: torch.Tensor     # (capacity-1, 32) int32 packed (float bits)
    prims: Triangle          # (capacity,) sorted, shared with the BVH2
    root_aabb: torch.Tensor  # (2, 3)
    n_prims: int
    capacity: int


@dataclasses.dataclass
class TLAS4:
    """A 4-wide instanced TLAS type with no build and no traversal, as in
    the reference; the instanced paths are the BVH2 ``StaticTLAS`` and the
    dense engines."""

    blas4: BLAS4
    instances: object = None


def _node2_aabb(nodes2, ids):
    """AABB of binary BVH node ids: an internal row's two child boxes
    united, a leaf row's inline vertices bounded; denormal bounds flushed
    to zero, as the reference's min/max flush them (T9)."""
    nfi = nodes2[ids]
    nf = i32_as_f32(nfi[:, :12].contiguous())
    is_leaf = (nfi[:, 12] == INVALID_NODE)[:, None]
    int_min = torch.minimum(nf[:, 0:3], nf[:, 6:9])
    int_max = torch.maximum(nf[:, 3:6], nf[:, 9:12])
    v = torch.stack([nf[:, 0:3], nf[:, 3:6], nf[:, 6:9]], dim=1)
    return (flush_denormals(torch.where(is_leaf, v.amin(dim=1), int_min)),
            flush_denormals(torch.where(is_leaf, v.amax(dim=1), int_max)))


def _collapse(nodes2):
    """(n-1, 32) int32 BVH4 rows from the (2n-1, 16) binary node rows,
    every internal row at once."""
    total = nodes2.shape[0]
    n = (total + 1) // 2              # capacity (leaf count)
    ni = n - 1                        # internal rows
    leaf_base = n - 1
    c0 = nodes2[:ni, 12]
    c1 = nodes2[:ni, 13]

    def children(c):
        """(g0, g1) of binary node ids; garbage for leaves (callers mask
        on interiority)."""
        cc = c.clamp(0, ni - 1).long()
        return nodes2[cc, 12], nodes2[cc, 13]

    def expand(c):
        """A leaf child gives (itself, empty), an internal child its two
        children."""
        leaf = c >= leaf_base
        g0, g1 = children(c)
        return torch.where(leaf, c, g0), torch.where(leaf, _INVALID, g1)

    a0, b0 = expand(c0)
    a1, b1 = expand(c1)
    slots = torch.stack([a0, b0, a1, b1], dim=1)            # (ni, 4)

    # One leaf child and one internal child fill 3 slots: expand the
    # first internal grandchild as well.
    c0_leaf = c0 >= leaf_base
    c1_leaf = c1 >= leaf_base
    one_leaf = c0_leaf ^ c1_leaf
    leaf_slot = torch.where(c0_leaf, c0, c1)
    g0, g1 = children(torch.where(c0_leaf, c1, c0))
    g0_int = (g0 >= 0) & (g0 < leaf_base)
    g1_int = (g1 >= 0) & (g1 < leaf_base)
    e = torch.where(g0_int, g0, g1)
    keep = torch.where(g0_int, g1, g0)
    h0, h1 = children(e)
    do3 = one_leaf & (g0_int | g1_int)
    slots3 = torch.stack([leaf_slot, keep, h0, h1], dim=1)
    slots = torch.where(do3[:, None], slots3, slots)

    valid = slots >= 0
    ids = slots.clamp(0, total - 1).reshape(-1).long()
    mn, mx = _node2_aabb(nodes2, ids)
    vflat = valid.reshape(-1, 1)
    mn = torch.where(vflat, mn, float("inf")).reshape(ni, 4, 3)
    mx = torch.where(vflat, mx, -float("inf")).reshape(ni, 4, 3)

    # Refs: a leaf is LEAF_BIT | its sorted prim index (the leaf row's
    # child1), an internal slot its own row index.
    prim_idx = nodes2[ids, 13].reshape(ni, 4)
    refs = torch.where(slots >= leaf_base, LEAF_BIT | prim_idx, slots)
    refs = torch.where(valid, refs, _INVALID).to(torch.int32)

    boxes = torch.cat([mn, mx], dim=2).reshape(ni, 24).contiguous()
    return torch.cat([f32_as_i32(boxes), refs,
                      torch.zeros((ni, 4), dtype=torch.int32,
                                  device=nodes2.device)], dim=1)


def collapse_blas(blas: BLAS) -> BLAS4:
    """Binary BVH to BVH4 (reference collapse_bvh2_to_bvh4)."""
    return BLAS4(nodes4=_collapse(blas.nodes), prims=blas.prims,
                 root_aabb=blas.root_aabb, n_prims=blas.n_prims,
                 capacity=blas.capacity)


def build_blas4(tris: Triangle, capacity: int | None = None) -> BLAS4:
    """``build_blas`` on the triangles' device, then ``collapse_blas``."""
    return collapse_blas(build_blas(tris, capacity))


# ---------------------------------------------------------------------------
# The 4-wide traversal
# ---------------------------------------------------------------------------

def _sort4(keys, vals):
    """Ascending order of 4 (key, val) lanes by the reference's
    5-comparator network; each compare-and-swap swaps only on a strict
    ``>``, so which of two equal keys comes first is the network's, not a
    stable sort's."""
    k, v = list(keys), list(vals)
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        swap = k[i] > k[j]
        k[i], k[j] = (torch.where(swap, k[j], k[i]),
                      torch.where(swap, k[i], k[j]))
        v[i], v[j] = (torch.where(swap, v[j], v[i]),
                      torch.where(swap, v[i], v[j]))
    return k, v


def _traverse4_tile(blas4: BLAS4, o, d, t_min, t_max0, *, any_hit: bool,
                    stack_size: int, max_iters: int, substeps: int):
    """The stack machine on one tile of rays (flat tensors). Returns
    (best prim, t, u, v); the prim is -1 on a miss. The stack's slot 0 is
    never written: a pop at pointer 0 reads its -1 and retires the lane."""
    R = o.shape[0]
    dev = o.device
    nodes = blas4.nodes4
    n_rows = nodes.shape[0]
    verts = blas4.prims.vertices
    n_verts = verts.shape[0]
    invd = safe_invdir(d)
    lanes = torch.arange(R, device=dev)
    top_slot = stack_size - 1

    node = torch.zeros(R, dtype=torch.int64, device=dev)
    stack = torch.full((R, stack_size), _INVALID, dtype=torch.int64,
                       device=dev)
    sptr = torch.zeros(R, dtype=torch.int64, device=dev)
    t_max = t_max0
    best_prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)

    def step():
        nonlocal node, stack, sptr, t_max, best_prim, best_u, best_v
        active = node != _INVALID
        is_leaf = active & ((node & LEAF_BIT) != 0)
        is_int = active & ~is_leaf

        # Internal: fetch the row, 4 slab tests, order the slots near to
        # far.
        row = torch.where(is_leaf, 0, node).clamp(0, n_rows - 1)
        nfi = nodes[row]                                      # (R, 32)
        boxes = i32_as_f32(nfi[:, :24].contiguous()).reshape(R, 4, 2, 3)
        refs = nfi[:, 24:28].long()
        lo, hi = _slab(o[:, None], invd[:, None], boxes[:, :, 0],
                       boxes[:, :, 1], t_min[:, None], t_max[:, None])
        ok = (lo <= hi) & (refs != _INVALID)
        tmins = torch.where(ok, lo, float("inf"))
        keys, vals = _sort4(tmins.unbind(1), refs.unbind(1))
        valid_sorted = [torch.isfinite(k) for k in keys]

        # Leaf: Möller–Trumbore against the referenced prim.
        pidx = node & (LEAF_BIT - 1)
        tv = verts[pidx.clamp(0, n_verts - 1)]                # (R, 3, 3)
        h, t, u, v = fast_intersect_triangle(
            o, d, tv[:, 0], tv[:, 1], tv[:, 2], t_min, t_max)
        h = h & is_leaf
        t_max = torch.where(h, t, t_max)
        best_prim = torch.where(h, pidx, best_prim)
        best_u = torch.where(h, u, best_u)
        best_v = torch.where(h, v, best_v)
        lane_done = h if any_hit else torch.zeros_like(h)

        # Push the far slots farthest first, so the nearest pops first;
        # a push past the top overwrites the top slot, as in the
        # reference.
        for k in (3, 2, 1):
            do = is_int & valid_sorted[k] & ~lane_done
            sptr = torch.where(do, sptr + 1, sptr)
            widx = sptr.clamp(0, top_slot)
            stack[lanes, widx] = torch.where(do, vals[k], stack[lanes, widx])

        descend = is_int & valid_sorted[0] & ~lane_done
        need_pop = active & ~descend & ~lane_done
        top = stack[lanes, sptr.clamp(0, top_slot)]
        node = torch.where(lane_done, _INVALID, torch.where(
            descend, vals[0], torch.where(need_pop, top, node)))
        sptr = torch.where(need_pop, sptr - 1, sptr)

    iters = 0
    # The JAX loop's condition, read on the host once per ``substeps``
    # steps; a retired lane stays retired, so the extra steps are no-ops.
    while iters < max_iters and bool((node != _INVALID).any().item()):
        for _ in range(min(substeps, max_iters - iters)):
            step()
        iters += substeps
    return best_prim, t_max, best_u, best_v


def _trace4(blas4: BLAS4, rays, *, any_hit: bool, stack_size: int,
            max_iters: int, tile_size: int, substeps: int) -> HitResult:
    """Flatten, turn -0 directions into +0 (t_min 0 for any_hit), pad to
    whole tiles with rays that retire at once (t_max = -1), run the tiles
    one after another and finalize to the batch shape."""
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[len(batch):]))
    o, d = flat(rays.o), flat(rays.d)
    t_min, t_max = flat(rays.t_min), flat(rays.t_max)
    d = torch.where(d == 0.0, 0.0, d)
    if any_hit:
        t_min = torch.zeros_like(t_min)
    R = o.shape[0]
    tile_size = min(tile_size, max(R, 8))
    n_tiles = max(1, -(-R // tile_size))
    padded = n_tiles * tile_size
    if padded != R:
        padf = lambda a, fill: torch.cat(
            [a, torch.full((padded - R,) + tuple(a.shape[1:]), fill,
                           dtype=a.dtype, device=a.device)])
        o, d = padf(o, 0.0), padf(d, 1.0)
        t_min, t_max = padf(t_min, 0.0), padf(t_max, -1.0)
    outs = []
    for k in range(n_tiles):
        s = slice(k * tile_size, (k + 1) * tile_size)
        outs.append(_traverse4_tile(
            blas4, o[s], d[s], t_min[s], t_max[s], any_hit=any_hit,
            stack_size=stack_size, max_iters=max_iters, substeps=substeps))
    best_prim, t_maxed, u, v = (torch.cat(p)[:R] for p in zip(*outs))
    hit = best_prim >= 0
    idx = best_prim.clamp(0, blas4.prims.vertices.shape[0] - 1)
    bary = torch.where(hit[:, None], torch.stack([1 - u - v, u, v], -1), 0.0)
    res = HitResult(hit=hit, triangle=_masked_rows(blas4.prims, idx, hit),
                    t=torch.where(hit, t_maxed, 0.0), barycentric=bary,
                    prim_idx=torch.where(hit, best_prim, -1).to(torch.int32),
                    instance_idx=torch.where(hit, 0, -1).to(torch.int32))
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))


def closest_hit4(blas4: BLAS4, rays, *, stack_size: int = 48,
                 tile_size: int = 16384, max_iters: int = 1 << 17,
                 substeps: int = 4) -> HitResult:
    """Closest hit on one BLAS4 (reference closest_hit4); ``prim_idx``
    indexes the sorted prims, as in the reference."""
    return _trace4(blas4, rays, any_hit=False, stack_size=stack_size,
                   max_iters=max_iters, tile_size=tile_size,
                   substeps=substeps)


def any_hit4(blas4: BLAS4, rays, *, stack_size: int = 48,
             tile_size: int = 16384, max_iters: int = 1 << 17,
             substeps: int = 4) -> HitResult:
    """First hit in traversal order on one BLAS4, t_min forced to 0
    (reference any_hit4): a lane retires at its first hit and pushes
    nothing for it."""
    return _trace4(blas4, rays, any_hit=True, stack_size=stack_size,
                   max_iters=max_iters, tile_size=tile_size,
                   substeps=substeps)
