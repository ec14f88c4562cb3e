"""Phase-A interval culling, the tile worklist and the occlusion query
(counterpart of ``raycore_tpu/ops/pallas_dense.py``).

Kernels, each launched by its wrapper on CUDA tensors and replaced by its
plain PyTorch version on CPU tensors (the tensor's device alone decides):

- K1 ``phase_a`` (``csrc/phase_a.cu``, plain ``phase_a_plain``): the
  (ray tile, cluster) entry matrix.
- K3 ``run_worklist`` (``csrc/worklist_sweep.cu``, plain
  ``run_worklist_plain``): the tile-worklist closest-hit sweep.
- K4 ``run_occlusion`` (``csrc/occlusion_sweep.cu``, plain
  ``run_occlusion_plain``): the tile-worklist any-hit sweep.

The plain sweeps take the featurized test as a ``torch.bmm`` product, as
the JAX package's matrix product does. ``kernel_order_hits`` evaluates it
as the sweep kernels K2-K5 do, bit for bit (19-term FMA chains, dead rays,
the division-free reject, the rounded epilogue); ``run_worklist_model``
and ``run_occlusion_model`` run the plain sweeps through it on chosen
tiles, ``ops/regroup.py``'s models K2's and K5's on chosen blocks.

The drivers keep the JAX names, ``_pallas`` included: stripped,
``closest_hit_dense_pallas`` would collide with the XLA rounds engine's
``closest_hit_dense``. The worklist is exact, sized by ``nonzero``: there
is no capacity bucket, no dummy tile and no chunk aliasing; each kernel
walks a tile's blocks through ``tile_ranges``.

Tracing (``utils/config.py:span``): the worklist queries run their stages
in ``raycore.stage1``, ``raycore.sweep``, ``raycore.combine`` and
``raycore.finalize`` spans, and each host sync in a
``raycore.wait.<site>`` span.
"""
from __future__ import annotations

import torch

from ..accel.brute import HitResult
from ..accel.dense import (EDGE_EPS, INVD_COLS, finalize_hits_exact,
                           prim_only_hits, ray_features)
from ..core.triangle import INV_DIR_CLAMP, fma
from ..kernels import _build
from ..utils.config import span

FEAT = 16
INT32_MAX = 0x7FFFFFFF
INT32_MIN = -0x80000000
# The plain sweeps' product chunk: 2^27 float32 elements (512 MiB).
PLAIN_CHUNK_ELEMS = 1 << 27
# The feature rows that the sweep kernels' fused multiply-add chain reads
# for each quantity, ascending: det rows 0-2, u*det and v*det rows 0-5,
# t*det rows 6-9 (accel/dense.py:_featurize_tris leaves every other row of
# its column zero). DENSE_ROWS is the 10-deep chain they ran before.
SPARSE_ROWS = ((0, 1, 2), (0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5),
               (6, 7, 8, 9))
DENSE_ROWS = (tuple(range(10)),) * 4
# The division-free reject's constants as float32 (csrc/featurized.cuh:
# quick_reject, which states why they are safe).
REJECT_MARGIN = 2e-5
REJECT_SUM = 1.0001
REJECT_DET_RANGE = (2.0 ** -60, 2.0 ** 60)


def _idx_bits(CS: int) -> int:
    """Mantissa bits of a packed key that carry the lane within a
    sub-chunk of CS triangles (8 for 256)."""
    return max((CS - 1).bit_length(), 1)


def _pack_tmax(t_max, bits: int):
    """Initial packed keys from per-ray t_max: the bits of max(t_max, 0)
    with the lane field saturated, so any candidate with a smaller
    truncated t wins. Padding rows (t_max = -inf) clamp to 0. At
    t_max = inf the key is a NaN pattern: compare keys as int32 and decode
    them only through ``_t_from_keys``."""
    mask = (1 << bits) - 1
    tp = t_max.to(torch.float32)
    tp = torch.maximum(tp, torch.zeros_like(tp))
    return (tp.view(torch.int32) & ~mask) | mask


def _t_from_keys(key, bits: int):
    """Decode a float32 t from int32 keys whose low ``bits`` mantissa bits
    carry a lane index (bits=0: the key is the t's bit pattern)."""
    mask = (1 << bits) - 1
    return (key & ~mask).view(torch.float32)


def interval_entry(st, bmin, bmax):
    """Conservative entry lower bound of ray bundles into boxes, +inf where
    provably no ray of the bundle enters the box.

    ``st`` (..., 14) bundle stats, cols o_lo(0:3) o_hi(3:6) i_lo(6:9)
    i_hi(9:12) tmin(12) tmax(13); ``bmin``/``bmax`` (..., 3) boxes. The
    leading dims broadcast against each other. Per axis the slab interval
    comes from the min and max of the 8 corner products; a near-parallel
    bundle (clamped inverse direction) whose origins may lie inside the
    slab never exits it, so that axis widens to (-inf, inf). Kernels K1
    and K7 repeat these steps in this order."""
    shape = torch.broadcast_shapes(st.shape[:-1], bmin.shape[:-1])
    inf = float("inf")
    full = lambda v: torch.full(shape, v, dtype=torch.float32,
                                device=st.device)
    t_lo, t_hi = full(-inf), full(inf)
    CL = INV_DIR_CLAMP
    for a in range(3):
        blo, bhi = bmin[..., a], bmax[..., a]
        o_lo, o_hi = st[..., a], st[..., 3 + a]
        i_lo, i_hi = st[..., 6 + a], st[..., 9 + a]
        lo8, hi8 = full(inf), full(-inf)
        for bb in (blo, bhi):
            for oc in (o_lo, o_hi):
                diff = bb - oc
                for ic in (i_lo, i_hi):
                    prod = diff * ic
                    lo8 = torch.minimum(lo8, prod)
                    hi8 = torch.maximum(hi8, prod)
        wide = ((i_hi >= CL) | (i_lo <= -CL)) & (o_hi >= blo) & (o_lo <= bhi)
        t_lo = torch.maximum(t_lo, torch.where(wide, -inf, lo8))
        t_hi = torch.minimum(t_hi, torch.where(wide, inf, hi8))
    entry = torch.maximum(t_lo, st[..., 12])
    exit_ = torch.minimum(t_hi, st[..., 13])
    return torch.where(entry <= exit_, entry, inf)


# Kernel K1's CTA (csrc/phase_a.cu): PHASE_A_THREADS threads of
# PHASE_A_CPT clusters each, by a strip of PHASE_A_STRIP tiles.
PHASE_A_THREADS = 256
PHASE_A_CPT = 2
PHASE_A_STRIP = 8


def phase_a_grid(n_tiles: int, K: int):
    """K1's grid of CTAs for an (n_tiles, K) entry matrix."""
    return (-(-K // (PHASE_A_THREADS * PHASE_A_CPT)),
            min(-(-n_tiles // PHASE_A_STRIP), 65535))


def phase_a_plain(stats, bounds):
    """(n_tiles, 16) stats x (6, K) bounds -> (n_tiles, K)
    ``interval_entry`` of every (tile, cluster) pair. Bounds rows: bmin
    xyz (0:3), bmax xyz (3:6)."""
    return interval_entry(stats[:, None, :14], bounds[:3].T[None],
                          bounds[3:].T[None])


def phase_a_model(stats, bounds):
    """``phase_a_plain`` computed as kernel K1 computes it, bit for bit
    (``phase_a_paths``' entry)."""
    return phase_a_paths(stats, bounds)[0]


def phase_a_paths(stats, bounds):
    """(entry, fast): kernel K1's entry matrix, bit for bit, and the pairs
    where it takes its fast arithmetic (``interval_entry_paths`` on
    ``phase_a_plain``'s operands)."""
    return interval_entry_paths(stats[:, None, :14], bounds[:3].T[None],
                                bounds[3:].T[None])


def interval_entry_paths(st, bmin, bmax):
    """(entry, fast): ``interval_entry(st, bmin, bmax)`` computed as
    kernels K1 and K7 compute it (``csrc/entry.cuh``), bit for bit, and the
    entries where they take their fast arithmetic. That is, where the
    stats and the box lie in the class of ``entry_fast`` (o_lo, o_hi,
    i_lo, i_hi finite with i nonzero, t_min_lo and t_max_hi not NaN; the
    box's six bounds finite), per axis the min and max of the 4 products
    of the extreme differences RN(min(blo, bhi) - max(o_lo, o_hi)) and
    RN(max(blo, bhi) - min(o_lo, o_hi)) with i_lo and i_hi, which the
    source proves are the 8 corner products' min and max; elsewhere, and
    where that gives t_lo = 0 (whose sign depends on which zero each min
    and max kept), ``interval_entry``'s own value."""
    inf = float("inf")
    bmn, bmx = torch.minimum(bmin, bmax), torch.maximum(bmin, bmax)
    o_lo, o_hi, i_lo, i_hi = (st[..., c:c + 3] for c in (0, 3, 6, 9))
    omn, omx = torch.minimum(o_lo, o_hi), torch.maximum(o_lo, o_hi)
    t_lo = torch.full(torch.broadcast_shapes(st.shape[:-1], bmin.shape[:-1]),
                      -inf, device=st.device)
    t_hi = -t_lo
    CL = INV_DIR_CLAMP
    for a in range(3):
        dmin = bmn[..., a] - omx[..., a]
        dmax = bmx[..., a] - omn[..., a]
        p = [dd * ic for dd in (dmin, dmax)
             for ic in (i_lo[..., a], i_hi[..., a])]
        lo8 = torch.minimum(torch.minimum(p[0], p[1]),
                            torch.minimum(p[2], p[3]))
        hi8 = torch.maximum(torch.maximum(p[0], p[1]),
                            torch.maximum(p[2], p[3]))
        wide = ((i_hi[..., a] >= CL) | (i_lo[..., a] <= -CL)) \
            & (o_hi[..., a] >= bmin[..., a]) & (o_lo[..., a] <= bmax[..., a])
        t_lo = torch.maximum(t_lo, torch.where(wide, -inf, lo8))
        t_hi = torch.minimum(t_hi, torch.where(wide, inf, hi8))
    e = torch.maximum(t_lo, st[..., 12])
    x = torch.minimum(t_hi, st[..., 13])
    fast = torch.where(e <= x, e, inf)
    oi = st[..., :12]
    stats_ok = torch.isfinite(oi).all(-1) & (oi[..., 6:12] != 0).all(-1) \
        & ~torch.isnan(st[..., 12]) & ~torch.isnan(st[..., 13])
    box_ok = torch.isfinite(bmin).all(-1) & torch.isfinite(bmax).all(-1)
    use = stats_ok & box_ok & (t_lo != 0)
    return torch.where(use, fast, interval_entry(st, bmin, bmax)), use


def phase_a(stats, bounds):
    """Kernel K1 (``csrc/phase_a.cu``): ``phase_a_plain`` computed on the
    card, bit for bit, as ``phase_a_model`` computes it. CPU tensors take
    ``phase_a_plain``; CUDA tensors launch the kernel or raise."""
    if stats.device.type == "cpu":
        return phase_a_plain(stats, bounds)
    _build.require(stats, torch.float32, "stats")
    _build.require(bounds, torch.float32, "bounds", stats.device)
    n_tiles, K = stats.shape[0], bounds.shape[1]
    if stats.shape[1] != 16 or bounds.shape[0] != 6:
        raise ValueError(f"phase_a: stats {tuple(stats.shape)} must be "
                         f"(n_tiles, 16), bounds {tuple(bounds.shape)} (6, K)")
    entry = torch.empty((n_tiles, K), dtype=torch.float32,
                        device=stats.device)
    if n_tiles == 0 or K == 0:
        return entry
    lib = _build.library()
    with torch.cuda.device(stats.device):
        err = lib.raycore_phase_a(stats.data_ptr(), bounds.data_ptr(),
                                  entry.data_ptr(), n_tiles, K,
                                  INV_DIR_CLAMP, _build.stream_ptr(stats))
    _build.check(err, "phase_a")
    phase_a.launches += 1
    return entry


phase_a.launches = 0


def bundle_stats(o, invd, t_min, t_max, n: int):
    """(rows / n, 14) interval stats of the bundles of n consecutive rays,
    ``interval_entry``'s operand: cols o_lo(0:3) o_hi(3:6) i_lo(6:9)
    i_hi(9:12) tmin_lo(12) tmax_hi(13), the ranges of the origins ``o``,
    the inverse directions ``invd`` and the t range. ``invd`` is
    ``safe_invdir`` of directions whose -0 components are turned into +0
    (as ``pad_rays`` turns them), such as ``ray_features``' cols
    ``INVD_COLS``, so that a query inverts each ray set once. Phase A
    takes them over tiles (K1), the refine over subgroups (K7 and the
    packed sub-chunk refine), the instanced engine over the local rays of
    its (subgroup, instance) pairs."""
    b = lambda a: a.reshape((a.shape[0] // n, n) + tuple(a.shape[1:]))
    o_b, i_b = b(o), b(invd)
    return torch.cat([o_b.amin(1), o_b.amax(1), i_b.amin(1), i_b.amax(1),
                      b(t_min).amin(1)[:, None], b(t_max).amax(1)[:, None]],
                     dim=1)


def phase_a_inputs(o, invd, t_min, t_max, bmin, bmax, TILE: int):
    """Kernel K1's operands for the tiles of TILE padded rays against
    (K, 3) boxes: the tiles' ``bundle_stats`` with two zero columns,
    (n_tiles, 16), and the (6, K) bounds [bmin xyz, bmax xyz]."""
    return (torch.nn.functional.pad(bundle_stats(o, invd, t_min, t_max,
                                                 TILE), (0, 2)),
            torch.cat([bmin.T, bmax.T]).contiguous())


def phase_a_entry(o, invd, t_min, t_max, bmin, bmax, TILE: int):
    """Phase A: the (n_tiles, K) entry bounds of the tiles of TILE padded
    rays into (K, 3) boxes, kernel K1 on ``phase_a_inputs``."""
    return phase_a(*phase_a_inputs(o, invd, t_min, t_max, bmin, bmax, TILE))


def compact_indices(flat):
    """Indices of the True flags of a 1-D mask, in ascending order (the
    order of the reference's stable argsort). Syncs for the count."""
    return torch.nonzero(flat).squeeze(1)


def build_worklist(entry):
    """(tids, cids) int32 of every finite-entry pair of the (n_tiles, K)
    entry matrix, row-major (tile-major) order."""
    K = entry.shape[1]
    with span("raycore.wait.worklist"):
        sel = compact_indices(torch.isfinite(entry).reshape(-1))
    return (sel // K).to(torch.int32), (sel % K).to(torch.int32)


def tile_ranges(tids, n_tiles: int):
    """(n_tiles + 1,) int32 offsets of each tile's blocks in a worklist
    sorted by tile: tile t owns blocks [start[t], start[t + 1])."""
    with span("raycore.wait.ranges"):
        counts = torch.bincount(tids.long(), minlength=n_tiles)
    start = torch.zeros(n_tiles + 1, dtype=torch.int32, device=tids.device)
    start[1:] = torch.cumsum(counts, 0)
    return start


def flat_rays(rays):
    """(o, d, t_min, t_max) of a ray batch flattened to rows."""
    nb = len(rays.batch_shape)
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[nb:]))
    return flat(rays.o), flat(rays.d), flat(rays.t_min), flat(rays.t_max)


def pad_rays(o, d, t_min, t_max, TILE: int):
    """Turn -0 directions into +0 and pad the rows to whole tiles with rays
    that never hit (o = 0, d = 1, t_min = 0, t_max = -inf)."""
    d = torch.where(d == 0.0, 0.0, d)
    pad = (-o.shape[0]) % TILE
    if pad:
        ext = lambda a, f: torch.cat(
            [a, torch.full((pad,) + tuple(a.shape[1:]), f, dtype=a.dtype,
                           device=a.device)])
        o, d = ext(o, 0.0), ext(d, 1.0)
        t_min, t_max = ext(t_min, 0.0), ext(t_max, -float("inf"))
    return o, d, t_min.contiguous(), t_max.contiguous()


def _featurized_hits(phi, feats, tmin, tmax):
    """(u, v, t) acceptance of the featurized Möller–Trumbore test for a
    batch of ray tiles against one column block each: phi (n, TILE, 16),
    feats (n, 16, 4*CS) with quantity blocks [det | u*det | v*det | t*det],
    tmin/tmax (n, TILE). Returns (ok, t) of shape (n, TILE, CS)."""
    q = torch.bmm(phi, feats)
    det, udet, vdet, tdet = q.split(feats.shape[2] // 4, dim=2)
    r = 1.0 / det
    u = udet * r
    v = vdet * r
    t = tdet * r
    e = EDGE_EPS
    ok = (u >= -e) & (u <= 1.0 + e) & (v >= -e) & (u + v <= 1.0 + e) \
        & (t >= tmin[..., None]) & (t <= tmax[..., None])
    return ok, t


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def quick_reject(det, udet, vdet, tdet, tmin_nonneg):
    """The division-free reject of K2-K5 (``csrc/featurized.cuh:
    quick_reject``), elementwise on float32 quantities: True where the
    exact epilogue cannot accept. With |det| in REJECT_DET_RANGE and the
    signs of u*det, v*det and t*det turned by det's: u*det or v*det below
    -REJECT_MARGIN |det|, their sum above REJECT_SUM |det|, or t*det
    below -REJECT_MARGIN |det| on a ray with t_min >= 0 (``tmin_nonneg``,
    broadcast against the quantities). NaN, zero, subnormal and huge det
    never reject."""
    dev = det.device
    a = det.abs()
    sign = det.view(torch.int32) & INT32_MIN
    turn = lambda x: (x.view(torch.int32) ^ sign).view(torch.float32)
    su, sv, st = turn(udet), turn(vdet), turn(tdet)
    p = a * _f32(REJECT_MARGIN, dev)
    q = a * _f32(REJECT_SUM, dev)
    lo, hi = REJECT_DET_RANGE
    return (a >= _f32(lo, dev)) & (a <= _f32(hi, dev)) & (
        (su < -p) | (sv < -p) | (su + sv > q) | ((st < -p) & tmin_nonneg))


def kernel_order_quads(phi, feats, rows):
    """(det, u*det, v*det, t*det), each (n, TILE, CS), of ray tiles phi
    (n, TILE, 16) against column blocks feats (n, 16, 4 CS) as the sweep
    kernels chain them: quantity k a chain of fused multiply-adds rounded
    once (``core.triangle.fma``) over ``rows[k]`` ascending, from
    fma(phi_f0, w_f0, 0)."""
    CS = feats.shape[2] // 4
    n, TILE = phi.shape[:2]
    q = []
    for k, rk in enumerate(rows):
        w = feats[:, :, k * CS:(k + 1) * CS]
        acc = torch.zeros((n, TILE, CS), dtype=torch.float32,
                          device=phi.device)
        for f in rk:
            acc = fma(phi[:, :, f, None], w[:, None, f, :], acc)
        q.append(acc)
    return tuple(q)


def exact_epilogue(det, udet, vdet, tdet, tmin, tmax):
    """The kernels' exact acceptance (``csrc/featurized.cuh:mt_accept``):
    the reciprocal of det, u, v and t its products and u + v, each rounded
    once in float32; slack EDGE_EPS, t in [tmin, tmax] (broadcast). Returns
    (ok, t)."""
    r = 1.0 / det
    u, v, t = udet * r, vdet * r, tdet * r
    e = EDGE_EPS
    ok = (u >= -e) & (u <= 1.0 + e) & (v >= -e) & (u + v <= 1.0 + e) \
        & (t >= tmin) & (t <= tmax)
    return ok, t


def kernel_order_hits(phi, feats, tmin, tmax, *, sparse=True):
    """``_featurized_hits`` computed as the sweep kernels K2-K5 compute it,
    bit for bit: ``kernel_order_quads`` over SPARSE_ROWS, where a dead ray
    accepts nothing and ``quick_reject`` runs before ``exact_epilogue``. A
    ray is dead when a feature among rows 0-9 is not finite (a zero
    coefficient the 10-deep chain multiplies turns it into a NaN that
    rejects) or !(tmin <= tmax) (no t lies in its range; K2 and K5 skip
    such rows). ``sparse=False``: over DENSE_ROWS with neither, the
    kernels before their redesign."""
    q = kernel_order_quads(phi, feats, SPARSE_ROWS if sparse else DENSE_ROWS)
    ok, t = exact_epilogue(*q, tmin[..., None], tmax[..., None])
    if sparse:
        live = torch.isfinite(phi[:, :, :10]).all(dim=2) & (tmin <= tmax)
        ok &= live[..., None] & ~quick_reject(*q, (tmin >= 0)[..., None])
    return ok, t


def tile_rows(tiles, TILE: int):
    """Ray rows of the tiles ``tiles`` (int64), tile by tile."""
    return (tiles[:, None] * TILE
            + torch.arange(TILE, device=tiles.device)).reshape(-1)


def _tile_subset(tids, cids, tiles, TILE: int):
    """The blocks of the ascending tile ids ``tiles``, renumbered to
    positions in ``tiles``, and those tiles' ray rows."""
    tiles = tiles.long()
    pos = torch.searchsorted(tiles, tids.long())
    keep = (pos < tiles.numel()) \
        & (tiles[pos.clamp_max(max(tiles.numel() - 1, 0))] == tids.long())
    return (pos[keep].to(torch.int32), cids[keep].contiguous(),
            tile_rows(tiles, TILE))


def _slab_live(phi, sb, tmin, cur_t):
    """Per-ray slab test of ray tiles phi (n, TILE, 16) against one
    sub-chunk box each, sb (n, 6) [min xyz, max xyz], on [tmin, cur_t]. A
    clamped (near-parallel) axis whose origin lies inside the slab widens
    to all t. Returns (n, TILE) bool. Kernel K3 repeats these steps in
    this order."""
    lo, hi = tmin, cur_t
    inf = torch.tensor(float("inf"), device=phi.device)
    for a in range(3):
        o, invd = phi[:, :, 6 + a], phi[:, :, 10 + a]
        bmin, bmax = sb[:, a:a + 1], sb[:, 3 + a:4 + a]
        t0 = (bmin - o) * invd
        t1 = (bmax - o) * invd
        wide = (invd.abs() >= INV_DIR_CLAMP) & (o >= bmin) & (o <= bmax)
        lo = torch.maximum(lo, torch.where(wide, -inf, torch.minimum(t0, t1)))
        hi = torch.minimum(hi, torch.where(wide, inf, torch.maximum(t0, t1)))
    return lo <= hi


def _worklist_rounds(tids, n_tiles: int, TILE: int, C: int):
    """Yield (tiles, blocks) int64 index pairs of a tile-sorted worklist by
    round: round r holds the r-th block of every tile that has one, in
    chunks of at most PLAIN_CHUNK_ELEMS product elements."""
    start = tile_ranges(tids, n_tiles).long()
    counts = start[1:] - start[:-1]
    n_rounds = int(counts.max()) if n_tiles else 0
    step = max(1, PLAIN_CHUNK_ELEMS // (TILE * 4 * C))
    for r in range(n_rounds):
        tiles = torch.nonzero(counts > r).squeeze(1)
        for lo in range(0, tiles.numel(), step):
            t = tiles[lo:lo + step]
            yield t, start[t] + r


def run_worklist_plain(tids, cids, phi, feats, sub_bounds, tmin, key0, pair0,
                       *, TILE: int, C: int, SUB: int):
    """The tile-worklist sweep in plain PyTorch (full float32: run with TF32
    off). Blocks (tids[b], cids[b]) are sorted by tile; each tile's blocks
    run in the given order, the first starting from key0/pair0. Per block
    and sub-chunk s (for SUB > 1 only where some ray of the tile passes
    the slab test against the sub-chunk's box), every lane is tested with
    t <= the t of the key held before the sub-chunk; the smallest packed
    key (t bits with the lane in the low ``_idx_bits(C/SUB)`` bits)
    replaces the held one when it is smaller, with pair cid*C + s*CS +
    lane. Tiles with no block keep key0/pair0. Returns (key, pair) (R,)
    int32. Vectorized over tiles by round (``_worklist_rounds``)."""
    key, pair, _ = worklist_plain_live(tids, cids, phi, feats, sub_bounds,
                                       tmin, key0, pair0, TILE=TILE, C=C,
                                       SUB=SUB)
    return key, pair


def worklist_plain_live(tids, cids, phi, feats, sub_bounds, tmin, key0,
                        pair0, *, TILE: int, C: int, SUB: int,
                        hits=_featurized_hits):
    """``run_worklist_plain``, also returning the number of (block,
    sub-chunk) pairs whose lanes the sweep tests: every one for SUB = 1,
    only those that pass the tile's slab test for SUB > 1. ``hits`` is
    the featurized test. Returns (key, pair, live)."""
    R = phi.shape[0]
    n_tiles = R // TILE
    CS = C // SUB
    bits = _idx_bits(CS)
    mask = (1 << bits) - 1
    key = key0.clone().reshape(n_tiles, TILE)
    pair = pair0.clone().reshape(n_tiles, TILE)
    phi_t = phi.reshape(n_tiles, TILE, FEAT)
    tmin_t = tmin.reshape(n_tiles, TILE)
    lanes = torch.arange(CS, dtype=torch.int32, device=phi.device)
    live_pairs = torch.zeros((), dtype=torch.int64, device=phi.device)
    for t, b in _worklist_rounds(tids, n_tiles, TILE, C):
        cid = cids[b].long()
        ph, tm, fe = phi_t[t], tmin_t[t], feats[cid]
        ck, cp = key[t], pair[t]
        for s in range(SUB):
            cur_t = _t_from_keys(ck, bits)
            ok, tt = hits(ph, fe[:, :, s * 4 * CS:(s + 1) * 4 * CS], tm,
                          cur_t)
            kb = torch.where(tt > 0.0, tt, 0.0).view(torch.int32)
            kmin = torch.where(ok, (kb & ~mask) | lanes, INT32_MAX).amin(2)
            better = kmin < ck
            if SUB > 1:
                live = _slab_live(ph, sub_bounds[cid, 0, s * 6:(s + 1) * 6],
                                  tm, cur_t).any(dim=1)
                better &= live[:, None]
                live_pairs += live.sum()
            else:
                live_pairs += t.numel()
            cand = (cid[:, None] * C + s * CS).to(torch.int32) + (kmin & mask)
            ck = torch.where(better, kmin, ck)
            cp = torch.where(better, cand, cp)
        key[t], pair[t] = ck, cp
    return key.reshape(-1), pair.reshape(-1), int(live_pairs)


def run_worklist_model(tids, cids, phi, feats, sub_bounds, tmin, key0,
                       pair0, *, TILE: int, C: int, SUB: int, tiles=None):
    """``run_worklist_plain`` through ``kernel_order_hits``: K3's bits, on
    the tiles ``tiles`` (ascending int64 ids, all of them when None) with
    all their blocks. Returns (key, pair) of those tiles' rays
    (``tile_rows(tiles, TILE)``)."""
    if tiles is not None:
        tids, cids, rows = _tile_subset(tids, cids, tiles, TILE)
        phi, tmin, key0, pair0 = phi[rows], tmin[rows], key0[rows], \
            pair0[rows]
    key, pair, _ = worklist_plain_live(tids, cids, phi, feats, sub_bounds,
                                       tmin, key0, pair0, TILE=TILE, C=C,
                                       SUB=SUB, hits=kernel_order_hits)
    return key, pair


def _check_worklist_args(name, tids, cids, phi, feats, rows, TILE, C, SUB):
    """Device, type and shape checks shared by the K3 and K4 wrappers.
    ``rows``: the per-ray operands, name -> (tensor, dtype), each (R,)."""
    dev = phi.device
    for arg, (a, dtype) in {"tids": (tids, torch.int32),
                            "cids": (cids, torch.int32),
                            "phi": (phi, torch.float32),
                            "feats": (feats, torch.float32), **rows}.items():
        _build.require(a, dtype, arg, dev)
    R = phi.shape[0]
    if not 0 < TILE <= 1024 or C % SUB or (C // SUB) % 4 or SUB * 6 > 128:
        raise ValueError(f"{name} needs 0 < TILE <= 1024, C/SUB a multiple "
                         f"of 4 and SUB <= 21, got TILE={TILE} C={C} "
                         f"SUB={SUB}")
    if tuple(phi.shape) != (R, FEAT) or R % TILE \
            or tuple(feats.shape[1:]) != (FEAT, 4 * C) \
            or tids.shape != cids.shape or tids.dim() != 1 \
            or any(tuple(a.shape) != (R,) for a, _ in rows.values()):
        raise ValueError(
            f"{name} shapes: phi {tuple(phi.shape)}, feats "
            f"{tuple(feats.shape)}, tids {tuple(tids.shape)}, cids "
            f"{tuple(cids.shape)}, "
            + ", ".join(f"{k} {tuple(a.shape)}" for k, (a, _) in rows.items())
            + f" for TILE={TILE} C={C}")


def run_worklist(tids, cids, phi, feats, sub_bounds, tmin, key0, pair0=None,
                 *, TILE: int, C: int, SUB: int):
    """Kernel K3 (``csrc/worklist_sweep.cu``): ``run_worklist_plain`` on
    the card, one CTA per ray tile walking its blocks in order, the test
    evaluated as ``kernel_order_hits`` does (bit for bit) instead of as a
    matrix product. ``pair0`` defaults to -1. CPU tensors take
    ``run_worklist_plain``; CUDA tensors launch the kernel or raise. Ids
    are not range-checked on the card: ``tids`` must be sorted and below
    R/TILE, ``cids`` below K."""
    if pair0 is None:
        pair0 = torch.full_like(key0, -1)
    if phi.device.type == "cpu":
        return run_worklist_plain(tids, cids, phi, feats, sub_bounds, tmin,
                                  key0, pair0, TILE=TILE, C=C, SUB=SUB)
    _check_worklist_args(
        "worklist sweep", tids, cids, phi, feats,
        {"tmin": (tmin, torch.float32), "key0": (key0, torch.int32),
         "pair0": (pair0, torch.int32)}, TILE, C, SUB)
    _build.require(sub_bounds, torch.float32, "sub_bounds", phi.device)
    if tuple(sub_bounds.shape) != (feats.shape[0], 1, 128):
        raise ValueError(f"worklist sweep: sub_bounds "
                         f"{tuple(sub_bounds.shape)} must be (K, 1, 128)")
    R = phi.shape[0]
    n_tiles = R // TILE
    key = torch.empty_like(key0)
    pair = torch.empty_like(pair0)
    if n_tiles == 0:
        return key, pair
    start = tile_ranges(tids, n_tiles)
    lib = _build.library()
    with torch.cuda.device(phi.device):
        err = lib.raycore_worklist_sweep(
            start.data_ptr(), cids.data_ptr(), phi.data_ptr(),
            feats.data_ptr(), sub_bounds.data_ptr(), tmin.data_ptr(),
            key0.data_ptr(), pair0.data_ptr(), key.data_ptr(),
            pair.data_ptr(), n_tiles, TILE, C, SUB, _idx_bits(C // SUB),
            -EDGE_EPS, 1.0 + EDGE_EPS, INV_DIR_CLAMP, _build.stream_ptr(phi))
    _build.check(err, "worklist_sweep")
    run_worklist.launches += 1
    return key, pair


run_worklist.launches = 0


def run_occlusion_plain(tids, cids, phi, feats, tmin, tmax, *, TILE: int,
                        C: int, SUB: int = 1, hits=_featurized_hits):
    """The tile-worklist occlusion sweep in plain PyTorch (full float32).
    Per ray, the first accepted triangle wins: the smallest lane (in
    triangle order, s*CS + j) of the first block in worklist order whose
    test with t in [tmin, tmax] passes. Returns (R,) int32 occluder pairs
    cid*C + lane, -1 for a free ray. Tiles whose rays are all occluded
    skip the rest of their blocks, which changes no result. ``hits`` is
    the featurized test."""
    R = phi.shape[0]
    n_tiles = R // TILE
    CS = C // SUB
    pair = torch.full((n_tiles, TILE), -1, dtype=torch.int32,
                      device=phi.device)
    phi_t = phi.reshape(n_tiles, TILE, FEAT)
    tmin_t, tmax_t = tmin.reshape(n_tiles, TILE), tmax.reshape(n_tiles, TILE)
    lanes = torch.arange(C, dtype=torch.int32, device=phi.device)
    for t, b in _worklist_rounds(tids, n_tiles, TILE, C):
        cur = pair[t]
        free = (cur < 0).any(dim=1)
        t, b, cur = t[free], b[free], cur[free]
        if not t.numel():
            continue
        cid = cids[b].long()
        # Sub-chunk-major columns -> one (det | udet | vdet | tdet) block
        # per quantity with lanes in triangle order.
        fe = feats[cid].reshape(-1, FEAT, SUB, 4, CS).transpose(2, 3) \
            .reshape(-1, FEAT, 4 * C)
        ok, _ = hits(phi_t[t], fe, tmin_t[t], tmax_t[t])
        lane = torch.where(ok, lanes, C).amin(2)
        pair[t] = torch.where((cur < 0) & (lane < C),
                              cid.to(torch.int32)[:, None] * C + lane, cur)
    return pair.reshape(-1)


def run_occlusion_model(tids, cids, phi, feats, tmin, tmax, *, TILE: int,
                        C: int, SUB: int = 1, tiles=None):
    """``run_occlusion_plain`` through ``kernel_order_hits``: K4's bits, on
    the tiles ``tiles`` (ascending int64 ids, all of them when None) with
    all their blocks. Returns the occluders of those tiles' rays
    (``tile_rows(tiles, TILE)``)."""
    if tiles is not None:
        tids, cids, rows = _tile_subset(tids, cids, tiles, TILE)
        phi, tmin, tmax = phi[rows], tmin[rows], tmax[rows]
    return run_occlusion_plain(tids, cids, phi, feats, tmin, tmax,
                               TILE=TILE, C=C, SUB=SUB,
                               hits=kernel_order_hits)


def run_occlusion(tids, cids, phi, feats, tmin, tmax, *, TILE: int, C: int,
                  SUB: int = 1):
    """Kernel K4 (``csrc/occlusion_sweep.cu``): ``run_occlusion_plain`` on
    the card, one CTA per ray tile, the test evaluated as
    ``kernel_order_hits`` does. CPU tensors take ``run_occlusion_plain``;
    CUDA tensors launch the kernel or raise. Ids are not range-checked on
    the card (see ``run_worklist``)."""
    if phi.device.type == "cpu":
        return run_occlusion_plain(tids, cids, phi, feats, tmin, tmax,
                                   TILE=TILE, C=C, SUB=SUB)
    _check_worklist_args("occlusion sweep", tids, cids, phi, feats,
                         {"tmin": (tmin, torch.float32),
                          "tmax": (tmax, torch.float32)}, TILE, C, SUB)
    R = phi.shape[0]
    n_tiles = R // TILE
    pair = torch.empty(R, dtype=torch.int32, device=phi.device)
    if n_tiles == 0:
        return pair
    start = tile_ranges(tids, n_tiles)
    lib = _build.library()
    with torch.cuda.device(phi.device):
        err = lib.raycore_occlusion_sweep(
            start.data_ptr(), cids.data_ptr(), phi.data_ptr(),
            feats.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            pair.data_ptr(), n_tiles, TILE, C, SUB, -EDGE_EPS,
            1.0 + EDGE_EPS, _build.stream_ptr(phi))
    _build.check(err, "occlusion_sweep")
    run_occlusion.launches += 1
    return pair


run_occlusion.launches = 0


# --- closest hit over the tile worklist -------------------------------------


def _tile_of(rays, tile: int) -> int:
    """The queries' TILE: ``tile``, cut to the batch for small ones."""
    n = 1
    for s in rays.batch_shape:
        n *= s
    return min(tile, max(n, 8))


def _worklist_inputs(scene, o, d, t_min, t_max, TILE: int):
    """Pad to whole tiles and run phase A. Returns (entry, phi, tmin,
    key0, o, d) over the padded rows."""
    o, d, t_min, t_max = pad_rays(o, d, t_min, t_max, TILE)
    phi = ray_features(o, d)
    entry = phase_a_entry(o, phi[:, INVD_COLS], t_min, t_max,
                          scene.cluster_min, scene.cluster_max, TILE)
    bits = _idx_bits(scene.cluster_size // scene.sub_chunks)
    return entry, phi, t_min, _pack_tmax(t_max, bits), o, d


def _sweep(scene, tids, cids, phi, tmin, key0, TILE: int, pair0=None):
    """K3 over a worklist of ``scene``; returns (key, pair)."""
    return run_worklist(tids, cids, phi, scene.tri_feats, scene.sub_bounds,
                        tmin, key0, pair0, TILE=TILE, C=scene.cluster_size,
                        SUB=scene.sub_chunks)


def _untouched_to_miss(entry, key, pair, TILE: int, bits: int):
    """Decode t, and give rows of tiles that no block touches t = inf and
    pair = -1."""
    touched = torch.isfinite(entry).any(dim=1).repeat_interleave(TILE)
    t = torch.where(touched, _t_from_keys(key, bits), float("inf"))
    return t, torch.where(touched, pair, -1)


def _phase_a_and_worklist(scene, o, d, t_min, t_max, *, TILE: int):
    """First half of the auto-sized query: pad, phase A, the exact
    worklist. Returns (tids, cids, phi, tmin, key0, entry, o, d) over the
    padded rows."""
    with span("raycore.stage1"):
        entry, phi, tmin, key0, o, d = _worklist_inputs(scene, o, d, t_min,
                                                        t_max, TILE)
        tids, cids = build_worklist(entry)
        return tids, cids, phi, tmin, key0, entry, o, d


def _sweep_and_finalize(scene, tids, cids, phi, tmin, key0, entry, o, d, *,
                        TILE: int) -> HitResult:
    """Second half: K3 over the whole worklist, then the exact finalize."""
    bits = _idx_bits(scene.cluster_size // scene.sub_chunks)
    with span("raycore.sweep"):
        key, pair = _sweep(scene, tids, cids, phi, tmin, key0, TILE)
    with span("raycore.combine"):
        t, pair = _untouched_to_miss(entry, key, pair, TILE, bits)
    with span("raycore.finalize"):
        return finalize_hits_exact(scene, pair, t, o, d)


def closest_hit_dense_pallas_auto(scene, rays, *, tile: int = 512):
    """Closest hit over the tile worklist, sized exactly from the data (the
    ``nonzero`` of ``build_worklist`` syncs for the count). The dispatch's
    engine for batches under ``REGROUP_MIN_RAYS`` rays and for scenes
    with sub_chunks > 1."""
    batch = rays.batch_shape
    o, d, t_min, t_max = flat_rays(rays)
    R = o.shape[0]
    TILE = _tile_of(rays, tile)
    res = _sweep_and_finalize(
        scene, *_phase_a_and_worklist(scene, o, d, t_min, t_max, TILE=TILE),
        TILE=TILE)
    return res.map(lambda a: a[:R].reshape(batch + tuple(a.shape[1:])))


def _pallas_query(scene, o, d, t_min, t_max, *, TILE: int, max_pairs: int,
                  check_overflow: bool):
    """One pass over every conservative candidate, at most ``max_pairs``
    blocks. Raises on overflow before the sweep when ``check_overflow``;
    otherwise the blocks past the capacity are dropped, as in the
    reference."""
    R0 = o.shape[0]
    tids, cids, phi, tmin, key0, entry, o, d = _phase_a_and_worklist(
        scene, o, d, t_min, t_max, TILE=TILE)
    _capacity(tids.shape[0], max_pairs, check_overflow)
    res = _sweep_and_finalize(scene, tids[:max_pairs], cids[:max_pairs],
                              phi, tmin, key0, entry, o, d, TILE=TILE)
    return res.map(lambda a: a[:R0])


def _capacity(total: int, max_pairs: int, check_overflow: bool) -> None:
    if check_overflow and total > max_pairs:
        raise RuntimeError(
            f"worklist overflow: {total} pairs > capacity {max_pairs}; "
            f"raise max_pairs_per_tile")


def _toppass_worklist(entry, S1: int):
    """Each tile's nearest S1 candidate clusters, nearest first (the first
    index on equal entries), emitted tile-major. Returns (tids, cids,
    remaining entry). As in the reference, a tile with fewer than S1
    candidates may name its lowest candidate again; testing a cluster
    twice changes no result."""
    n_tiles, K = entry.shape
    dev = entry.device
    e = entry.clone()
    rows = torch.arange(n_tiles, device=dev)
    cols = torch.arange(K, device=dev)
    picks = []
    for _ in range(S1):
        m = e.amin(dim=1, keepdim=True)
        cid = torch.where(e == m, cols, K).amin(dim=1)
        picks.append(cid)
        e[rows, cid] = float("inf")
    cids = torch.stack(picks, dim=1)                       # (n_tiles, S1)
    valid = torch.isfinite(entry.gather(1, cids))
    tids = rows[:, None].expand(n_tiles, S1)
    return (tids[valid].to(torch.int32), cids[valid].to(torch.int32), e)


def _pallas_query2(scene, o, d, t_min, t_max, *, TILE: int, max_pairs: int,
                   S1: int, check_overflow: bool):
    """Two-pass pruned query: each tile's nearest S1 clusters first, then
    only the candidates whose entry can still beat the tile's worst best
    t, seeded with pass 1's keys and pairs."""
    R0 = o.shape[0]
    entry, phi, tmin, key0, o, d = _worklist_inputs(scene, o, d, t_min,
                                                    t_max, TILE)
    bits = _idx_bits(scene.cluster_size // scene.sub_chunks)
    tids1, cids1, rest = _toppass_worklist(entry, S1)
    key, pair = _sweep(scene, tids1, cids1, phi, tmin, key0, TILE)
    worst = _t_from_keys(key, bits).reshape(-1, TILE).amax(dim=1)
    tids2, cids2 = build_worklist(
        torch.where(rest < worst[:, None], rest, float("inf")))
    _capacity(tids2.shape[0], max_pairs, check_overflow)
    key, pair = _sweep(scene, tids2[:max_pairs], cids2[:max_pairs], phi,
                       tmin, key, TILE, pair0=pair)
    return finalize_hits_exact(scene, pair[:R0], _t_from_keys(key, bits)[:R0],
                               o[:R0], d[:R0])


def closest_hit_dense_pallas(scene, rays, *, tile: int = 256,
                             max_pairs_per_tile: int = 24,
                             check_overflow: bool = True, passes: int = 2,
                             nearest_first: int = 4):
    """Closest hit over a tile worklist of fixed capacity,
    ``max_pairs_per_tile`` blocks per tile.

    passes=2 (default): each tile's ``nearest_first`` nearest clusters
    first, then only the candidates whose entry can still beat a found
    hit. passes=1 tests every candidate. A worklist past the capacity
    raises ``RuntimeError`` unless ``check_overflow=False``, which drops
    the blocks past it."""
    if passes not in (1, 2):
        raise ValueError(f"passes must be 1 or 2, got {passes!r}")
    batch = rays.batch_shape
    o, d, t_min, t_max = flat_rays(rays)
    TILE = _tile_of(rays, tile)
    n_tiles = -(-o.shape[0] // TILE)
    max_pairs = min(max_pairs_per_tile * n_tiles, n_tiles * scene.n_clusters)
    if passes == 2:
        res = _pallas_query2(scene, o, d, t_min, t_max, TILE=TILE,
                             max_pairs=max_pairs, S1=nearest_first,
                             check_overflow=check_overflow)
    else:
        res = _pallas_query(scene, o, d, t_min, t_max, TILE=TILE,
                            max_pairs=max_pairs,
                            check_overflow=check_overflow)
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))


def _topk_query(scene, o, d, t_min, t_max, *, TILE: int, cap: int):
    R0 = o.shape[0]
    entry, phi, tmin, key0, o, d = _worklist_inputs(scene, o, d, t_min,
                                                    t_max, TILE)
    bits = _idx_bits(scene.cluster_size // scene.sub_chunks)
    tids, cids, _ = _toppass_worklist(entry, cap)
    key, pair = _sweep(scene, tids, cids, phi, tmin, key0, TILE)
    t, pair = _untouched_to_miss(entry, key, pair, TILE, bits)
    return finalize_hits_exact(scene, pair[:R0], t[:R0], o[:R0], d[:R0])


def closest_hit_dense_pallas_topk(scene, rays, *, tile: int = 512,
                                  cap: int = 48):
    """Each tile tests only its ``cap`` nearest candidate clusters. Exact
    when no tile has more than ``cap`` candidates (always when the scene
    has at most ``cap`` clusters); otherwise a nearest-first
    approximation."""
    batch = rays.batch_shape
    o, d, t_min, t_max = flat_rays(rays)
    res = _topk_query(scene, o, d, t_min, t_max, TILE=_tile_of(rays, tile),
                      cap=min(cap, scene.n_clusters))
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))


# --- occlusion over the tile worklist ---------------------------------------


def _occl_phase_a(scene, o, d, t_min, t_max, *, TILE: int):
    """Pad, phase A and the worklist of the occlusion query. Returns
    (tids, cids, phi, tmin, tmax) over the padded rows."""
    with span("raycore.stage1"):
        o, d, t_min, t_max = pad_rays(o, d, t_min, t_max, TILE)
        phi = ray_features(o, d)
        entry = phase_a_entry(o, phi[:, INVD_COLS], t_min, t_max,
                              scene.cluster_min, scene.cluster_max, TILE)
        tids, cids = build_worklist(entry)
        return tids, cids, phi, t_min, t_max


def _occl_finalize(scene, tids, cids, phi, tmin, tmax, *, TILE: int,
                   R0: int) -> HitResult:
    """K4, then the payload-free result of the first R0 rows."""
    with span("raycore.sweep"):
        pair = run_occlusion(tids, cids, phi, scene.tri_feats, tmin, tmax,
                             TILE=TILE, C=scene.cluster_size,
                             SUB=scene.sub_chunks)
    with span("raycore.finalize"):
        return prim_only_hits(scene, pair[:R0])


def any_hit_dense_pallas_auto(scene, rays, *, tile: int = 512):
    """Occlusion over the tile worklist: the first accepted triangle in
    worklist order wins, tested against the ray's own t_max; t_min is
    forced to 0. Only hit, prim_idx and instance_idx are contractual;
    t, barycentric and the triangle are zeros."""
    batch = rays.batch_shape
    o, d, t_min, t_max = flat_rays(rays)
    TILE = _tile_of(rays, tile)
    res = _occl_finalize(
        scene, *_occl_phase_a(scene, o, d, torch.zeros_like(t_min), t_max,
                              TILE=TILE), TILE=TILE, R0=o.shape[0])
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))
