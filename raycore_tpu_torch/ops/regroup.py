"""Cluster-major regrouped sweep, the closest-hit main path (counterpart of
``raycore_tpu/ops/pallas_regroup.py``, partial).

  1. Phase A (ops/dense.py, kernel K1) culls (ray tile, cluster) pairs.
     Compacting the transposed entry matrix lists the surviving pairs
     cluster-major.
  2. Kernel K7 (``refine_pairs``, ``csrc/refine_pairs.cu``) refines each
     pair against the tile's TILE/G subgroups of G rays with the same
     interval test on per-subgroup stats.
  3. The surviving (subgroup, cluster) pairs stay cluster-major, so blocks
     of SPB subgroups that need the same cluster pack by rank arithmetic.
  4. Kernel K2 (``run_regrouped``, ``csrc/regroup_sweep.cu``) tests every
     block's SPB*G rays against its cluster's C triangles and writes one
     (t-bits key, prim) per row.
  5. A grouped segment-min merges each ray's rows (one per candidate
     cluster), and the exact finalize recomputes the winner's payload.

The ordered multiwave (``passes`` >= 2) sweeps each subgroup's passes - 1
nearest clusters first (a wave grid on K2), prunes the other pairs
against the best t that sweep found, sweeps what is left (a remainder
grid on K2) and merges the two results per ray.

The packed sub-cluster sweep (``closest_hit_packed``) refines each
surviving (subgroup, cluster) pair further, against the AABBs of the
cluster's SUBC sub-chunks of C/SUBC triangles, and kernel K5
(``run_packed``, ``csrc/packed_sweep.cu``) sweeps blocks of subgroups
that share a sub-cluster. Dispatch takes it for large batches on scenes
with sub_chunks >= 2.

Before phase A the driver looks at the order of the rays
(``_swept_batch``): where neighbouring rays change direction octant (the
three sign bits of d > 0) more than 7 times (``octant_gate``), it sweeps
the batch stably sorted by octant and puts the answers back in the
caller's order. A subgroup of G rays or a tile of phase A that mixes
octants has an interval of inverse directions that spans 0, so the
interval tests cull almost nothing for it (a renderer's shadow rays
toward two lights drawn per ray; a camera's rays in pixel order, whose
tiles of whole rows straddle the image's centre line). A batch in octant
order, or in at most 8 runs of one octant, changes octant at most 7
times, mixes at most 7 tiles and 7 subgroups, and is swept as given, for
the cost of one count and its readback. Each ray's answer is the least
(t key, prim) over the triangles that pass the exact test in the
clusters the conservative cull keeps, so it does not depend on the
order.

The same look, in the same readback, finds the dead lanes, which can
accept no hit (t_max < t_min, or a NaN bound: a renderer's finished
paths and their shadow rays). They are cut before phase A: the live
lanes are swept alone, sorted by octant with the dead ones last where
the gate engages or a dead lane comes before a live one, else as given
(live lanes first, as a compacted batch has them), on tiles sized from
the live count. A dead lane keeps the miss, the answer the sweep gave
it; a live lane's answer is the same, since leaving dead rays out of a
subgroup only narrows its bundle and drops clusters no live ray enters.

The block grids are sized exactly from the data (a host sync on each
compaction and one ``.item()`` on each block count); nothing is sized by
a capacity guess. Only the compact stage 1 is ported; every payload
("full", "slim" and any_hit's "occlusion") takes it, at any ``passes``.

Tracing: each stage runs in a profiler span (``utils/config.py:span``),
``raycore.stage1``, ``raycore.refine`` (nested in it), ``raycore.sweep``
(nested in stage 1 for the multiwave's wave grid), ``raycore.combine``
and ``raycore.finalize``; the octant order in ``raycore.reorder`` spans:
the gate's count (its readback in ``raycore.wait.octants``) with the sort
and gathers where it engages, and the way back to the caller's order;
each host sync in a ``raycore.wait.<site>`` span.
``pack_presorted_cluster_major`` counts the grid's subgroup slots and the
filled ones (``slots``, ``filled``), ``refine_pairs`` the (pair,
subgroup) entries it refined and those its callers kept (``tested``,
``kept``), ``octant_gate`` the queries it saw, those it ordered, the
octant changes between live lanes it found and the dead lanes it cut
(``checked``, ``engaged``, ``boundaries``, ``dead``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.dense import (FEAT, INVD_COLS, depth_layers,
                           finalize_hits_exact, prim_only_hits, ray_features)
from ..core.triangle import INV_DIR_CLAMP
from ..kernels import _build
from ..utils.config import span
from .dense import (EDGE_EPS, INT32_MAX, PLAIN_CHUNK_ELEMS, _featurized_hits,
                    _t_from_keys, build_worklist, bundle_stats,
                    compact_indices, flat_rays, interval_entry,
                    interval_entry_paths, kernel_order_hits, pad_rays,
                    phase_a_entry)

PAYLOADS = ("full", "slim", "occlusion")

# Ray-table layout: ray_features cols 0:13 (d, o x d, o, 1, invd) plus
# t_min in col 13 and t_max in col 14. Triangle feature rows 13/14 are
# zero, so the extra columns never reach the product.
COL_TMIN = 13
COL_TMAX = 14
# Lanes of a sub-cluster slice that K5 stages at a time (a slice of at
# most this many lanes is staged whole).
LANE_CHUNK = 64


def ray_table(o, d, t_min, t_max, G: int):
    """(n_sub + 1, G, FEAT) per-subgroup ray table; the trailing dummy
    subgroup (zeros, t_max = -inf) never hits."""
    R = o.shape[0]
    phi = ray_features(o, d)
    phi[:, COL_TMIN] = t_min
    phi[:, COL_TMAX] = t_max
    dummy = torch.zeros((1, G, FEAT), dtype=torch.float32, device=o.device)
    dummy[:, :, COL_TMAX] = -float("inf")
    return torch.cat([phi.reshape(R // G, G, FEAT), dummy])


def table_invd(tbl):
    """The inverse directions of a ray table's rays, one row a ray (the
    dummy subgroup left out): ``bundle_stats``' operand, read from the
    table so that a query inverts its rays once."""
    return tbl[:-1].reshape(-1, FEAT)[:, INVD_COLS]


def _refine_operands(stats, tids, cids, cluster_min, cluster_max, SPT: int,
                     n_tiles: int):
    """Each pair's SPT subgroup stats (P, SPT, 14) and its box (P, 1, 3)
    twice, min and max, as ``interval_entry`` takes them."""
    P = tids.shape[0]
    st = stats.reshape(n_tiles, SPT * 14)[tids.long()].reshape(P, SPT, 14)
    return (st, cluster_min[cids.long()][:, None],
            cluster_max[cids.long()][:, None])


def refine_pairs_plain(stats, tids, cids, cluster_min, cluster_max,
                       SPT: int, n_tiles: int):
    """Interval-test each (tile, cluster) pair against the tile's SPT
    subgroups. Returns (P, SPT) conservative entry bounds, +inf where
    provably no ray of the subgroup enters the cluster."""
    return interval_entry(*_refine_operands(stats, tids, cids, cluster_min,
                                            cluster_max, SPT, n_tiles))


def refine_pairs_model(stats, tids, cids, cluster_min, cluster_max,
                       SPT: int, n_tiles: int):
    """``refine_pairs_plain`` computed as kernel K7 computes it, bit for
    bit (``ops/dense.py:interval_entry_paths`` on the same operands)."""
    return interval_entry_paths(*_refine_operands(
        stats, tids, cids, cluster_min, cluster_max, SPT, n_tiles))[0]


def refine_pairs(stats, tids, cids, cluster_min, cluster_max, SPT: int,
                 n_tiles: int):
    """Kernel K7 (``csrc/refine_pairs.cu``): ``refine_pairs_plain`` on the
    card, one thread an entry, bit for bit as ``refine_pairs_model``
    computes it. CPU tensors take ``refine_pairs_plain``; CUDA tensors
    launch the kernel or raise. Ids are not range-checked on the card:
    ``tids`` must be below ``n_tiles`` and ``cids`` below the box count
    (phase A's worklist produces them so). Runs in a ``raycore.refine``
    span and adds P*SPT to the counter ``tested``; its callers add the
    finite entries they keep to ``kept``."""
    P = tids.shape[0]
    refine_pairs.tested += P * SPT
    with span("raycore.refine"):
        if stats.device.type == "cpu":
            return refine_pairs_plain(stats, tids, cids, cluster_min,
                                      cluster_max, SPT, n_tiles)
        dev = stats.device
        _build.require(stats, torch.float32, "stats")
        for name, t in (("tids", tids), ("cids", cids)):
            _build.require(t, torch.int32, name, dev)
        _build.require(cluster_min, torch.float32, "cluster_min", dev)
        _build.require(cluster_max, torch.float32, "cluster_max", dev)
        if stats.shape != (n_tiles * SPT, 14) or cids.shape != (P,) \
                or tids.dim() != 1 or cluster_min.dim() != 2 \
                or cluster_min.shape[1] != 3 \
                or cluster_max.shape != cluster_min.shape:
            raise ValueError(
                f"refine_pairs shapes: stats {tuple(stats.shape)} for "
                f"n_tiles={n_tiles} SPT={SPT}, tids {tuple(tids.shape)}, "
                f"cids {tuple(cids.shape)}, cluster_min "
                f"{tuple(cluster_min.shape)}, cluster_max "
                f"{tuple(cluster_max.shape)}")
        if P * SPT > INT32_MAX:
            raise ValueError(f"refine_pairs: {P} pairs x SPT {SPT} entries "
                             f"pass int32")
        entry = torch.empty((P, SPT), dtype=torch.float32, device=dev)
        if P == 0:
            return entry
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.raycore_refine_pairs(
                stats.data_ptr(), tids.data_ptr(), cids.data_ptr(),
                cluster_min.data_ptr(), cluster_max.data_ptr(),
                entry.data_ptr(), P, SPT, INV_DIR_CLAMP,
                _build.stream_ptr(stats))
        _build.check(err, "refine_pairs")
        refine_pairs.launches += 1
        return entry


refine_pairs.launches = 0
refine_pairs.tested = 0
refine_pairs.kept = 0


def pack_presorted_cluster_major(cid_s, sub_s, *, SPB: int, n_sub: int):
    """Pack a cluster-contiguous (cid, sub) list into blocks of SPB
    subgroups by rank arithmetic, no sort: equal cids must be adjacent.
    Returns (block_cid (B,), block_subs (B, SPB)) int32; slots past a
    cluster's last subgroup point at the dummy subgroup ``n_sub``. Adds
    B*SPB to the counter ``slots`` and N to ``filled``: their ratio is the
    share of the sweep's rows that hold a pair."""
    N = sub_s.shape[0]
    dev = sub_s.device
    i = torch.arange(N, dtype=torch.int64, device=dev)
    boundary = torch.ones(N, dtype=torch.bool, device=dev)
    boundary[1:] = cid_s[1:] != cid_s[:-1]
    first = torch.cummax(torch.where(boundary, i, 0), dim=0).values \
        if N else i
    rank = i - first
    slot = rank % SPB
    block_id = torch.cumsum((slot == 0).to(torch.int64), 0) - 1
    with span("raycore.wait.blocks"):
        total = int(block_id[-1].item()) + 1 if N else 0   # the block count
    pack_presorted_cluster_major.slots += total * SPB
    pack_presorted_cluster_major.filled += N
    block_cid = torch.empty(total, dtype=torch.int32, device=dev)
    block_cid[block_id] = cid_s.to(torch.int32)   # one value per block
    block_subs = torch.full((total, SPB), n_sub, dtype=torch.int32,
                            device=dev)
    block_subs[block_id, slot] = sub_s.to(torch.int32)
    return block_cid, block_subs


pack_presorted_cluster_major.slots = 0
pack_presorted_cluster_major.filled = 0


def group_flat_cluster_major(sub, cid, valid, *, SPB: int, n_sub: int):
    """Pack flat (subgroup, cluster) candidates into cluster-major blocks
    of SPB subgroups: the valid candidates in the order of a stable sort
    of ``where(valid, cid, K)`` (K the cluster count, so the invalid sort
    last), cut by ``pack_presorted_cluster_major``. They are compacted
    before the sort (one host sync for their count), which gives that
    order on a shorter sort, so the JAX signature's K is not needed.
    Returns (block_cid (B,), block_subs (B, SPB)) with B the exact block
    count; slots past a cluster's last subgroup point at ``n_sub``.

    The JAX package sorts unstably (``is_stable=False``), so its order of
    blocks within a cluster is not defined. In the prim payload that
    order changes nothing. In the pairrow payload it decides which of two
    exactly tied (instance, prim) winners has the smaller pair id, and so
    which the grouped combine keeps."""
    with span("raycore.wait.candidates"):
        keep = compact_indices(valid)
    cid_v, sub_v = cid[keep], sub[keep]
    order = torch.sort(cid_v, stable=True).indices
    return pack_presorted_cluster_major(cid_v[order], sub_v[order], SPB=SPB,
                                        n_sub=n_sub)


# The payloads of the regroup sweep K2: "prim" writes cid*C + lane,
# "pairrow" (b*SPB + row//G)*C + lane with b the block's index in the grid.
SWEEP_PAYLOADS = ("prim", "pairrow")


def check_sweep_payload(payload: str, n_blocks: int, SPB: int, C: int):
    """Raise ValueError for an unknown payload, or in the pairrow mode
    when the largest payload, n_blocks*SPB*C - 1, does not fit int32 (the
    JAX package has the same limit and does not check it)."""
    if payload not in SWEEP_PAYLOADS:
        raise ValueError(f"payload must be one of {SWEEP_PAYLOADS}, got "
                         f"{payload!r}")
    if payload == "pairrow" and n_blocks * SPB * C > 1 << 31:
        raise ValueError(
            f"pairrow payload out of int32 range: {n_blocks} blocks x SPB "
            f"{SPB} x C {C} = {n_blocks * SPB * C} pair ids > 2^31")


def run_regrouped_plain(block_subs, block_cid, tbl, feats, *, G: int,
                        SPB: int, C: int, payload: str = "prim"):
    """Sweep every block with a gathered ``torch.bmm`` (full float32: run
    with TF32 off). Returns (key, pair) of shape (n_blocks*SPB*G,) in
    block-row order: key is the int32 bits of max(t, 0) of the row's
    closest accepted triangle (INT32_MAX on a miss), pair is cid*C + lane
    ("prim") or (b*SPB + row//G)*C + lane ("pairrow", b the block's index)
    with the smallest lane on ties (-1 on a miss). Blocks with cid < 0
    write the miss sentinels. Blocks go through in chunks of at most
    PLAIN_CHUNK_ELEMS product elements. The packed sweep at one sub-chunk
    per cluster."""
    check_sweep_payload(payload, block_cid.shape[0], SPB, C)
    return run_packed_plain(block_subs, block_cid, tbl, feats, G=G,
                            SPB_sub=SPB, C_eff=C, SUBC=1, payload=payload)


def run_packed_plain(block_subs, block_cid, tbl, feats, *, G: int,
                     SPB_sub: int, C_eff: int, SUBC: int,
                     hits=_featurized_hits, payload: str = "prim",
                     block_ids=None):
    """The packed sub-cluster sweep in plain PyTorch: block b's SPB_sub*G
    rows against the C_eff triangles of sub-cluster q = block_cid[b] =
    cluster*SUBC + s, which are columns [s*4*C_eff, (s+1)*4*C_eff) of
    ``feats[cluster]`` in the sub-chunk-major layout. Returns (key, pair)
    as ``run_regrouped_plain`` does, with pair q*C_eff + lane (the
    triangle's slot cluster*C + s*C_eff + lane); blocks with q < 0 write
    the miss sentinels. ``hits`` is the featurized test (``torch.bmm`` by
    default), given each row's t_min and t_max. payload="pairrow" (K2's
    mode, SUBC = 1) writes (b*SPB_sub + row//G)*C_eff + lane instead, with
    b the block's index in the grid: ``block_ids`` (int64, one a block)
    when the blocks are a subset of a grid, else their position."""
    ROWS = G * SPB_sub
    n_blocks = block_cid.shape[0]
    dev = tbl.device
    K = feats.shape[0]
    slices = feats.view(K, FEAT, SUBC, 4 * C_eff)
    keys = torch.empty(n_blocks * ROWS, dtype=torch.int32, device=dev)
    pairs = torch.empty(n_blocks * ROWS, dtype=torch.int32, device=dev)
    step = max(1, PLAIN_CHUNK_ELEMS // (ROWS * 4 * C_eff))
    lanes = torch.arange(C_eff, dtype=torch.int32, device=dev)
    imax = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
    if block_ids is None:
        block_ids = torch.arange(n_blocks, dtype=torch.int64, device=dev)
    slot = torch.arange(ROWS, dtype=torch.int64, device=dev) // G
    for lo in range(0, n_blocks, step):
        cid = block_cid[lo:lo + step]
        n = cid.shape[0]
        rows = tbl[block_subs[lo:lo + step].long()].reshape(n, ROWS, FEAT)
        # Zero the t-range carrier columns for the product: their feature
        # rows are zero, but inf * 0 would be NaN.
        phi = rows.clone()
        phi[:, :, COL_TMIN:] = 0.0
        qc = cid.clamp_min(0).long()
        ok, t = hits(phi, slices[qc // SUBC, :, qc % SUBC],
                     rows[:, :, COL_TMIN], rows[:, :, COL_TMAX])
        kb = torch.where(t > 0.0, t, 0.0).view(torch.int32)
        kb = torch.where(ok, kb, imax)
        key_min = kb.amin(dim=2, keepdim=True)                # (n, ROWS, 1)
        lane = torch.where(kb == key_min, lanes, C_eff).amin(dim=2)
        key_min = key_min[:, :, 0]
        valid = (cid >= 0)[:, None]
        if payload == "pairrow":
            base = (block_ids[lo:lo + n, None] * SPB_sub + slot) * C_eff
        else:
            base = cid[:, None] * C_eff
        pair = torch.where(key_min == INT32_MAX, -1,
                           (base + lane).to(torch.int32))
        keys[lo * ROWS:(lo + n) * ROWS] = \
            torch.where(valid, key_min, imax).reshape(-1)
        pairs[lo * ROWS:(lo + n) * ROWS] = \
            torch.where(valid, pair, -1).reshape(-1)
    return keys, pairs


def run_packed_model(block_subs, block_cid, tbl, feats, *, G: int,
                     SPB_sub: int, C_eff: int, SUBC: int, blocks=None,
                     payload: str = "prim"):
    """``run_packed_plain`` through ``kernel_order_hits``: K5's bits (and
    K2's at SUBC = 1), on the blocks ``blocks`` (int64 ids, all of them
    when None). Returns (key, pair) of those blocks' rows
    (``tile_rows(blocks, SPB_sub*G)``); a pairrow payload names each block
    by its index in the whole grid."""
    ids = blocks
    if blocks is not None:
        block_subs, block_cid = block_subs[blocks], block_cid[blocks]
    return run_packed_plain(block_subs, block_cid, tbl, feats, G=G,
                            SPB_sub=SPB_sub, C_eff=C_eff, SUBC=SUBC,
                            hits=kernel_order_hits, payload=payload,
                            block_ids=ids)


def run_regrouped_model(block_subs, block_cid, tbl, feats, *, G: int,
                        SPB: int, C: int, blocks=None, payload: str = "prim"):
    """``run_regrouped_plain`` through ``kernel_order_hits``: K2's bits,
    on the blocks ``blocks`` (all of them when None)."""
    check_sweep_payload(payload, block_cid.shape[0], SPB, C)
    return run_packed_model(block_subs, block_cid, tbl, feats, G=G,
                            SPB_sub=SPB, C_eff=C, SUBC=1, blocks=blocks,
                            payload=payload)


def _sweep_outputs(what, block_subs, block_cid, tbl, feats, *, G: int,
                   SPB: int, PACKS: int, C_eff: int, SUBC: int):
    """Check the card inputs of a closest-hit sweep kernel, K2 (PACKS =
    SUBC = 1, C_eff = C) or K5: int32 ids and float32 tables, contiguous,
    16-byte aligned and on one card; PACKS*SPB*G <= 1024 threads, C_eff %
    4 == 0 and matching shapes. Returns the empty (key, pair) outputs, one
    int32 row per ray row of every block."""
    dev = tbl.device
    _build.require(block_subs, torch.int32, "block_subs", dev)
    _build.require(block_cid, torch.int32, "block_cid", dev)
    _build.require(tbl, torch.float32, "tbl", dev)
    _build.require(feats, torch.float32, "feats", dev)
    n_blocks = block_cid.shape[0]
    if PACKS * SPB * G > 1024 or C_eff % 4:
        raise ValueError(
            f"{what} needs PACKS*SPB*G <= 1024 and C_eff % 4 == 0, got "
            f"PACKS={PACKS} SPB={SPB} G={G} C_eff={C_eff}")
    if tuple(block_subs.shape) != (n_blocks, SPB) \
            or tuple(tbl.shape[1:]) != (G, FEAT) \
            or tuple(feats.shape[1:]) != (FEAT, 4 * C_eff * SUBC):
        raise ValueError(
            f"{what} shapes: block_subs {tuple(block_subs.shape)}, tbl "
            f"{tuple(tbl.shape)}, feats {tuple(feats.shape)} for "
            f"n_blocks={n_blocks} G={G} SPB={SPB} C_eff={C_eff} SUBC={SUBC}")
    keys = torch.empty(n_blocks * G * SPB, dtype=torch.int32, device=dev)
    return keys, torch.empty_like(keys)


def run_regrouped(block_subs, block_cid, tbl, feats, *, G: int, SPB: int,
                  C: int, payload: str = "prim"):
    """Kernel K2 (``csrc/regroup_sweep.cu``): ``run_regrouped_plain`` on
    the card, the test evaluated as ``run_regrouped_model`` does (bit for
    bit) instead of as a matrix product. CPU tensors take
    ``run_regrouped_plain``; CUDA tensors launch the kernel or raise. Ids
    are not range-checked on the card: ``block_subs`` must index rows of
    ``tbl`` and ``block_cid`` must be below K (stage 1 produces them
    so). ``payload`` as in ``run_regrouped_plain``; a pairrow grid whose
    pair ids would pass int32 raises ValueError on either device."""
    check_sweep_payload(payload, block_cid.shape[0], SPB, C)
    if tbl.device.type == "cpu":
        return run_regrouped_plain(block_subs, block_cid, tbl, feats, G=G,
                                   SPB=SPB, C=C, payload=payload)
    keys, pairs = _sweep_outputs("regroup sweep", block_subs, block_cid, tbl,
                                 feats, G=G, SPB=SPB, PACKS=1, C_eff=C,
                                 SUBC=1)
    n_blocks = block_cid.shape[0]
    if n_blocks == 0:
        return keys, pairs
    lib = _build.library()
    with torch.cuda.device(tbl.device):
        err = lib.raycore_regroup_sweep(
            block_subs.data_ptr(), block_cid.data_ptr(), tbl.data_ptr(),
            feats.data_ptr(), keys.data_ptr(), pairs.data_ptr(), n_blocks,
            G, SPB, C, int(payload == "pairrow"), -EDGE_EPS, 1.0 + EDGE_EPS,
            _build.stream_ptr(tbl))
    _build.check(err, "regroup_sweep")
    run_regrouped.launches += 1
    return keys, pairs


run_regrouped.launches = 0


def run_packed(block_subs, block_cid, tbl, feats, *, G: int, SPB_sub: int,
               PACKS: int, C_eff: int, SUBC: int,
               lane_chunk: int = LANE_CHUNK):
    """Kernel K5 (``csrc/packed_sweep.cu``): ``run_packed_plain`` on the
    card, one CTA per PACKS consecutive sub-blocks, each slice staged
    ``lane_chunk`` lanes at a time, the test evaluated as
    ``run_packed_model`` does (bit for bit). The block count need not be a
    multiple of PACKS. CPU tensors take ``run_packed_plain``; CUDA tensors
    launch the kernel or raise. Ids are not range-checked on the card:
    ``block_subs`` must index rows of ``tbl`` and ``block_cid`` must be
    below K*SUBC."""
    if tbl.device.type == "cpu":
        return run_packed_plain(block_subs, block_cid, tbl, feats, G=G,
                                SPB_sub=SPB_sub, C_eff=C_eff, SUBC=SUBC)
    keys, pairs = _sweep_outputs("packed sweep", block_subs, block_cid, tbl,
                                 feats, G=G, SPB=SPB_sub, PACKS=PACKS,
                                 C_eff=C_eff, SUBC=SUBC)
    n_blocks = block_cid.shape[0]
    if n_blocks == 0:
        return keys, pairs
    lib = _build.library()
    with torch.cuda.device(tbl.device):
        err = lib.raycore_packed_sweep(
            block_subs.data_ptr(), block_cid.data_ptr(), tbl.data_ptr(),
            feats.data_ptr(), keys.data_ptr(), pairs.data_ptr(), n_blocks,
            G, SPB_sub, PACKS, C_eff, SUBC, lane_chunk, -EDGE_EPS,
            1.0 + EDGE_EPS, _build.stream_ptr(tbl))
    _build.check(err, "packed_sweep")
    run_packed.launches += 1
    return keys, pairs


run_packed.launches = 0


def combine_rows_grouped(keys, pairs, block_subs, G: int, SPB: int,
                         n_sub: int):
    """Merge per-(subgroup, cluster) result rows into per-ray bests: a
    segment min of the keys over subgroup ids, then a segment min of the
    pairs among the rows that reach that key (the smallest pair wins a
    tie). Min does not depend on order, so no sort is needed. Returns
    per-ray (key, pair) of shape (n_sub*G,)."""
    n_rows = block_subs.numel()
    kr = keys.reshape(n_rows, G)
    pr = pairs.reshape(n_rows, G)
    subs = block_subs.reshape(n_rows).long()
    idx = subs[:, None].expand(n_rows, G)
    dev = keys.device
    ident = lambda: torch.full((n_sub + 1, G), INT32_MAX, dtype=torch.int32,
                               device=dev)
    kk = ident().scatter_reduce(0, idx, kr, "amin")
    tied = kr == kk[subs]
    pp = ident().scatter_reduce(0, idx, torch.where(tied, pr, INT32_MAX),
                                "amin")
    pp = torch.where(pp == INT32_MAX, -1, pp)
    return kk[:n_sub].reshape(-1), pp[:n_sub].reshape(-1)


def refine_worklist(stats, tids, cids, bmin, bmax, SPT: int, n_tiles: int):
    """The subgroup refine (K7) of a coarse worklist of (tile, box) pairs
    and an order-preserving compaction of its finite entries. Returns
    (sub, box, entry): the subgroup ids, box ids and refined entry bounds
    (all finite) of the kept (subgroup, box) pairs, in the worklist's
    order and each pair's subgroups in order. Adds their count to
    ``refine_pairs.kept``. The caller orders the worklist: cluster-major
    for the dense engines' rank pack, tile-major for the instanced
    engine, whose pair ids (positions in this list) decide exactly tied
    winners (``group_flat_cluster_major``)."""
    fine = refine_pairs(stats, tids, cids, bmin, bmax, SPT,
                        n_tiles).reshape(-1)
    with span("raycore.wait.refine"):
        sel = compact_indices(torch.isfinite(fine))
    refine_pairs.kept += sel.shape[0]
    spt = torch.arange(SPT, dtype=torch.int32, device=tids.device)
    sub = (tids[:, None] * SPT + spt).reshape(-1)
    box = cids[:, None].expand(-1, SPT).reshape(-1)
    return sub[sel], box[sel], fine[sel]


def subgroup_pairs(scene, o, invd, t_min, t_max, TILE, G):
    """The dense engines' stage-1 front end on padded rays and their
    inverse directions (``bundle_stats``): phase A on the scene's
    clusters, the compaction of the transposed entry matrix (so the
    coarse worklist comes out cluster-major), then ``refine_worklist``.
    Returns (P, sub, cid, entry, stats): the coarse pair count; the kept
    (subgroup, cluster) pairs, cluster-major; the (n_sub, 14) subgroup
    stats."""
    entry = phase_a_entry(o, invd, t_min, t_max, scene.cluster_min,
                          scene.cluster_max, TILE)
    cids, tids = build_worklist(entry.T)
    stats = bundle_stats(o, invd, t_min, t_max, G)
    return (tids.shape[0],
            *refine_worklist(stats, tids, cids, scene.cluster_min,
                             scene.cluster_max, TILE // G, o.shape[0] // TILE),
            stats)


def wave_select(entry, sub, cid, waves: int, n_sub: int, K: int):
    """The ordered waves' choice: per subgroup, ``waves`` rounds of a
    segment min over its (subgroup, cluster) pairs. A round takes the
    smallest finite entry, the smallest cluster id among equal entries,
    and sets the chosen pair's entry to +inf before the next round.
    Returns (chosen, entry_w): (n_sub, waves) int32 cluster ids, K where
    a subgroup has no candidate left, and the entries with +inf at every
    chosen pair. ``scatter_reduce("amin")`` as in
    ``combine_rows_grouped``: a min does not depend on order."""
    dev = entry.device
    s = sub.long()
    chosen = []
    for _ in range(waves):
        fin = torch.isfinite(entry)
        e = torch.where(fin, entry, 3e38)
        emin = torch.full((n_sub + 1,), float("inf"), device=dev) \
            .scatter_reduce(0, s, e, "amin")
        tied = fin & (e == emin[s])
        csel = torch.full((n_sub + 1,), K, dtype=torch.int32, device=dev) \
            .scatter_reduce(0, s, torch.where(tied, cid, K), "amin")
        chosen.append(csel[:n_sub])
        entry = torch.where(cid == csel[s], float("inf"), entry)
    return torch.stack(chosen, dim=1), entry


@dataclasses.dataclass
class WaveSweep:
    """What the ordered waves leave for stage 2 (and for checks): per-ray
    (k1, p1) of the wave sweep after the grouped combine, the wave grid,
    each subgroup's chosen clusters (``wave_select``) and its bound
    ``ub``, the largest t1 of its rays."""

    k1: torch.Tensor          # (n_sub*G,) int32
    p1: torch.Tensor          # (n_sub*G,) int32
    block_cid: torch.Tensor   # (B1,) int32
    block_subs: torch.Tensor  # (B1, SPB) int32
    chosen: torch.Tensor      # (n_sub, W) int32, K where none
    ub: torch.Tensor          # (n_sub,) float32


def _stage1_cm_core(scene, o, d, t_min, t_max, TILE, G, SPB, waves=0):
    """Sort-free stage 1: the ray table, ``subgroup_pairs`` on the
    scene's clusters (cluster-major), then the rank pack.
    Returns (block_cid, block_subs, tbl, counts) with counts (coarse
    pairs, subgroup pairs, blocks).

    ``waves`` = W > 0 is the ordered multiwave (passes = W + 1): each
    subgroup's W nearest clusters (``wave_select``) are swept first, in
    one grid, and the rest of its pairs are kept only where their entry
    is at most the largest best t of its G rays after that sweep, ``ub``
    (+inf where one of them has no hit yet). The prune is conservative:
    a cluster that no ray can enter before its current best hit cannot
    improve it. It only drops pairs, so the kept ones stay cluster-major
    and pack by rank. Returns (block_cid, block_subs, tbl, counts, wave)
    then: the remainder grid, counts (coarse pairs, subgroup pairs,
    remainder pairs, remainder blocks, wave pairs, wave blocks) and
    ``wave`` a ``WaveSweep``."""
    with span("raycore.stage1"):
        n_sub = o.shape[0] // G
        tbl = ray_table(o, d, t_min, t_max, G)
        P, sub, cid, entry, _ = subgroup_pairs(
            scene, o, table_invd(tbl), t_min, t_max, TILE, G)
        if waves == 0:
            block_cid, block_subs = pack_presorted_cluster_major(
                cid, sub, SPB=SPB, n_sub=n_sub)
            return block_cid, block_subs, tbl, (P, sub.shape[0],
                                                block_cid.shape[0])
        K = scene.n_clusters
        chosen, entry_w = wave_select(entry, sub, cid, waves, n_sub, K)
        # The wave grid: the chosen pairs, made cluster-contiguous by a
        # stable sort. The order of blocks changes no result: K2 computes
        # each row alone and the combine is a min.
        flat = chosen.reshape(-1)
        with span("raycore.wait.wave"):
            pick = compact_indices(flat < K)
        order = torch.sort(flat[pick], stable=True).indices
        wsub = (pick // waves).to(torch.int32)[order]
        bc1, bs1 = pack_presorted_cluster_major(flat[pick][order], wsub,
                                                SPB=SPB, n_sub=n_sub)
        with span("raycore.sweep"):
            k1r, p1r = run_regrouped(bs1, bc1, tbl, scene.tri_feats, G=G,
                                     SPB=SPB, C=scene.cluster_size)
        k1, p1 = combine_rows_grouped(k1r, p1r, bs1, G, SPB, n_sub)
        t1 = torch.where(k1 == INT32_MAX, float("inf"),
                         _t_from_keys(k1, 0))
        ub = t1.reshape(n_sub, G).amax(dim=1)
        # The chosen pairs carry +inf; the finite test keeps them out of
        # the remainder where ub is +inf too (ROADMAP Q7).
        with span("raycore.wait.prune"):
            keep = compact_indices(torch.isfinite(entry_w)
                                   & (entry_w <= ub[sub.long()]))
        block_cid, block_subs = pack_presorted_cluster_major(
            cid[keep], sub[keep], SPB=SPB, n_sub=n_sub)
        counts = (P, sub.shape[0], keep.shape[0], block_cid.shape[0],
                  pick.shape[0], bc1.shape[0])
        return block_cid, block_subs, tbl, counts, WaveSweep(
            k1=k1, p1=p1, block_cid=bc1, block_subs=bs1, chosen=chosen,
            ub=ub)


def merge_pass1(key, pair, k1, p1):
    """Merge the wave sweep's per-ray (k1, p1) into the remainder's (key,
    pair), the JAX package's rule: the wave's result wins on a smaller
    key, and on an equal key where it names a triangle and the remainder
    names none or a larger one."""
    better1 = (k1 < key) | ((k1 == key) & (p1 >= 0)
                            & ((p1 < pair) | (pair < 0)))
    return torch.where(better1, k1, key), torch.where(better1, p1, pair)


def _stage2_core(scene, block_cid, block_subs, tbl, o, d, G, SPB, R_pad,
                 payload: str = "full", wave: WaveSweep | None = None,
                 order=None, caller=None):
    """Sweep, grouped combine, the merge of the wave sweep's results
    (``wave``, passes >= 2) and finalize. ``o``/``d`` are the unpadded
    rays as swept; ``R_pad`` is the padded ray count. ``order`` and
    ``caller``: ``_swept_batch``'s, where given; the winners go back to
    the caller's lanes (``_in_caller_lanes``) and the finalize takes the
    caller's rays."""
    R = o.shape[0]
    n_sub = R_pad // G
    with span("raycore.sweep"):
        key, pair = run_regrouped(block_subs, block_cid, tbl,
                                  scene.tri_feats, G=G, SPB=SPB,
                                  C=scene.cluster_size)
    with span("raycore.combine"):
        out_key, out_pair = combine_rows_grouped(key, pair, block_subs, G,
                                                 SPB, n_sub)
        if wave is not None:
            out_key, out_pair = merge_pass1(out_key, out_pair, wave.k1,
                                            wave.p1)
    key, pair = out_key[:R], out_pair[:R]
    if caller is not None:
        o, d = caller
        if order is not None or R < o.shape[0]:
            with span("raycore.reorder"):
                key, pair = _in_caller_lanes(key, pair, order, o.shape[0])
    with span("raycore.finalize"):
        return _finalize(scene, key, pair, o, d, payload)


def _in_caller_lanes(key, pair, order, R0: int):
    """The swept rays' winners (key, pair) in the caller's R0 lanes: swept
    ray i's in lane ``order[i]`` (lane i where ``order`` is None; the
    padding's entries of ``order`` are not read), the miss (INT32_MAX,
    -1) in every lane not swept."""
    def back(a, miss):
        if order is None:
            return torch.cat([a, a.new_full((R0 - a.shape[0],), miss)])
        return a.new_full((R0,), miss).index_copy_(0, order[:a.shape[0]],
                                                   a)
    return back(key, INT32_MAX), back(pair, -1)


def _finalize(scene, key, pair, o, d, payload: str):
    """The result of each ray's winning (key, pair) in ``payload``."""
    if payload == "slim":
        # Exact hit, t (the full-precision winning key), prim, instance and
        # metadata; zero triangle and barycentric.
        return prim_only_hits(scene, pair, t=_t_from_keys(key, 0),
                              metadata=True)
    if payload == "occlusion":
        # any_hit's contract: hit, occluder prim and instance only.
        return prim_only_hits(scene, pair)
    return finalize_hits_exact(scene, pair, _t_from_keys(key, 0), o, d)


def _tile_sizes(R: int, tile: int, subgroup: int):
    """(G, TILE) for a sweep of R rays: subgroups of ``subgroup`` rays
    (fewer, a power of two from 8, for a small batch) and tiles of
    ``tile`` rays (fewer for a small batch), a whole number of
    subgroups."""
    G = min(subgroup, max(8, 1 << (max(R, 1) - 1).bit_length()))
    TILE = min(tile, max(R, G))
    return G, -(-TILE // G) * G


def _padded_batch(rays, tile: int, subgroup: int):
    """Flatten a batch, turn -0 directions into +0 and pad it to whole
    tiles with rays that never hit (d = 1, t_max = -inf). Returns
    (o, d, t_min, t_max, R0, G, TILE)."""
    o, d, t_min, t_max = flat_rays(rays)
    R0 = o.shape[0]
    G, TILE = _tile_sizes(R0, tile, subgroup)
    return (*pad_rays(o, d, t_min, t_max, TILE), R0, G, TILE)


# Octant changes between neighbouring rays in a batch in octant order: at
# most one at each boundary between the 8 octants.
OCTANT_BOUNDARIES = 7


def octant_keys(d):
    """Each ray's direction octant, the three sign bits of d > 0, as
    uint8 (R,)."""
    pos = (d > 0).view(torch.uint8)
    return torch.add(torch.add(pos[:, 0], pos[:, 1], alpha=2), pos[:, 2],
                     alpha=4)


def live_lanes(t_min, t_max):
    """The lanes that can accept a hit: t_max >= t_min. A lane with t_max
    below t_min, or a NaN bound, is dead (the sweeps accept t in [t_min,
    t_max])."""
    return t_max >= t_min


def octant_gate(octant, live):
    """Whether the live lanes (``live`` (R,) bool) of a flat batch, with
    direction octants ``octant`` (R,), must be reordered before the
    sweep, and how many are live. They must where a dead lane comes
    before a live one, or where neighbouring live lanes change octant
    more than ``OCTANT_BOUNDARIES`` times, so that more than 7 of their
    tiles or subgroups may mix octants. One host sync reads the three
    counts. Returns (engaged, live lanes); adds 1 to the counter
    ``checked``, the changes found to ``boundaries``, the dead lanes to
    ``dead`` and, where it engages, 1 to ``engaged``."""
    changes = (octant[1:] != octant[:-1]) & live[1:] & live[:-1]
    rises = live[1:] & ~live[:-1]
    with span("raycore.wait.octants"):
        n, n_rises, n_live = torch.stack(
            [changes.sum(), rises.sum(), live.sum()]).tolist()
    octant_gate.checked += 1
    octant_gate.boundaries += n
    octant_gate.dead += octant.shape[0] - n_live
    engaged = n_rises > 0 or n > OCTANT_BOUNDARIES
    octant_gate.engaged += engaged
    return engaged, n_live


octant_gate.checked = 0
octant_gate.engaged = 0
octant_gate.boundaries = 0
octant_gate.dead = 0


def _swept_batch(rays, tile: int, subgroup: int):
    """The regrouped driver's operands: the live lanes of
    ``_padded_batch``'s rays (``live_lanes``), stably sorted by direction
    octant where ``octant_gate`` engages, each octant in the caller's
    order, else as given; where a lane is dead, padded anew to whole
    tiles of a G and TILE chosen from the live count. Returns (o, d,
    t_min, t_max, R, G, TILE, order, caller): R swept rays before the
    padding, ``order[i]`` the caller's index of swept ray i, or None
    where swept ray i is the caller's ray i; ``caller`` the caller's
    (o, d) with -0 directions turned into +0, for the finalize. The
    padding (d = 1, the last octant, dead) stays last."""
    o, d, t_min, t_max, R0, G, TILE = _padded_batch(rays, tile, subgroup)
    caller = o[:R0], d[:R0]
    order = None
    with span("raycore.reorder"):
        octant = octant_keys(d)
        live = live_lanes(t_min, t_max)
        engaged, R = octant_gate(octant[:R0], live[:R0])
        if R < R0:
            # Dead lanes sort last (key 8) and are cut.
            if engaged:
                order = torch.sort(torch.where(live, octant, 8),
                                   stable=True).indices[:R]
                o, d, t_min, t_max = (a[order] for a in (o, d, t_min, t_max))
            else:
                o, d, t_min, t_max = (a[:R] for a in (o, d, t_min, t_max))
            G, TILE = _tile_sizes(R, tile, subgroup)
            o, d, t_min, t_max = pad_rays(o, d, t_min, t_max, TILE)
        elif engaged:
            order = torch.sort(octant, stable=True).indices
            o, d, t_min, t_max = (a[order] for a in (o, d, t_min, t_max))
    return o, d, t_min, t_max, R, G, TILE, order, caller


def _closest_hit_regrouped_cm(scene, rays, *, tile: int, subgroup: int,
                              spb: int, payload: str = "full",
                              passes: int = 1):
    """Compact-stage-1 driver: pad the flat batch to whole tiles, sweep a
    batch whose rays change direction octant more than 7 times stably
    sorted by octant (``_swept_batch``), put each ray's winner back in
    the caller's order before the finalize, restore the batch shape. Each
    ray's answer is the least (t key, prim) over the triangles that pass
    the exact test in the clusters the conservative cull keeps, so the
    order changes which clusters are swept, never an answer. Dead lanes
    (``live_lanes``) are not swept: each keeps the miss, the answer the
    sweep gives it. Dropping them from a subgroup only narrows its
    bundle, which drops clusters no live ray enters. Where every lane is
    dead, nothing is launched."""
    batch = rays.batch_shape
    o, d, t_min, t_max, R, G, TILE, order, caller = _swept_batch(
        rays, tile, subgroup)
    if R == 0:
        key, pair = _in_caller_lanes(o.new_empty(0, dtype=torch.int32),
                                     o.new_empty(0, dtype=torch.int32),
                                     None, caller[0].shape[0])
        with span("raycore.finalize"):
            res = _finalize(scene, key, pair, *caller, payload)
    else:
        block_cid, block_subs, tbl, *rest = _stage1_cm_core(
            scene, o, d, t_min, t_max, TILE, G, spb, waves=passes - 1)
        wave = rest[1] if passes > 1 else None
        res = _stage2_core(scene, block_cid, block_subs, tbl, o[:R], d[:R],
                           G, spb, o.shape[0], payload, wave, order, caller)
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))


# depth_layers at or above which passes="auto" takes the multiwave.
AUTO_DEPTH_LAYERS = 1.6
AUTO_PASSES = 4


def auto_passes(scene) -> int:
    """passes="auto": AUTO_PASSES on a depth-complex scene (the cluster
    AABBs form at least AUTO_DEPTH_LAYERS disjoint depth layers,
    ``accel/dense.py:depth_layers``), else 1. A host statistic cached on
    the scene."""
    return AUTO_PASSES if depth_layers(scene) >= AUTO_DEPTH_LAYERS else 1


def resolve_passes(scene, passes) -> int:
    """``passes`` as an int >= 1: "auto" through ``auto_passes``; any
    other value that is not an int >= 1 raises ValueError."""
    if passes == "auto":
        return auto_passes(scene)
    if isinstance(passes, bool) or not isinstance(passes, int) \
            or passes < 1:
        raise ValueError(f"passes must be an int >= 1 or 'auto', got "
                         f"{passes!r}")
    return passes


def closest_hit_regrouped(scene, rays, *, tile: int = 512, subgroup: int = 32,
                          spb: int = 16, passes=1, payload: str = "full"):
    """Exact closest hit via the cluster-major regrouped sweep.

    payload: "full" gathers the winning triangle and returns the exact
    (t, barycentric, triangle) payload; "slim" returns the same exact
    hit/t/prim_idx/instance_idx/metadata with a zero triangle and
    barycentric; "occlusion" is ``any_hit_regrouped``'s mode: hit, prim
    and instance only.

    passes: 1 sweeps every refined candidate; N >= 2 is the ordered
    multiwave, which sweeps each subgroup's N - 1 nearest clusters first
    and prunes the rest against the best t found (``_stage1_cm_core``);
    "auto" resolves through ``auto_passes``. The results do not depend on
    it. The default is 1, as ``docs/engines.md`` documents (the JAX
    package's signature says 2).

    A batch whose neighbouring rays change direction octant more than 7
    times, so that its tiles or subgroups of ``subgroup`` rays may mix
    octants, is swept stably sorted by octant and answered in the
    caller's order (``_swept_batch``); the answers do not depend on the
    order. Lanes with t_max < t_min are not swept and miss."""
    if scene.sub_chunks != 1:
        raise ValueError("regrouped engine requires sub_chunks=1 scenes")
    passes = resolve_passes(scene, passes)
    if payload not in PAYLOADS:
        raise ValueError(f"payload must be one of {PAYLOADS}, got {payload}")
    return _closest_hit_regrouped_cm(scene, rays, tile=tile,
                                     subgroup=subgroup, spb=spb,
                                     payload=payload, passes=passes)


def any_hit_regrouped(scene, rays, *, tile: int = 2048, subgroup: int = 32,
                      spb: int = 16):
    """Occlusion via the regrouped sweep: the closest-hit candidates and
    sweep with t_min forced to 0, so the occluder is the nearest hit in
    [0, t_max]. Only hit, prim_idx and instance_idx are contractual; t,
    barycentric and the triangle are zeros. A batch that mixes direction
    octants (shadow rays toward several lights) is swept in octant order,
    as ``closest_hit_regrouped`` says."""
    rays0 = dataclasses.replace(rays, t_min=torch.zeros_like(rays.t_min))
    return closest_hit_regrouped(scene, rays0, tile=tile, subgroup=subgroup,
                                 spb=spb, payload="occlusion")


# --- packed sub-cluster sweep -----------------------------------------------


def subchunk_bounds(scene):
    """(K*SUBC, 3) sub-chunk AABB mins and maxes unpacked from
    ``scene.sub_bounds``; row q = cluster*SUBC + s."""
    K = scene.n_clusters
    SUBC = scene.sub_chunks
    sb = scene.sub_bounds[:, 0, :SUBC * 6].reshape(K, SUBC, 6)
    return (sb[:, :, 0:3].reshape(K * SUBC, 3),
            sb[:, :, 3:6].reshape(K * SUBC, 3))


def _stage1_packed_core(scene, o, d, t_min, t_max, TILE, G, SPB_sub):
    """Stage 1 of the packed sweep: ``subgroup_pairs``, then each
    surviving (subgroup, cluster) pair expands to its SUBC sub-clusters,
    each refined against its sub-chunk AABB. A stable sort on the
    sub-cluster id makes equal ids adjacent (within a sub-cluster the
    subgroups keep their cluster-major order), and the rank pack cuts
    blocks of SPB_sub subgroups. Returns (block_cid, block_subs, tbl,
    counts) with block_cid the sub-cluster id and counts (coarse pairs,
    subgroup pairs, sub-cluster pairs, blocks)."""
    with span("raycore.stage1"):
        SUBC = scene.sub_chunks
        n_sub = o.shape[0] // G
        dev = o.device
        tbl = ray_table(o, d, t_min, t_max, G)
        P, qsub, qcid, _, stats = subgroup_pairs(
            scene, o, table_invd(tbl), t_min, t_max, TILE, G)     # (Q,)
        Q = qsub.shape[0]

        sbmin, sbmax = subchunk_bounds(scene)
        crow = (qcid[:, None] * SUBC
                + torch.arange(SUBC, dtype=torch.int32,
                               device=dev)[None, :])
        cr = crow.long()
        e2 = interval_entry(stats[qsub.long()][:, None, :], sbmin[cr],
                            sbmax[cr])                         # (Q, SUBC)
        with span("raycore.wait.subchunks"):
            keep = compact_indices(torch.isfinite(e2).reshape(-1))
        q = crow.reshape(-1)[keep]
        s = qsub[:, None].expand(Q, SUBC).reshape(-1)[keep]
        order = torch.sort(q, stable=True).indices
        block_cid, block_subs = pack_presorted_cluster_major(
            q[order], s[order], SPB=SPB_sub, n_sub=n_sub)
        counts = (P, Q, keep.shape[0], block_cid.shape[0])
        return block_cid, block_subs, tbl, counts


def _stage2_packed_core(scene, block_cid, block_subs, tbl, o, d, G,
                        SPB_sub, PACKS):
    """K5, the grouped combine and the exact finalize. ``o``/``d`` are
    the unpadded rays."""
    R = o.shape[0]
    with span("raycore.sweep"):
        key, pair = run_packed(block_subs, block_cid, tbl, scene.tri_feats,
                               G=G, SPB_sub=SPB_sub, PACKS=PACKS,
                               C_eff=scene.cluster_size
                               // scene.sub_chunks,
                               SUBC=scene.sub_chunks)
    with span("raycore.combine"):
        out_key, out_pair = combine_rows_grouped(key, pair, block_subs, G,
                                                 SPB_sub, tbl.shape[0] - 1)
    with span("raycore.finalize"):
        # The keys are full t bits, not the worklist's truncated keys.
        t = _t_from_keys(out_key[:R], 0)
        return finalize_hits_exact(scene, out_pair[:R], t, o, d)


def closest_hit_packed(scene, rays, *, tile: int = 2048, subgroup: int = 32,
                       spb_sub: int = 2, packs: int = 8):
    """Exact closest hit via the packed sub-cluster sweep: candidates are
    (G-ray subgroup, sub-cluster of C/SUBC triangles) pairs, swept in
    sub-blocks of ``spb_sub`` subgroups that share a sub-cluster (kernel
    K5). A scene with sub_chunks = 1 runs at cluster granularity
    (C_eff = C). The full payload is returned.

    ``packs`` only sets how many sub-blocks one CTA of K5 takes (on the
    TPU it was the depth of the block-diagonal product); the results do
    not depend on it. The grid is sized exactly from the data, so there
    is no capacity option."""
    batch = rays.batch_shape
    o, d, t_min, t_max, R0, G, TILE = _padded_batch(rays, tile, subgroup)
    block_cid, block_subs, tbl, _ = _stage1_packed_core(
        scene, o, d, t_min, t_max, TILE, G, spb_sub)
    res = _stage2_packed_core(scene, block_cid, block_subs, tbl, o[:R0],
                              d[:R0], G, spb_sub, packs)
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))
