"""Card probe P4: ablations of the regroup sweep's per-block cost
(counterpart of ``tools/probe_block_overhead.py``).

Kernel ``csrc/block_probe.cu`` runs a K2-style block on synthetic data:
SPB subgroups of G rows gathered from a ray table, the featurized product
against one cluster's (16, 4C) table (C = 128), and the tool's epilogue.
Its variants take the block apart:

  full        gather + product + epilogue (the production block)
  contig_tbl  the rows read contiguously instead of gathered
  mm_only     gather + product; the epilogue reduced to one column
  no_matmul   gather + epilogue on a cheap elementwise stand-in for q

and ``full`` at SPB 8, 16 and 32 shows how the fixed cost per block
amortizes. On the card the blocks run in parallel, so µs per block is a
throughput, comparable with K2's time over its block count.

The kernel divides only where ``uv_may_pass``, a division-free test of
u's and v's numerators against det, says the pair may pass; elsewhere
the exact u or v clause must fail. ``run_block_model`` is the plain
version routed through that test, as the kernel runs it, with the count
of pairs it refuses.

    python -m raycore_tpu_torch.tools.probe_block_overhead [n_blocks]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.device import default_device
from ..core.triangle import fma
from ..kernels import _build
from ..ops.dense import FEAT, INT32_MAX, INT32_MIN, _f32
from ..ops.regroup import COL_TMAX, COL_TMIN
from ._common import EPS, ONE_EPS, best_ms, launch

VARIANTS = ("full", "contig_tbl", "mm_only", "no_matmul")
C = 128
# The tool's sizes: subgroups in the ray table, rows per subgroup, clusters.
N_SUB = 32768
G0 = 32
K_CLUSTERS = 8192
# The tool's rows: (variant, G, SPB).
CONFIGS = (("full", 32, 16), ("contig_tbl", 32, 16), ("mm_only", 32, 16),
           ("no_matmul", 32, 16), ("full", 32, 8), ("full", 32, 32))
# Blocks per step of the plain version (bounds its float64 temporaries).
PLAIN_BLOCKS = 64


def _up(x):
    """The least float32 at or above the float64 ``x``."""
    f = np.float32(x)
    return float(f if float(f) >= x else np.nextafter(f, np.float32(np.inf)))


# The pre-test's margins (csrc/fma_block.cuh:uv_may_pass states why they
# are safe): the float32 values just above e and 1 + e, and the least
# float32 at or above M_HI + e (v has no clause of its own above; u + v <=
# 1 + e with u >= -e bounds it).
M_LO = float(np.nextafter(np.float32(EPS), np.float32(np.inf)))
M_HI = float(np.nextafter(np.float32(ONE_EPS), np.float32(np.inf)))
M_V = _up(M_HI + EPS)


def _rows(variant, G, SPB, subs, tbl, tbl_contig, n_blocks):
    if variant == "contig_tbl":
        return tbl_contig.reshape(n_blocks, G * SPB, FEAT)
    return tbl[subs.long().view(n_blocks, SPB)].reshape(n_blocks, G * SPB,
                                                          FEAT)


def _products(variant, rows, F):
    """(det | udet | vdet | tdet) of a batch of blocks, (nb, ROWS, 4C):
    ``rows`` (nb, ROWS, 16), ``F`` the blocks' feature tables (nb, 16,
    4C)."""
    if variant == "no_matmul":
        return rows[:, :, :1] + F[:, :1, :]
    # The kernel's 13-step fused multiply-add chain, emulated exactly.
    q = torch.zeros(rows.shape[:2] + (F.shape[2],), dtype=torch.float32,
                    device=rows.device)
    for f in range(COL_TMIN):
        q = fma(rows[:, :, f:f + 1], F[:, f:f + 1, :], q)
    return q


def _accept(q, rows, divided=None):
    """The tool's epilogue on products ``q``: (key, lane) a row. With
    ``divided`` (a mask of pairs), a pair outside it is refused."""
    det = q[..., :C]
    u, v, t = (q[..., i * C:(i + 1) * C] / det for i in (1, 2, 3))
    ok = (u >= -EPS) & (u <= ONE_EPS) & (v >= -EPS) & (u + v <= ONE_EPS) \
        & (t >= rows[:, :, COL_TMIN:COL_TMIN + 1]) \
        & (t <= rows[:, :, COL_TMAX:COL_TMAX + 1])
    if divided is not None:
        ok &= divided
    kb = torch.where(t > 0, t, 0.0).view(torch.int32)
    kb = torch.where(ok, kb, INT32_MAX)
    key = kb.min(-1).values
    # The smallest lane that attains the minimum (0 when nothing hit).
    lane = (kb == key[..., None]).int().argmax(-1).to(torch.int32)
    return key, lane


def _mm_only(q):
    return q[:, :, 0].contiguous().view(torch.int32), \
        torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)


def _block_plain(variant, rows, F):
    """(key, lane) of a batch of blocks: ``rows`` (nb, ROWS, 16), ``F`` the
    blocks' feature tables (nb, 16, 4C)."""
    q = _products(variant, rows, F)
    return _mm_only(q) if variant == "mm_only" else _accept(q, rows)


def uv_may_pass(det, udet, vdet):
    """The kernel's division-free pre-test, elementwise on float32 det and
    u's and v's numerators: with a = |det| and su, sv the numerators with
    det's sign turned into their own, a pair may pass only where -(a M_LO)
    <= su <= a M_HI and -(a M_LO) <= sv <= a M_V, each product rounded.
    False only where the pair must fail the tool's clauses u >= -e, u <= 1
    + e, v >= -e and u + v <= 1 + e on the IEEE quotients u = udet / det
    and v = vdet / det, NaN included."""
    a = det.abs()
    sign = det.view(torch.int32) & INT32_MIN
    su = (udet.view(torch.int32) ^ sign).view(torch.float32)
    sv = (vdet.view(torch.int32) ^ sign).view(torch.float32)
    lo = -(a * _f32(M_LO, det.device))
    return (su >= lo) & (su <= a * _f32(M_HI, det.device)) & (sv >= lo) \
        & (sv <= a * _f32(M_V, det.device))


def _block_model(variant, rows, F):
    """``_block_plain`` as the kernel runs it: the division and the clauses
    only where ``uv_may_pass``; also the count of pairs it refuses."""
    q = _products(variant, rows, F)
    if variant == "mm_only":
        return (*_mm_only(q), 0)
    may = uv_may_pass(q[..., :C], q[..., C:2 * C], q[..., 2 * C:3 * C])
    return (*_accept(q, rows, may), int((~may).sum()))


def _by_chunks(block_fn, variant, G, SPB, subs, cids, tbl, feats,
               tbl_contig):
    """``block_fn`` over the blocks, PLAIN_BLOCKS at a time: (key, lane),
    each (n_blocks * G * SPB, 1), and the sum of any further outputs."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    n_blocks = cids.shape[0]
    keys, lanes, extra = [], [], 0
    for lo in range(0, n_blocks, PLAIN_BLOCKS):
        hi = min(lo + PLAIN_BLOCKS, n_blocks)
        rows = _rows(variant, G, SPB, subs[lo * SPB:hi * SPB], tbl,
                     None if tbl_contig is None else tbl_contig[lo:hi],
                     hi - lo)
        k, la, *more = block_fn(variant, rows,
                                feats[cids[lo:hi].long().clamp_min(0)])
        keys.append(k.reshape(-1, 1))
        lanes.append(la.reshape(-1, 1))
        extra += sum(more)
    empty = torch.zeros((0, 1), dtype=torch.int32, device=cids.device)
    return (torch.cat(keys) if keys else empty,
            torch.cat(lanes) if lanes else empty), extra


def run_block_plain(variant, G, SPB, subs, cids, tbl, feats, tbl_contig=None):
    """The probe block's (key, lane), each (n_blocks * G * SPB, 1) int32, in
    plain PyTorch: the 13-deep dot as the kernel's fused multiply-add chain
    (``core.triangle.fma``), then the tool's epilogue with IEEE division."""
    return _by_chunks(_block_plain, variant, G, SPB, subs, cids, tbl, feats,
                      tbl_contig)[0]


def run_block_model(variant, G, SPB, subs, cids, tbl, feats,
                    tbl_contig=None):
    """``run_block_plain`` routed through the kernel's pre-test: ((key,
    lane), refused), ``refused`` the number of (row, lane) pairs whose
    division the kernel skips (0 for mm_only). Equal to
    ``run_block_plain`` wherever ``uv_may_pass`` is safe."""
    return _by_chunks(_block_model, variant, G, SPB, subs, cids, tbl, feats,
                      tbl_contig)


def run_block(variant, G, SPB, subs, cids, tbl, feats, tbl_contig=None):
    """Kernel P4 (``csrc/block_probe.cu``): ``run_block_plain`` on the card,
    bit for bit, by persistent CTAs that each walk their share of the
    blocks. CPU tensors take ``run_block_plain``; CUDA tensors launch the
    kernel or raise. Ids are not range-checked on the card: ``subs`` must
    index subgroups of ``tbl`` and ``cids`` be below the number of feature
    tables."""
    if cids.device.type == "cpu":
        return run_block_plain(variant, G, SPB, subs, cids, tbl, feats,
                               tbl_contig)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    dev = cids.device
    rows_tbl = tbl_contig if variant == "contig_tbl" else tbl
    for name, x, dtype in (("subs", subs, torch.int32),
                           ("cids", cids, torch.int32),
                           ("tbl", rows_tbl, torch.float32),
                           ("feats", feats, torch.float32)):
        if x is None:
            raise ValueError(f"block probe {variant}: {name} is missing")
        _build.require(x, dtype, name, dev)
    n_blocks, ROWS = cids.shape[0], G * SPB
    want_tbl = (n_blocks, ROWS, FEAT) if variant == "contig_tbl" \
        else (rows_tbl.shape[0], G, FEAT)
    if ROWS > 1024 or subs.shape != (n_blocks * SPB,) \
            or tuple(rows_tbl.shape) != want_tbl \
            or tuple(feats.shape[1:]) != (FEAT, 4 * C):
        raise ValueError(
            f"block probe shapes: subs {tuple(subs.shape)}, cids "
            f"{tuple(cids.shape)}, tbl {tuple(rows_tbl.shape)}, feats "
            f"{tuple(feats.shape)} for G={G} SPB={SPB} (G*SPB <= 1024, "
            f"C={C})")
    key = torch.empty((n_blocks * ROWS, 1), dtype=torch.int32, device=dev)
    lane = torch.empty_like(key)
    if n_blocks == 0:
        return key, lane
    launch("block_probe", dev, subs.data_ptr(), cids.data_ptr(),
           rows_tbl.data_ptr(), feats.data_ptr(), key.data_ptr(),
           lane.data_ptr(), n_blocks, G, SPB, C, VARIANTS.index(variant),
           EPS, ONE_EPS)
    run_block.launches += 1
    return key, lane


run_block.launches = 0


def make_inputs(n_sub=N_SUB, K=K_CLUSTERS, device=None, seed=0):
    """The tool's tables: a normal (n_sub + 1, G0, 16) float32 ray table and
    K normal (16, 4C) float32 feature tables, made on ``device`` (the card
    by default) from a torch generator seeded with ``seed``."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tbl = torch.randn((n_sub + 1, G0, FEAT), generator=gen, device=dev)
    feats = torch.randn((K, FEAT, 4 * C), generator=gen, device=dev)
    return tbl, feats, gen


def block_ids(n_blocks, SPB, n_sub, K, gen):
    """The tool's ids for one row: ``n_blocks * SPB`` random subgroups and
    cluster ``b % K`` for block b."""
    dev = gen.device
    subs = torch.randint(0, n_sub, (n_blocks * SPB,), generator=gen,
                         device=dev, dtype=torch.int32)
    cids = (torch.arange(n_blocks, device=dev) % K).to(torch.int32)
    return subs, cids


def main(n_blocks=8192, reps=3, device=None) -> list:
    """The tool's six rows at ``n_blocks`` blocks each; returns them, with
    the number of distinct subgroups and clusters each row's blocks
    read."""
    tbl, feats, gen = make_inputs(device=device)
    out = []
    for variant, G, SPB in CONFIGS:
        subs, cids = block_ids(n_blocks, SPB, tbl.shape[0] - 1,
                               feats.shape[0], gen)
        tblc = torch.randn((n_blocks, G * SPB, FEAT), generator=gen,
                           device=gen.device) \
            if variant == "contig_tbl" else None
        ms = best_ms(lambda: run_block(variant, G, SPB, subs, cids, tbl,
                                       feats, tblc), reps)
        us = ms * 1e3 / n_blocks
        print(f"{variant:11s} G={G} SPB={SPB:2d}: {us:7.3f} us/block "
              f"({us / SPB:.4f} us/pair; {n_blocks} blocks in {ms:.3f} ms)",
              flush=True)
        out.append(dict(variant=variant, G=G, SPB=SPB, n_blocks=n_blocks,
                        ms=ms, us_per_block=us,
                        distinct_subs=int(torch.unique(subs).numel()),
                        distinct_cids=int(torch.unique(cids).numel())))
        del tblc
    return out


if __name__ == "__main__":
    main(*[int(x) for x in sys.argv[1:2]])
