"""Card probe P2: the per-block cost of the worklist sweep's epilogue
(counterpart of ``tools/epilogue_experiments.py``).

Kernel ``csrc/epilogue_probe.cu`` runs a grid of identical (TILE, 16) x
(16, 4C) blocks (C = 128) with progressively richer epilogues; the time
per block of each variant says what the worklist sweep (K3) pays for its
product, its reciprocal, its compares and its key packing:

  matmul_only          the 16-deep dot, min of tdet's bits
  vpu_only             the 19 nonzero coefficients only, min of the sum
  full                 dot, 1 / det, acceptance, packed key, min with key0
  vpu_full             vpu_only's quantities with full's epilogue
  no_divide_signtrick  acceptance multiplied through by |det|, t from an
                       approximate reciprocal
  approx_recip         full with an approximate reciprocal
  recip_only           dot, 1 / det, min of the bits of u + v + t

The approximate reciprocal is the card's rcp.approx.ftz.f32 (at most 1 ulp
off). On the card the blocks run in parallel, so µs per block is a
throughput.

The tool seeds every row's carried key with 0x7FFFFF80 (``SEED_KEY``),
whose t (bits & ~127) is a NaN: no lane passes ``t <= cur_t``, so the
variants that accept (full, vpu_full, no_divide_signtrick,
approx_recip) accept nothing on the tool's own data. ``main`` keeps that
seed, so its rows time the tool's data; ``finite_key0`` gives a seed that
decodes to a finite t and exercises the acceptance path.

    python -m raycore_tpu_torch.tools.epilogue_experiments [TILE] [n_blocks]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.device import default_device
from ..core.triangle import fma
from ..kernels import _build
from ..ops.dense import FEAT, INT32_MAX
from ._common import EPS, ONE_EPS, best_ms, check_equal, launch

VARIANTS = ("matmul_only", "vpu_only", "full", "vpu_full",
            "no_divide_signtrick", "approx_recip", "recip_only")
# Variants whose key goes through the approximate reciprocal.
APPROX = ("no_divide_signtrick", "approx_recip")
# Variants that accept hits and fold in key0.
ACCEPTING = ("full", "vpu_full", "no_divide_signtrick", "approx_recip")
C = 128
N_TILES = 64
LANE_MASK = 127
SEED_KEY = 0x7FFFFF80
# The tool's terms of the VPU variants: (quantity block, feature rows).
VPU_TERMS = ((0, (0, 1, 2)), (1, (0, 1, 2, 3, 4, 5)),
             (2, (0, 1, 2, 3, 4, 5)), (3, (6, 7, 8, 9)))


def finite_key0(n_rows, t=10.0, device=None):
    """A carried key that decodes to the finite ``t``: its float32 bits with
    the 7 lane bits set (no lane id), shape (n_rows, 1)."""
    bits = int(np.array(t, np.float32).view(np.int32)) | LANE_MASK
    return torch.full((n_rows, 1), bits, dtype=torch.int32,
                      device=default_device(device))


def tile_ids(n_blocks, n_tiles, same_tile, device):
    """tids[b] = b % n_tiles, or 0 for every block with ``same_tile``."""
    b = torch.arange(n_blocks, device=device)
    return torch.zeros_like(b) if same_tile else b % n_tiles


def _keys(variant, phi, F, tmin, key0):
    """Keys of one tile's rows: ``phi`` (TILE, 16), ``F`` (16, 4C), ``tmin``
    and ``key0`` (TILE, 1)."""
    if variant.startswith("vpu"):
        det, udet, vdet, tdet = (
            _comb(phi, F[:, k * C:(k + 1) * C], ks) for k, ks in VPU_TERMS)
        if variant == "vpu_only":
            return (((det + udet) + vdet) + tdet).view(torch.int32) \
                .min(1, keepdim=True).values
    else:
        # The kernel's 16-step fused multiply-add chain, emulated exactly.
        q = torch.zeros((phi.shape[0], 4 * C), dtype=torch.float32,
                        device=phi.device)
        for f in range(FEAT):
            q = fma(phi[:, f:f + 1], F[f:f + 1], q)
        det, udet, vdet, tdet = (q[:, k * C:(k + 1) * C] for k in range(4))
    if variant == "matmul_only":
        return tdet.contiguous().view(torch.int32).min(1, keepdim=True).values
    cur_t = (key0 & ~LANE_MASK).view(torch.float32)
    lanes = torch.arange(C, dtype=torch.int32, device=phi.device)
    if variant == "no_divide_signtrick":
        sd = torch.where(det < 0, -1.0, 1.0)
        ad, us, vs, ts = det * sd, udet * sd, vdet * sd, tdet * sd
        ead = EPS * ad
        ok = (us >= -ead) & (us <= ad + ead) & (vs >= -ead) \
            & (us + vs <= ad + ead) & (ts >= tmin * ad) & (ts <= cur_t * ad)
        t = ts * torch.reciprocal(ad.clamp_min(1e-30))
    else:
        r = torch.reciprocal(det)
        u, v, t = udet * r, vdet * r, tdet * r
        if variant == "recip_only":
            return ((u + v) + t).view(torch.int32).min(1, keepdim=True).values
        ok = (u >= -EPS) & (u <= ONE_EPS) & (v >= -EPS) & (u + v <= ONE_EPS) \
            & (t >= tmin) & (t <= cur_t)
    kb = torch.where(t > 0, t, 0.0).view(torch.int32)
    key = torch.where(ok, (kb & ~LANE_MASK) | lanes, INT32_MAX)
    return torch.minimum(key.min(1, keepdim=True).values, key0)


def _comb(phi, F, ks):
    """The tool's ``comb``: the first product, then each further product
    added, every step rounded in float32."""
    acc = phi[:, ks[0]:ks[0] + 1] * F[ks[0]:ks[0] + 1]
    for k in ks[1:]:
        acc = acc + phi[:, k:k + 1] * F[k:k + 1]
    return acc


def _check_args(variant, phi, TILE, n_blocks):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if TILE < 1 or phi.shape[0] % TILE or n_blocks < 0:
        raise ValueError(f"epilogue probe: {phi.shape[0]} rows are not whole "
                         f"tiles of TILE={TILE} (n_blocks={n_blocks})")


def run_epilogue_plain(phi, feats, tmin, key0, *, TILE, n_blocks, variant,
                       same_tile=False):
    """The probe's (n_tiles * TILE, 1) int32 keys in plain PyTorch: every
    tile some block visits gets the tool's keys for its rows (blocks on the
    same tile compute the same keys), every other row 0. The dot is the
    kernel's fused multiply-add chain (``core.triangle.fma``), the VPU
    sums the tool's products and additions in its order, the reciprocal
    exact."""
    _check_args(variant, phi, TILE, n_blocks)
    n_tiles = phi.shape[0] // TILE
    out = torch.zeros((phi.shape[0], 1), dtype=torch.int32, device=phi.device)
    for tile in torch.unique(tile_ids(n_blocks, n_tiles, same_tile,
                                      phi.device)).tolist():
        rows = slice(tile * TILE, (tile + 1) * TILE)
        out[rows] = _keys(variant, phi[rows], feats[tile], tmin[rows],
                          key0[rows])
    return out


def run_epilogue(phi, feats, tmin, key0, *, TILE, n_blocks, variant,
                 same_tile=False):
    """Kernel P2 (``csrc/epilogue_probe.cu``): ``n_blocks`` CTAs, block b on
    tile b % n_tiles (0 with ``same_tile``), one thread per row; returns
    the (n_tiles * TILE, 1) int32 keys, 0 on rows of tiles no block visits.
    Equal to ``run_epilogue_plain`` bit for bit except in the variants that
    use the approximate reciprocal. ``phi`` (n_tiles * TILE, 16), ``feats``
    (n_tiles, 16, 4C) and ``tmin`` (n_tiles * TILE, 1) float32, ``key0``
    (n_tiles * TILE, 1) int32. CPU tensors take ``run_epilogue_plain``;
    CUDA tensors launch the kernel or raise."""
    if phi.device.type == "cpu":
        return run_epilogue_plain(phi, feats, tmin, key0, TILE=TILE,
                                  n_blocks=n_blocks, variant=variant,
                                  same_tile=same_tile)
    _check_args(variant, phi, TILE, n_blocks)
    dev = phi.device
    for name, x, dtype in (("phi", phi, torch.float32),
                           ("feats", feats, torch.float32),
                           ("tmin", tmin, torch.float32),
                           ("key0", key0, torch.int32)):
        _build.require(x, dtype, name, dev)
    R, n_tiles = phi.shape[0], phi.shape[0] // TILE
    if TILE > 1024 or tuple(phi.shape) != (R, FEAT) \
            or tuple(feats.shape) != (n_tiles, FEAT, 4 * C) \
            or tmin.numel() != R or key0.numel() != R:
        raise ValueError(
            f"epilogue probe shapes: phi {tuple(phi.shape)}, feats "
            f"{tuple(feats.shape)}, tmin {tuple(tmin.shape)}, key0 "
            f"{tuple(key0.shape)} for TILE={TILE} <= 1024, C={C}")
    out = torch.zeros((R, 1), dtype=torch.int32, device=dev)
    if n_blocks == 0:
        return out
    launch("epilogue_probe", dev, phi.data_ptr(), feats.data_ptr(),
           tmin.data_ptr(), key0.data_ptr(), out.data_ptr(), n_tiles, TILE,
           C, n_blocks, int(same_tile), VARIANTS.index(variant), EPS,
           ONE_EPS)
    run_epilogue.launches += 1
    return out


run_epilogue.launches = 0


def rcp_check(exponent, device=None):
    """The kernel's branch-free reciprocal (``csrc/epilogue_probe.cu:
    rcp_fast``) on the card against the correctly rounded one, over every
    float32 2^exponent (1 + m 2^-23) of both signs: (values that differ,
    values in its range). The kernel takes that reciprocal for every det in
    its range and divides elsewhere."""
    dev = default_device(device)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    launch("epilogue_rcp_check", dev, exponent, counts.data_ptr())
    return int(counts[0]), int(counts[1])


def check(got, want, variant, what):
    """The kernel's keys against the plain version's. Exact variants: equal
    bit for bit (``_common.check_equal``). The approximate-reciprocal
    variants: the t each key carries (bits & ~127) within 2^-15 relative
    (the reciprocal is up to 1 ulp off, and a t near a multiple of 128 ulp
    can fall into the neighbouring key step), except on at most one row in
    1,000 (or 1), where an acceptance compare lands within that error of
    its threshold. Returns (rows beyond the bound, max abs difference of
    the carried t)."""
    if variant not in APPROX:
        check_equal(got, want, f"{what} ({variant})")
        return 0, 0.0
    R = got.numel()
    tg = (got & ~LANE_MASK).view(torch.float32)
    tw = (want & ~LANE_MASK).view(torch.float32)
    close = (got == want) | ((tg - tw).abs() <= 2.0 ** -15 * tw.abs())
    allowed = max(1, R // 1000)
    n = int((~close).sum())
    if n > allowed:
        raise AssertionError(f"{what} ({variant}): {n} of {R} rows differ "
                             f"from the plain version (at most {allowed})")
    diff = (tg - tw).abs()[got != want]
    diff = diff[torch.isfinite(diff)]
    return n, float(diff.max()) if diff.numel() else 0.0


def make_inputs(TILE, n_tiles=N_TILES, device=None, seed=0):
    """The tool's data: normal phi (n_tiles * TILE, 16) and feats (n_tiles,
    16, 4C) float32 from numpy seed ``seed``, tmin 0 and key0 the tool's
    SEED_KEY, on ``device`` (the card by default)."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((n_tiles * TILE, FEAT), dtype=np.float32)
    feats = rng.standard_normal((n_tiles, FEAT, 4 * C), dtype=np.float32)
    R = n_tiles * TILE
    return (torch.as_tensor(phi, device=dev),
            torch.as_tensor(feats, device=dev),
            torch.zeros((R, 1), dtype=torch.float32, device=dev),
            torch.full((R, 1), SEED_KEY, dtype=torch.int32, device=dev))


def timed(TILE, variant, n_blocks, label, inputs, reps=3, same_tile=False):
    """One row of the tool: best device time of ``n_blocks`` blocks."""
    phi, feats, tmin, key0 = inputs
    ms = best_ms(lambda: run_epilogue(phi, feats, tmin, key0, TILE=TILE,
                                      n_blocks=n_blocks, variant=variant,
                                      same_tile=same_tile), reps)
    us = ms * 1e3 / n_blocks
    print(f"{label:46s}: {ms:7.3f} ms, {us:6.3f} us/block, "
          f"{TILE * C / us * 1e-3:6.1f} Gelem/s", flush=True)
    return dict(label=label, variant=variant, TILE=TILE, n_blocks=n_blocks,
                ms=ms, us_per_block=us)


def main(TILE=512, n_blocks=8192, reps=3, device=None) -> list:
    """The tool's rows: four variants at TILE, then vpu_only and vpu_full at
    TILE 256 and 1024 with the block count scaled to the same rows; the
    tool's key0 seed throughout. Returns the rows."""
    dev = default_device(device)
    base = make_inputs(TILE, device=dev)
    rows = [timed(TILE, v, n_blocks, f"{v} T={TILE}", base, reps)
            for v in ("matmul_only", "vpu_only", "full", "vpu_full")]
    for T2 in (256, 1024):
        nb2 = n_blocks * TILE // T2
        # The tool draws these tiles' phi from seed 1 and keeps feats.
        phi2 = make_inputs(T2, device=dev, seed=1)[0]
        R2 = phi2.shape[0]
        inputs = (phi2, base[1],
                  torch.zeros((R2, 1), dtype=torch.float32, device=dev),
                  torch.full((R2, 1), SEED_KEY, dtype=torch.int32,
                             device=dev))
        rows += [timed(T2, v, nb2, f"{v} T={T2}", inputs, reps)
                 for v in ("vpu_only", "vpu_full")]
    return rows


if __name__ == "__main__":
    main(*[int(x) for x in sys.argv[1:3]])
