"""Card probe P3: the cost of a small-depth contraction by shape and
precision (counterpart of ``tools/probe_matmul_shapes.py``).

Kernel ``csrc/matmul_probe.cu``: persistent CTAs that walk ``steps``
steps, each computing the whole (M, K) x (K, N) product of the same
operands and writing its row sums, so the per-step cost is the production
sweep's per-block contraction without its gathers. The operands stay in
shared memory where they fit (every tier at K = 16 up to M = 2048, but
3xTF32 there) and stream from L2 otherwise. The tool's precision tiers map
to Hopper as follows (``variant_of``):

  highest, float32 -> "fma":    float32 FMAs on the CUDA cores, 8 rows x 8
                                columns a thread
  high, float32    -> "3xtf32": three TF32 wgmma passes (lo*hi, hi*lo,
                                hi*hi), the error-compensated tier
  default, float32 -> "tf32":   one TF32 wgmma pass
  bfloat16 inputs  -> "bf16":   one bf16 wgmma pass (any tier)

The per-step cost is the slope between 8,192 and 32,768 steps, as in the
tool. On the card the steps run in parallel on the SMs, so it is a
throughput: the time the card needs per step when many steps are in
flight, not the latency of one.

    python -m raycore_tpu_torch.tools.probe_matmul_shapes
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import default_device
from ..core.triangle import fma
from ..kernels import _build
from ._common import best_ms, launch

VARIANTS = ("fma", "tf32", "3xtf32", "bf16")
TIER_OF_PREC = {"highest": "fma", "default": "tf32", "high": "3xtf32"}
# Tile sizes of the kernel: rows per tile and columns per chunk (the FMA
# tier's; the tensor-core tiers take 128 columns, and 64 for a last one).
ROW_TILE = 128
COL_CHUNK = 64
MAX_K = 256
# Limit of the tensor-core tiers' accumulation error, in units of a row's
# sum of product magnitudes (``tolerance``).
ACC_REL = 2.0 ** -21
# The tool's configurations (M, K, N, precision, dtype).
CONFIGS = (
    (512, 16, 512, "highest", torch.float32),
    (512, 16, 512, "default", torch.float32),
    (512, 16, 512, "default", torch.bfloat16),
    (1024, 16, 512, "highest", torch.float32),
    (2048, 16, 512, "highest", torch.float32),
    (2048, 16, 512, "default", torch.float32),
    (512, 128, 512, "highest", torch.float32),
    (512, 128, 512, "default", torch.float32),
    (512, 128, 512, "default", torch.bfloat16),
    (512, 16, 256, "highest", torch.float32),
    (512, 16, 128, "highest", torch.float32),
    (2048, 16, 128, "highest", torch.float32),
)
STEPS = (8192, 32768)


def variant_of(prec: str, dtype) -> str:
    """The kernel variant of a TPU precision tier on ``dtype`` inputs."""
    if prec not in TIER_OF_PREC:
        raise ValueError(f"precision {prec!r} is not one of "
                         f"{tuple(TIER_OF_PREC)}")
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype != torch.float32:
        raise TypeError(f"inputs must be float32 or bfloat16, got {dtype}")
    return TIER_OF_PREC[prec]


def to_tf32(x):
    """float32 ``x`` rounded to TF32's 10 mantissa bits as ``cvt.rna``
    rounds it (to nearest, ties away from zero), as float32."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _fma_row_sums(a, b):
    """The FMA tier bit for bit: each (row, column) dot an ascending fused
    multiply-add chain over K. Then, per row and 64-column chunk, each of
    8 threads adds its 8 dots in turn from 0 (columns 4 t .. 4 t + 3, then
    32 + 4 t .. 32 + 4 t + 3, for thread t), and the 8 partials are added
    as a tree, ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)); group g
    (0 or 1) adds the sums of chunks g, g + 2, ... in turn from 0, and the
    row sum is group 0's + group 1's. All additions in float32."""
    M, N = a.shape[0], b.shape[1]
    if N % COL_CHUNK:
        raise ValueError(f"matmul probe: N = {N} is not a multiple of "
                         f"{COL_CHUNK}")
    dots = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for k in range(a.shape[1]):
        dots = fma(a[:, k:k + 1], b[k:k + 1], dots)
    chunks = N // COL_CHUNK
    # [row, chunk, half, thread, column]: column 64 c + 32 h + 4 t + e.
    cols = dots.view(M, chunks, 2, 8, 4)
    part = torch.zeros((M, chunks, 8), dtype=torch.float32, device=a.device)
    for h in range(2):
        for e in range(4):
            part = part + cols[:, :, h, :, e]
    while part.shape[2] > 1:
        part = part[:, :, 0::2] + part[:, :, 1::2]
    group = [torch.zeros((M, 1), dtype=torch.float32, device=a.device)
             for _ in range(2)]
    for c in range(chunks):
        group[c % 2] = group[c % 2] + part[:, c]
    return group[0] + group[1]


def _row_sums(a, b, variant: str):
    """(M, 1) float32 row sums of ``a @ b`` by ``variant``: a kernel tier
    (see ``run_matmul_plain``) or "exact", the float64 product of the
    inputs as given, rounded once."""
    if variant == "fma":
        return _fma_row_sums(a, b)
    if variant in ("exact", "bf16"):
        pairs = ((a, b),)
    else:
        ah, bh = to_tf32(a), to_tf32(b)
        pairs = ((ah, bh),) if variant == "tf32" else \
            ((ah, bh), (ah, to_tf32(b - bh)), (to_tf32(a - ah), bh))
    return sum(x.double() @ y.double() for x, y in pairs) \
        .sum(1, keepdim=True).float()


def run_matmul_plain(a, b, steps: int, prec: str):
    """(M, 1) float32 row sums of ``a @ b`` as the kernel's tier computes
    them, in plain PyTorch (``steps`` changes nothing: every step computes
    the same product):

      fma     bit for bit: the kernel's fused multiply-add chains
              (``core.triangle.fma``) and its order of additions;
      tf32    each input rounded to TF32 (``to_tf32``), the products summed
              in float64 and rounded once;
      3xtf32  each input split into its TF32 part hi and lo = TF32(x - hi),
              as the kernel splits it, and hi*hi + hi*lo + lo*hi summed in
              float64;
      bf16    the bf16 inputs' products summed in float64.

    For the three tensor-core tiers only the float32 accumulation is left
    to differ (``tolerance``)."""
    return _row_sums(a, b, variant_of(prec, a.dtype))


def tolerance(a, b, variant: str):
    """(M, 1) float32 limit on |kernel - run_matmul_plain| per row: 0 for
    fma (bit for bit); for the tensor-core tiers ``ACC_REL * S``, with S =
    (|a| @ |b|).sum(1) the row's sum of product magnitudes, for the float32
    accumulation in the tensor cores and across the columns. ACC_REL comes
    from the tiers' errors on the card, not from a worst case (PERF.md,
    P3): above the accumulation error they show, and below the gap between
    neighbouring tiers (``tier_gap``), so a tier that computed its
    neighbour's product fails."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if variant == "fma":
        return torch.zeros((a.shape[0], 1), dtype=torch.float32,
                           device=a.device)
    S = (a.double().abs() @ b.double().abs()).sum(1, keepdim=True)
    return (ACC_REL * S).float()


def tier_gap(a, b, variant: str) -> float:
    """How far apart, in units of ``tolerance``, the plain version of
    ``variant`` and of its neighbour lie on the worst row, for float32
    operands: 3xtf32 against one TF32 pass, tf32 against the product of
    the unrounded inputs. Above 1, the check against ``run_matmul_plain``
    fails a kernel that computed the neighbour's product."""
    neighbour = {"3xtf32": "tf32", "tf32": "exact"}[variant]
    gap = (_row_sums(a, b, variant) - _row_sums(a, b, neighbour)).abs()
    return float((gap / tolerance(a, b, variant)).max())


def run_matmul(a, b, steps: int, prec: str):
    """Kernel P3 (``csrc/matmul_probe.cu``): ``steps`` steps, each computing
    the (M, 1) row sums of ``a @ b`` at the tier ``variant_of(prec,
    a.dtype)``; returns them. CPU tensors take ``run_matmul_plain``; CUDA
    tensors launch the kernel or raise. Needs M % 128 == 0, N % 64 == 0,
    K % 16 == 0 and K <= 256."""
    if a.device.type == "cpu":
        return run_matmul_plain(a, b, steps, prec)
    dev = a.device
    _build.require(a, a.dtype, "a", dev)
    _build.require(b, a.dtype, "b", dev)
    variant = variant_of(prec, a.dtype)
    M, K = a.shape
    if b.dim() != 2 or b.shape[0] != K or M % ROW_TILE or K % 16 \
            or K > MAX_K or b.shape[1] % COL_CHUNK or steps < 1:
        raise ValueError(
            f"matmul probe shapes: a {tuple(a.shape)} b {tuple(b.shape)} "
            f"steps {steps}; needs M % {ROW_TILE} == 0, K % 16 == 0, "
            f"K <= {MAX_K}, N % {COL_CHUNK} == 0, steps >= 1")
    out = torch.empty((M, 1), dtype=torch.float32, device=dev)
    launch("matmul_probe", dev, a.data_ptr(), b.data_ptr(), out.data_ptr(),
           M, K, b.shape[1], steps, VARIANTS.index(variant))
    run_matmul.launches += 1
    return out


run_matmul.launches = 0


def matmul_library(a, b, steps: int, prec: str):
    """The yardstick: ``torch.matmul`` on the float32 operands expanded to
    ``steps`` (no copy), then the row sum of the last step, with
    ``torch.backends.cuda.matmul.allow_tf32`` set for the tier ("highest"
    False, "default" True) and restored afterwards. The port never calls
    it."""
    if a.dtype != torch.float32 or prec not in ("highest", "default"):
        raise ValueError("the library yardstick covers float32 at "
                         "'highest' and 'default' only")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec == "default"
    try:
        q = torch.matmul(a.expand(steps, *a.shape), b.expand(steps, *b.shape))
        return q[-1].sum(1, keepdim=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def operands(M: int, K: int, N: int, dtype, device=None):
    """The tool's operands: normal (M, K) and (K, N) from numpy seed 0, in
    ``dtype`` on ``device`` (the card by default)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    dev = default_device(device)
    return (torch.as_tensor(a, device=dev).to(dtype),
            torch.as_tensor(b, device=dev).to(dtype))


def probe(M: int, K: int, N: int, prec: str, dtype=torch.float32, reps=5,
          steps=STEPS, device=None) -> dict:
    """Per-step cost of one configuration as the slope between two step
    counts (CUDA events, the best of ``reps`` after a warm-up). Prints the
    tool's row and returns the numbers."""
    a, b = operands(M, K, N, dtype, device)
    n1, n2 = steps
    t1 = best_ms(lambda: run_matmul(a, b, n1, prec), reps)
    t2 = best_ms(lambda: run_matmul(a, b, n2, prec), reps)
    us = (t2 - t1) / (n2 - n1) * 1e3
    row = dict(M=M, K=K, N=N, prec=prec, dtype=str(dtype).split(".")[-1],
               variant=variant_of(prec, dtype), us_per_step=us,
               ms=(t1, t2), steps=(n1, n2))
    print(f"({M:5d},{K:3d})@({K:3d},{N:4d}) {row['dtype']:8s} {prec:7s}: "
          f"{us:7.3f} us/step  ({us * 512 / M:6.3f} us per 512-row equiv; "
          f"{row['variant']}, throughput with CTAs in parallel)", flush=True)
    return row


def main(reps=5, device=None) -> list:
    """The tool's twelve configurations; returns their rows."""
    dev = default_device(device)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    return [probe(M, K, N, prec, dtype, reps=reps, device=dev)
            for M, K, N, prec, dtype in CONFIGS]


if __name__ == "__main__":
    main()
