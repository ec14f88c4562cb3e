"""Card probe P1: per-lane row fetch from a resident table (counterpart of
``tools/tpu_gather_probe.py``).

A per-ray wide-BVH traversal needs, at every step, one node row per ray at
a data-dependent index. Kernel ``csrc/gather_probe.cu`` measures three
ways to do that on the card, each summing the 512 rows a step fetches
from an (NN, 128) float32 table:

  loop    each step's 512 rows added in index order
  take    each step's 512 rows fetched in parallel, then reduced
  onehot  a (512, NN) bf16 one-hot tile times the bf16 table on the
          tensor cores (wgmma from shared memory, the table staged in
          bf16 K-tiles, each serving two steps), then the column sums

``loop`` and ``take`` run in one of two tiers, picked from NN alone by
``gather_tier``: over ``SLICE_ROWS``, where it was measured faster, each
CTA keeps a 4-column slice of the table in its shared memory, as the TPU
keeps the table in VMEM, and the card's SMs split the columns between
them; at any other NN, warps read whole rows from the L2.
``run_gather_model`` does each tier's float32 additions in the kernel's
order.

``gather_library``, one ``torch.index_select`` and a sum, is the tool's
``xla`` baseline. ``onehot``, which computes every product of the one-hot
matrix, loses to it by design; it is ported all the same.

    python -m raycore_tpu_torch.tools.gather_probe [NN] [steps]
"""
from __future__ import annotations

import sys

import torch

from ..core.device import default_device
from ..kernels import _build
from ._common import best_ms, launch

VARIANTS = ("loop", "onehot", "take")
R = 512           # fetches per step
W = 128           # table row width
# The row counts that take the shared-memory tier: from the fewest at
# which both kernels were measured faster than the L2 tier (chip_smoke.py
# phase 15 times both tiers; PERF.md, P1) to the most rows whose
# 16-byte slice fits beside the loop's 64 KB of index rings in an H100
# CTA's 227 KB of shared memory (the launch refuses more).
SLICE_ROWS = (6_144, 10_432)
# Back-to-back calls a timed sample of the tool's rows: a call of loop or
# take (about 0.06 ms at the defaults) is as short as the host's time to
# make it, which a single timed call would add.
CALLS = 20


def _check_args(idx, tbl, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if idx.dim() != 1 or idx.shape[0] % R or tbl.dim() != 2 \
            or tbl.shape[1] != W or (variant == "onehot" and tbl.shape[0] % 16):
        raise ValueError(
            f"gather probe shapes: idx {tuple(idx.shape)} must be (steps * "
            f"{R},), tbl {tuple(tbl.shape)} (NN, {W}) with NN % 16 == 0 for "
            f"onehot")


def gather_tier(NN):
    """The tier of ``loop`` and ``take`` for an (NN, 128) table: 4 (the
    columns of a shared-memory slice) for NN in ``SLICE_ROWS``, else 0,
    the kernels that read rows from the L2."""
    return 4 if SLICE_ROWS[0] <= NN <= SLICE_ROWS[1] else 0


def _chain(x):
    """Sum over dim -2 in index order, each addition rounded to float32,
    from +0 (``x`` float32, (..., n, W))."""
    acc = torch.zeros_like(x[..., 0, :])
    for i in range(x.shape[-2]):
        acc = acc + x[..., i, :]
    return acc


def run_gather_model(idx, tbl, variant, tier):
    """(steps, 128) float32: what kernel P1's ``loop`` or ``take`` gives in
    ``tier`` (``gather_tier``), each float32 addition in the kernel's order,
    so the card's result equals it bit for bit. ``loop``: every tier adds a
    step's rows in index order from +0. ``take`` in the shared-memory tier:
    lane l adds rows 128 k + 4 l + j (k, then j, in 0..3) from +0, then the
    lanes are added by the xor tree 16, 8, 4, 2, 1 (lane 0's value);
    ``take`` in the L2 tier (0): warp w adds rows w, w + 8, ... from +0,
    then the 8 warps' sums in order. ``onehot`` sums on the tensor cores
    and has no model."""
    _check_args(idx, tbl, variant)
    if variant == "onehot":
        raise ValueError("onehot accumulates on the tensor cores: no model")
    if tier not in (0, 4):
        raise ValueError(f"tier {tier!r} is not 0 or 4")
    rows = tbl[idx.long()].view(-1, R, W)
    if variant == "loop":
        return _chain(rows)
    if tier == 0:
        part = _chain(rows.view(-1, R // 8, 8, W).transpose(1, 2))
        out = part[:, 0]
        for w in range(1, 8):
            out = out + part[:, w]
        return out
    lanes = _chain(rows.view(-1, 4, 32, 4, W).transpose(1, 2)
                   .reshape(-1, 32, 16, W))
    while lanes.shape[1] > 1:
        half = lanes.shape[1] // 2
        lanes = lanes[:, :half] + lanes[:, half:]
    return lanes[:, 0]


def run_gather_plain(idx, tbl, variant):
    """(steps, 128) float32: per step the sum of its 512 rows ``tbl[idx]``;
    ``onehot`` rounds the table to bf16 first and sums in float32."""
    _check_args(idx, tbl, variant)
    if variant == "onehot":
        tbl = tbl.to(torch.bfloat16).float()
    return tbl[idx.long()].view(-1, R, W).sum(1)


def gather_library(idx, tbl):
    """The tool's ``xla`` baseline and this probe's yardstick: one
    ``torch.index_select`` of all rows, then the per-step sum. The port
    never calls it."""
    return torch.index_select(tbl, 0, idx).view(-1, R, W).sum(1)


def tolerance(idx, tbl, variant):
    """(steps, 128) bound on |kernel - run_gather_plain|: 2^-14 times the
    sum of the fetched magnitudes, i.e. 512 float32 additions in another
    order, each allowed twice the rounding error of an IEEE addition (the
    tensor cores' accumulation in ``onehot``)."""
    return 2.0 ** -14 * run_gather_plain(idx, tbl.abs(), variant)


def run_gather(idx, tbl, variant):
    """Kernel P1 (``csrc/gather_probe.cu``): the (steps, 128) float32
    per-step sums of ``run_gather_plain``, in another order of additions
    (``loop`` and ``take``: that of ``run_gather_model`` in the tier
    ``gather_tier(NN)``). ``idx`` (steps * 512,) int32 in [0, NN), not
    range-checked on the card; ``tbl`` (NN, 128) float32. CPU tensors take
    ``run_gather_plain``; CUDA tensors launch the kernel or raise."""
    if idx.device.type == "cpu":
        return run_gather_plain(idx, tbl, variant)
    _check_args(idx, tbl, variant)
    dev = idx.device
    _build.require(idx, torch.int32, "idx", dev)
    _build.require(tbl, torch.float32, "tbl", dev)
    steps = idx.shape[0] // R
    out = torch.empty((steps, W), dtype=torch.float32, device=dev)
    if steps == 0:
        return out
    NN = tbl.shape[0]
    launch("gather_probe", dev, idx.data_ptr(), tbl.data_ptr(),
           out.data_ptr(), NN, steps, VARIANTS.index(variant),
           gather_tier(NN))
    run_gather.launches += 1
    run_gather.by_variant[variant] += 1
    return out


run_gather.launches = 0
# The launches of each variant (the total is ``launches``); whoever zeroes
# ``launches`` zeroes these too.
run_gather.by_variant = dict.fromkeys(VARIANTS, 0)


def make_inputs(NN, steps, device=None, seed=0):
    """The tool's data: a normal (NN, 128) float32 table and steps * 512
    uniform indices, made on ``device`` (the card by default) from a torch
    generator seeded with ``seed``."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tbl = torch.randn((NN, W), generator=gen, device=dev)
    idx = torch.randint(0, NN, (steps * R,), generator=gen, device=dev,
                        dtype=torch.int32)
    return idx, tbl


def main(NN=8192, steps=2048, reps=3, device=None) -> list:
    """The tool's rows: the library baseline, then each kernel variant,
    each the best of ``reps`` samples of ``CALLS`` calls, ``loop`` and
    ``take`` in the tier ``gather_tier(NN)``. Returns the rows."""
    idx, tbl = make_inputs(NN, steps, device)
    print(f"table ({NN},{W}) f32 = {NN * W * 4 / 1024:.0f} KB; {steps} "
          f"steps x {R} fetches; loop and take: "
          + ("shared-memory tier, 32 slices of 4 columns"
             if gather_tier(NN) else "L2 tier"), flush=True)
    rows = []
    for name, fn in (("library", lambda: gather_library(idx, tbl)),
                     *((v, lambda v=v: run_gather(idx, tbl, v))
                       for v in VARIANTS)):
        ms = best_ms(fn, reps, CALLS)
        ns_row = ms * 1e6 / (steps * R)
        print(f"{name:8s}: {ms:8.3f} ms total, {ns_row:8.4f} ns/row, "
              f"{1.0 / ns_row:6.2f} Grows/s", flush=True)
        rows.append(dict(variant=name, NN=NN, steps=steps, ms=ms,
                         ns_per_row=ns_row))
    return rows


if __name__ == "__main__":
    main(*[int(x) for x in sys.argv[1:3]])
