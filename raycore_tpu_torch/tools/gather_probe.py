"""Card probe P1: per-lane row fetch from a resident table (counterpart of
``tools/tpu_gather_probe.py``).

A per-ray wide-BVH traversal needs, at every step, one node row per ray at
a data-dependent index. Kernel ``csrc/gather_probe.cu`` measures three
ways to do that on the card, each summing the 512 rows a step fetches
from an (NN, 128) float32 table:

  loop    one warp per step walks its 512 indices in order
  take    one CTA per step fetches its 512 rows in parallel, then reduces
  onehot  a (512, NN) bf16 one-hot tile times the bf16 table on the
          tensor cores (wgmma from shared memory, the table staged in
          bf16 K-tiles, each serving two steps), then the column sums

and ``gather_library``, one ``torch.index_select`` and a sum, is the
tool's ``xla`` baseline. The card gathers in hardware and a 4 MB table sits
in L2, so ``onehot``, which computes every product of the one-hot matrix,
loses to it by design; it is ported all the same.

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


def _check_args(idx, tbl, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if idx.dim() != 1 or idx.shape[0] % R or tbl.dim() != 2 \
            or tbl.shape[1] != W or (variant == "onehot" and tbl.shape[0] % 16):
        raise ValueError(
            f"gather probe shapes: idx {tuple(idx.shape)} must be (steps * "
            f"{R},), tbl {tuple(tbl.shape)} (NN, {W}) with NN % 16 == 0 for "
            f"onehot")


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
    per-step sums of ``run_gather_plain``, in another order of additions.
    ``idx`` (steps * 512,) int32 in [0, NN), not range-checked on the card;
    ``tbl`` (NN, 128) float32. CPU tensors take ``run_gather_plain``; CUDA
    tensors launch the kernel or raise."""
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
    launch("gather_probe", dev, idx.data_ptr(), tbl.data_ptr(),
           out.data_ptr(), tbl.shape[0], steps, VARIANTS.index(variant))
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
    """The tool's rows: the library baseline, then each kernel variant.
    Returns the rows."""
    idx, tbl = make_inputs(NN, steps, device)
    print(f"table ({NN},{W}) f32 = {NN * W * 4 / 1024:.0f} KB; {steps} "
          f"steps x {R} fetches", flush=True)
    rows = []
    for name, fn in (("library", lambda: gather_library(idx, tbl)),
                     *((v, lambda v=v: run_gather(idx, tbl, v))
                       for v in VARIANTS)):
        ms = best_ms(fn, reps)
        ns_row = ms * 1e6 / (steps * R)
        print(f"{name:8s}: {ms:8.3f} ms total, {ns_row:8.4f} ns/row, "
              f"{1.0 / ns_row:6.2f} Grows/s", flush=True)
        rows.append(dict(variant=name, NN=NN, steps=steps, ms=ms,
                         ns_per_row=ns_row))
    return rows


if __name__ == "__main__":
    main(*[int(x) for x in sys.argv[1:3]])
