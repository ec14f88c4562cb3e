"""What the card probes share: timing with CUDA events, the launch of one
probe kernel through the kernel library, the acceptance slack and the
bit-for-bit check. The plain versions' fused multiply-add is
``core.triangle.fma``, rounded once as the card's ``fmaf``."""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

# Acceptance slack as float32 values, the tools' -e and 1 + e.
EPS = float(np.float32(1e-5))
ONE_EPS = float(np.float32(1 + 1e-5))


def best_ms(fn, reps: int, calls: int = 1) -> float:
    """Least device time in ms of one call of ``fn`` over ``reps`` timed
    samples after one warm-up call: CUDA events around ``calls``
    back-to-back calls, the time divided by ``calls``."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def launch(name: str, device, *args) -> None:
    """Call the library's entry point ``raycore_<name>`` with ``args`` and
    PyTorch's current stream on ``device``; raise on a CUDA error."""
    lib = _build.library()
    with torch.cuda.device(device):
        err = getattr(lib, f"raycore_{name}")(
            *args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, name)


def check_equal(got, want, what: str) -> None:
    """Raise unless the kernel's outputs (a tensor or a tuple of them)
    equal the plain version's bit for bit."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{what}: output {i} has shape "
                                 f"{tuple(g.shape)}, plain {tuple(w.shape)}")
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        n = int((g != w).sum())
        if n:
            raise AssertionError(f"{what}: {n} of {g.numel()} values of "
                                 f"output {i} differ from the plain version")
