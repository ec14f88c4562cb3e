"""Flags and lightweight observability (counterpart of
``raycore_tpu/utils/config.py``): env-driven debug switches checked with
``real_assert``, a min-of-N wall-time registry, and a ``torch.profiler``
trace scope.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "off")


DO_ASSERTS = _env_flag("RAYCORE_DO_ASSERTS", False)


def real_assert(cond, msg: str = ""):
    """Host-side assertion, active only when RAYCORE_DO_ASSERTS is set."""
    if DO_ASSERTS and not cond:
        raise AssertionError(msg or "real_assert failed")


@dataclass
class Timings:
    """min-of-N wall timing registry."""
    records: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def time(self, name: str, block=None):
        """Time the body; with ``block`` (a tensor on the card) the time
        includes the card finishing its queued work."""
        t0 = time.perf_counter()
        yield
        if isinstance(block, torch.Tensor) and block.is_cuda:
            torch.cuda.synchronize(block.device)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def best(self, name: str) -> float:
        return min(self.records[name])

    def summary(self) -> Dict[str, float]:
        return {k: min(v) for k, v in self.records.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the body (the card's kernels too when
    there is one), written to ``log_dir/trace.json`` (Chrome trace
    format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
