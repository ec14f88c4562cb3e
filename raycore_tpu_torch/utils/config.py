"""Flags and lightweight observability (counterpart of
``raycore_tpu/utils/config.py``): env-driven debug switches checked with
``real_assert``, the program's profiler spans (``span``), and a
``torch.profiler`` trace scope.
"""
from __future__ import annotations

import contextlib
import os

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


# What ``span`` returns while no profiler records: one shared context
# that does nothing.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler span named ``name`` (``torch.profiler.record_function``)
    while a ``torch.profiler`` records on this thread, else a shared
    context that does nothing. The spans are the profiler's host events,
    on the clock of its device events; off, a span costs one check of the
    profiler's state."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the body (the card's kernels too when
    there is one), written to ``log_dir/trace.json`` (Chrome trace
    format). It holds the program's ``span`` ranges (``raycore.*``: each
    query, its stages and its host waits) beside the operations."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
