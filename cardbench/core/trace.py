"""The traced part of a run: a profiler over a fixed count of calls, and
the reduction of its events to per-call numbers.

The reduction works on plain ``Event`` records (name, host or device,
start and end in microseconds), so it is tested on synthetic events. On
the card ``from_profiler`` makes them from ``torch.profiler``'s events.

- Device time is the time of kernels, memcpys and memsets on the card.
  Within it a kernel is the port's own unless its name lies in the
  namespaces of PyTorch, CUB/Thrust or the CUDA libraries
  (``LIBRARY_MARKERS``); memcpys and memsets are never the port's.
- Busy time is the union of the device intervals; idle is the rest of
  the traced span (the first call's start to the last call's end).
- A host sync is a host interval in which the host waits for the
  device: one of ``SYNC_NAMES``, or a synchronous copy (``COPY_NAMES``)
  inside which a device-to-host memcpy (``D2H_PREFIX``) starts; a
  host-to-device copy is no such wait. Nested or overlapping ones count
  once, and those inside the harness's own sync span (``SYNC_SPAN``) do
  not count.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

CALL_SPAN = "cardbench.call"
SYNC_SPAN = "cardbench.sync"
REFRESH_SPAN = "cardbench.refresh"
SPAN_PREFIX = "cardbench."
SYNC_NAMES = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "aten::item",
    "aten::_local_scalar_dense"})
COPY_NAMES = frozenset({"cudaMemcpy", "cudaMemcpy2D"})
D2H_PREFIX = "Memcpy DtoH"
# Substrings that place a kernel in PyTorch, CUB/Thrust or a CUDA library.
LIBRARY_MARKERS = ("at::", "c10::", "at_cuda_detail", "cub::", "thrust::",
                   "cublas", "cublasLt", "cutlass", "cudnn", "cusparse",
                   "cufft", "curand", "gemm", "gemv", "xmma", "nvjet",
                   "splitKreduce")
COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool
    start: float    # microseconds
    end: float


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def is_library(name: str) -> bool:
    """Whether a device operation belongs to PyTorch, CUB/Thrust, a CUDA
    library, or is a memcpy or memset."""
    return is_copy(name) or any(m in name for m in LIBRARY_MARKERS)


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, template arguments and
    parameters, cut to ``width`` characters."""
    s = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip() or name
    return s[:width]


def merge(intervals):
    """Sorted, disjoint unions of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


@dataclasses.dataclass
class Summary:
    calls: int
    window_s: float
    busy_s: float
    own_s: float
    library_s: float
    syncs: int
    spans: dict            # span name -> list of durations in seconds
    device_ops: list       # [[name, seconds], ...], most time first
    idle_gaps: list        # [[host op, seconds], ...], most time first

    def per_call_ms(self, seconds: float) -> float:
        return seconds / self.calls * 1e3

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _innermost(host_sorted, starts, t):
    """Name of the innermost host event that covers time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 4096), -1):
        ev = host_sorted[j]
        if ev.end >= t:
            return ev.name
    return "host (no op)"


def summarize(events) -> Summary:
    """Per-call numbers of a traced span. ``events`` hold every host and
    device event of the profiled calls, each call inside a CALL_SPAN."""
    host = [e for e in events if not e.device]
    calls = [e for e in host if e.name == CALL_SPAN]
    if not calls:
        raise ValueError("the trace holds no call span")
    lo = min(e.start for e in calls)
    hi = max(e.end for e in calls)
    device = [e for e in events if e.device and e.end > e.start
              and not e.name.startswith(SPAN_PREFIX)
              and lo <= e.start < hi]
    busy = merge([(e.start, e.end) for e in device])
    busy = clip(busy, lo, hi)
    busy_us = sum(e - s for s, e in busy)
    own_us = sum(e.end - e.start for e in device if not is_library(e.name))
    lib_us = sum(e.end - e.start for e in device if is_library(e.name))

    harness_syncs = [(e.start, e.end) for e in host if e.name == SYNC_SPAN]
    d2h = sorted(e.start for e in device if e.name.startswith(D2H_PREFIX))

    def waits(e):
        if e.name in SYNC_NAMES:
            return True
        if e.name in COPY_NAMES:
            i = bisect.bisect_left(d2h, e.start)
            return i < len(d2h) and d2h[i] <= e.end
        return False

    sync_iv = [(e.start, e.end) for e in host if waits(e)
               and not any(s <= e.start and e.end <= t
                           for s, t in harness_syncs)]
    syncs = len(merge(sync_iv))

    spans = defaultdict(list)
    for e in host:
        if e.name.startswith(SPAN_PREFIX):
            spans[e.name].append((e.end - e.start) * 1e-6)

    by_op = defaultdict(float)
    for e in device:
        by_op[short_name(e.name)] += (e.end - e.start) * 1e-6
    device_ops = sorted(([k, v] for k, v in by_op.items()),
                        key=lambda kv: -kv[1])[:TOP]

    named_host = sorted((e for e in host if not e.name.startswith(
        SPAN_PREFIX)), key=lambda e: e.start)
    starts = [e.start for e in named_host]
    gaps = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps[_innermost(named_host, starts, (s + e) / 2)] += (e - s) * 1e-6
    idle_gaps = sorted(([k, v] for k, v in gaps.items()),
                       key=lambda kv: -kv[1])[:TOP]
    return Summary(calls=len(calls), window_s=(hi - lo) * 1e-6,
                   busy_s=busy_us * 1e-6, own_s=own_us * 1e-6,
                   library_s=lib_us * 1e-6, syncs=syncs, spans=dict(spans),
                   device_ops=device_ops, idle_gaps=idle_gaps)


def from_profiler(prof):
    """``Event`` records from a finished ``torch.profiler.profile``. The
    device side of a ``record_function`` span (a user annotation) is left
    out: it is no operation."""
    out = []
    for e in prof.events():
        dev = e.device_type.name != "CPU"
        if dev and (getattr(e, "is_user_annotation", False)
                    or "Sync" in e.name):
            continue
        out.append(Event(e.name, dev, float(e.time_range.start),
                         float(e.time_range.end)))
    return out
