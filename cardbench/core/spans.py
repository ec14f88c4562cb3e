"""The program's own spans in the traced part (``raycore.*``, opened by
``raycore_tpu_torch/utils/config.py:span`` whenever a profiler records),
reduced to per-call numbers beside ``core/trace.py``'s, from the same
profiler. The reduction works on plain ``Event`` records, so it is tested
on synthetic events; ``from_profiler`` makes them from a finished
``torch.profiler.profile``.

- Stage spans are the ``raycore.*`` spans that are not waits: the query's
  root (``raycore.closest_hit``, ``raycore.any_hit``), ``raycore.stage1``,
  ``raycore.sweep``, ``raycore.combine``, ``raycore.finalize`` and
  ``raycore.refresh``. A device operation (kernel, memcpy, memset, chosen
  as ``core/trace.py`` chooses them) belongs to the innermost stage span
  around the host call that launched it: the host runtime call with the
  operation's correlation id, else the host operation its linked
  correlation id names. An operation with neither link belongs to the
  innermost device-side annotation of a stage span around it (the span's
  range on the device's one stream). A sweep nested in stage 1 (the
  multiwave's wave grid) keeps its operations out of stage 1.
- A wait is host time in a ``raycore.wait.<site>`` span: the host waiting
  on the device at that program line.
- A host sync (``core/trace.py``'s rule) is named by the innermost
  ``raycore.*`` span (waits included) around its start, an idle gap of
  the device by the one over its middle; ``OUTSIDE`` where there is none.

Run one cell's set-up and traced calls and print the reduction, the
breakdown of ``core/trace.py`` and every per-layer metric of the cell, as
one JSON line, from the root of a checkout on a CUDA card:

    python -m cardbench.core.spans --workload <cell> --seed <n> [--syncs]

``--syncs`` also prints, for every host sync that lies in no wait span,
the host operations around it, and runs one more call in PyTorch's CUDA
sync debug mode to print the program lines of every synchronizing call.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

from cardbench.core import trace

PREFIX = "raycore."
WAIT_PREFIX = "raycore.wait."
STAGE1 = "raycore.stage1"
REFRESH = "raycore.refresh"
OUTSIDE = "outside the program"
# Host events of the CUDA APIs, cuda* and cu* (their correlation ids are
# the device operations').
RUNTIME_PREFIX = "cu"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool
    start: float         # microseconds
    end: float
    corr: int = 0        # the profiler's correlation id
    link: int = 0        # a device operation's launching host operation
    annotation: bool = False   # the device-side range of a span


def is_stage(name: str) -> bool:
    return name.startswith(PREFIX) and not name.startswith(WAIT_PREFIX)


class _Nest:
    """Innermost interval of a properly nested set around a time."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.events]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, -1, -1):
            if self.events[j].end >= t:
                return self.events[j]
        return None


@dataclasses.dataclass
class Spans:
    calls: int
    device_s: dict        # stage span -> device seconds it launched
    ops: dict             # stage span -> device operations it launched
    unattributed_s: float  # device seconds under no stage span
    unattributed_ops: int
    linked_ops: int       # operations placed by a correlation id
    host_s: dict          # raycore span -> host seconds, summed
    syncs: dict           # innermost raycore span or OUTSIDE -> host syncs
    idle_s: dict          # innermost raycore span or OUTSIDE -> idle seconds

    def per_call_ms(self, seconds: float) -> float:
        return seconds / self.calls * 1e3

    def stage_ms(self, name: str) -> float:
        """Device ms a call that ``name`` launched itself."""
        return self.per_call_ms(self.device_s.get(name, 0.0))

    def stage_ops(self, name: str) -> float:
        """Device operations a call that ``name`` launched itself."""
        return self.ops.get(name, 0) / self.calls

    @property
    def wait_ms(self) -> float:
        """Host ms a call in ``raycore.wait.*`` spans."""
        return self.per_call_ms(sum(v for k, v in self.host_s.items()
                                    if k.startswith(WAIT_PREFIX)))


def device_ops(events, lo, hi):
    """The device operations ``core/trace.py`` counts between lo and hi:
    no span annotation and no sync record (as ``trace.from_profiler``), a
    positive length, no harness span, a start inside the traced span."""
    return [e for e in events if e.device and not e.annotation
            and "Sync" not in e.name and e.end > e.start
            and not e.name.startswith(trace.SPAN_PREFIX)
            and lo <= e.start < hi]


def reduce(events) -> Spans:
    """Per-span numbers of a traced span whose calls each lie in a
    ``trace.CALL_SPAN``."""
    host = [e for e in events if not e.device]
    calls = [e for e in host if e.name == trace.CALL_SPAN]
    if not calls:
        raise ValueError("the trace holds no call span")
    lo = min(e.start for e in calls)
    hi = max(e.end for e in calls)
    ops = device_ops(events, lo, hi)
    spans = [e for e in host if e.name.startswith(PREFIX)]
    stages = _Nest([e for e in spans if is_stage(e.name)])
    every = _Nest(spans)
    annotated = _Nest([e for e in events if e.device and e.annotation
                       and is_stage(e.name)])
    runtime = {e.corr: e for e in host
               if e.corr and e.name.startswith(RUNTIME_PREFIX)}
    host_op = {e.corr: e for e in host
               if e.corr and not e.name.startswith(RUNTIME_PREFIX)}

    device_s, n_ops = defaultdict(float), defaultdict(int)
    un_s, un_ops, linked = 0.0, 0, 0
    for op in ops:
        anchor = runtime.get(op.corr) or host_op.get(op.link)
        if anchor is not None:
            linked += 1
            owner = stages.at(anchor.start)
        else:
            owner = annotated.at((op.start + op.end) / 2)
        if owner is None:
            un_s += (op.end - op.start) * 1e-6
            un_ops += 1
        else:
            device_s[owner.name] += (op.end - op.start) * 1e-6
            n_ops[owner.name] += 1

    host_s = defaultdict(float)
    for e in spans:
        host_s[e.name] += (e.end - e.start) * 1e-6

    harness_syncs = [(e.start, e.end) for e in host
                     if e.name == trace.SYNC_SPAN]
    d2h = sorted(e.start for e in ops if e.name.startswith(trace.D2H_PREFIX))

    def waits(e):
        if e.name in trace.SYNC_NAMES:
            return True
        if e.name in trace.COPY_NAMES:
            i = bisect.bisect_left(d2h, e.start)
            return i < len(d2h) and d2h[i] <= e.end
        return False

    sync_iv = trace.merge([(e.start, e.end) for e in host if waits(e)
                           and not any(s <= e.start and e.end <= t
                                       for s, t in harness_syncs)])
    syncs = defaultdict(int)
    for s, _ in sync_iv:
        owner = every.at(s)
        syncs[owner.name if owner else OUTSIDE] += 1

    busy = trace.clip(trace.merge([(e.start, e.end) for e in ops]), lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle_s = defaultdict(float)
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            owner = every.at((s + e) / 2)
            idle_s[owner.name if owner else OUTSIDE] += (e - s) * 1e-6
    return Spans(calls=len(calls), device_s=dict(device_s), ops=dict(n_ops),
                 unattributed_s=un_s, unattributed_ops=un_ops,
                 linked_ops=linked, host_s=dict(host_s), syncs=dict(syncs),
                 idle_s=dict(idle_s))


def unnamed_syncs(events) -> list:
    """(start, the innermost span or OUTSIDE, the sync's name, the host
    operations around it, innermost last) of each host sync that lies in
    no wait span: where to look for a site that has none."""
    host = [e for e in events if not e.device]
    spans = _Nest([e for e in host if e.name.startswith(PREFIX)])
    harness = [(e.start, e.end) for e in host if e.name == trace.SYNC_SPAN]
    ops = sorted((e for e in host if not e.name.startswith(PREFIX)
                  and not e.name.startswith(trace.SPAN_PREFIX)),
                 key=lambda e: (e.start, -e.end))
    out = []
    for e in host:
        if e.name not in trace.SYNC_NAMES or any(
                s <= e.start and e.end <= t for s, t in harness):
            continue
        owner = spans.at(e.start)
        if owner is not None and owner.name.startswith(WAIT_PREFIX):
            continue
        around = [h.name for h in ops if h.start <= e.start <= h.end
                  and h.end >= e.end and h is not e]
        out.append((e.start, owner.name if owner else OUTSIDE, e.name,
                    around[-6:]))
    return out


def sync_sites(call) -> dict:
    """Run ``call()`` once in PyTorch's CUDA sync debug mode and count
    each synchronizing operation by the program lines that reached it
    (``raycore_tpu_torch`` frames, outermost first)."""
    import traceback
    import warnings

    import torch
    sites = defaultdict(int)

    def record(*_):
        frames = [f"{f.filename.rsplit('raycore_tpu_torch/', 1)[-1]}"
                  f":{f.lineno}" for f in traceback.extract_stack()
                  if "raycore_tpu_torch" in f.filename]
        sites[" > ".join(frames[-5:]) or OUTSIDE] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sites)


def from_profiler(prof):
    """``Event`` records, with their correlation ids, from a finished
    ``torch.profiler.profile``."""
    out = []
    for e in prof.events():
        dev = e.device_type.name != "CPU"
        out.append(Event(
            e.name, dev, float(e.time_range.start), float(e.time_range.end),
            corr=int(getattr(e, "id", 0) or 0),
            link=int(getattr(e, "linked_correlation_id", 0) or 0),
            annotation=dev and bool(getattr(e, "is_user_annotation",
                                            False))))
    return out


def to_trace(events) -> list:
    """The ``trace.Event`` records ``trace.from_profiler`` makes of the
    same profiler."""
    return [trace.Event(e.name, e.device, e.start, e.end) for e in events
            if not (e.device and (e.annotation or "Sync" in e.name))]


def fill_pct():
    """100 x filled / slots of the program's block grids
    (``ops/regroup.py:pack_presorted_cluster_major``'s counters) over
    every call of the process, or None before a grid was packed or where
    the program has no such counters."""
    mod = sys.modules.get("raycore_tpu_torch.ops.regroup")
    pack = getattr(mod, "pack_presorted_cluster_major", None)
    slots = getattr(pack, "slots", 0)
    if not slots:
        return None
    return 100.0 * pack.filled / slots


def span_cost_us(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    """Microseconds per enter and exit of the program's ``span`` with no
    profiler recording and under one (host activity only)."""
    import torch
    from raycore_tpu_torch.utils.config import span

    def loop(n):
        t = time.perf_counter()
        for _ in range(n):
            with span("raycore.cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    off = loop(n_off)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = loop(n_on)
    return {"off": off, "on": on}


def main(argv=None, roots=None, device=None) -> int:
    """Run the tool on the cells found under ``roots`` (the working
    directory when None); ``device`` None means the card, which must be
    there (a rehearsal passes the CPU)."""
    import torch
    from cardbench.core import harness
    from cardbench.core.specs import Specs

    p = argparse.ArgumentParser(prog="python -m cardbench.core.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--syncs", action="store_true")
    args = p.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            print("cardbench.core.spans: needs a CUDA card",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    specs = Specs(roots or [Path.cwd()])
    ctx, loop = harness.prepare(specs, args.workload, args.seed, device)
    setup_s = time.perf_counter() - t0
    plan = ctx.cell["trace"]
    k = plan["skip"]

    def timed(n):
        nonlocal k
        lat = []
        for _ in range(n):
            t = time.perf_counter()
            with ctx.span(trace.CALL_SPAN):
                res = loop.call(k)
                with ctx.span(trace.SYNC_SPAN):
                    ctx.sync()
            lat.append(time.perf_counter() - t)
            loop.keep(k, res)
            res = None
            k += 1
        return lat

    untraced = timed(plan["calls"])
    harness.zero_route()
    prof = torch.profiler.profile(activities=harness.activities(device))
    prof.start()
    ctx.tracing = True
    traced = timed(plan["calls"])
    prof.stop()
    ctx.tracing = False
    route = {n: c / plan["calls"] for n, c in harness.read_route().items()}
    events = from_profiler(prof)
    prof = None
    summary = trace.summarize(to_trace(events))
    sp = reduce(events)
    record = harness.Record(setup_s=setup_s, window_s=sum(traced),
                            calls=len(traced), latencies=traced,
                            rays_per_call=loop.rays_per_call,
                            work_bytes=loop.work_bytes, trace=summary)
    metrics = {}
    for m in specs.metrics(args.workload, traced=True):
        v = specs.module("metrics", m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = v
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "power_limit_w": (harness.power_limit_w()
                          if device.type == "cuda" else None),
        "calls": sp.calls,
        "route": route, "metrics": metrics,
        "new": {"stage1_ms": sp.stage_ms(STAGE1),
                "stage1_ops": sp.stage_ops(STAGE1),
                "sync_wait_ms": sp.wait_ms,
                "sweep_fill_pct": fill_pct(),
                "refresh_host_ms": sp.per_call_ms(sp.host_s.get(REFRESH,
                                                                0.0))},
        "device_ms": {n: sp.stage_ms(n) for n in sorted(sp.device_s)},
        "device_ops": {n: sp.stage_ops(n) for n in sorted(sp.ops)},
        "unattributed_ms": sp.per_call_ms(sp.unattributed_s),
        "unattributed_ops": sp.unattributed_ops / sp.calls,
        "linked_share": sp.linked_ops / max(
            1, sum(sp.ops.values()) + sp.unattributed_ops),
        "own_plus_library_ms": summary.per_call_ms(summary.own_s
                                                   + summary.library_s),
        "host_ms": {n: sp.per_call_ms(v) for n, v in sorted(
            sp.host_s.items())},
        "spans_a_call": {n: c / sp.calls for n, c in sorted(
            _counts(events).items())},
        "syncs_a_call": {n: c / sp.calls for n, c in sorted(
            sp.syncs.items())},
        "host_syncs_a_call": summary.syncs / summary.calls,
        "idle_ms": {n: sp.per_call_ms(v) for n, v in sorted(
            sp.idle_s.items(), key=lambda kv: -kv[1])},
        "busy_ms": summary.per_call_ms(summary.busy_s),
        "window_ms": summary.per_call_ms(summary.window_s),
        "breakdown": {"device_ops": summary.device_ops,
                      "idle_gaps": summary.idle_gaps},
        "call_ms": {"untraced": [x * 1e3 for x in untraced],
                    "traced": [x * 1e3 for x in traced],
                    "untraced_median": statistics.median(untraced) * 1e3,
                    "traced_median": statistics.median(traced) * 1e3},
        "span_us": span_cost_us(),
        # Device ranges of spans the profiler did not flag as annotations
        # (core/trace.py would count them as device time).
        "unflagged_span_ranges": sum(
            1 for e in events if e.device and not e.annotation
            and e.name.startswith(PREFIX)),
    }
    if args.syncs:
        out["unnamed_syncs"] = unnamed_syncs(events)
        out["sync_sites"] = sync_sites(lambda: timed(1))
    print(json.dumps(out), flush=True)
    return 0


def _counts(events) -> dict:
    n = defaultdict(int)
    for e in events:
        if not e.device and e.name.startswith(PREFIX):
            n[e.name] += 1
    return n


if __name__ == "__main__":
    sys.exit(main())
