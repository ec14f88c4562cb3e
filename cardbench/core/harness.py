"""One run of one cell: set-up, the measured window, the traced part, the
check against the reference, and the result line.

    set-up    the cell's loop (``loops/<loop>.py``) makes the scene and the
              traffic from the seed and hands them to the program, then
              runs ``warm_calls`` calls, keeping their answers as the
              window will and then dropping them; ``setup_s`` ends here.
    window    calls k = 0, 1, ... each followed by ``synchronize()``, until
              the first call that ends past ``--seconds`` with an answer
              kept for every slot the check compares (at most
              ``GRACE_S`` longer); with
              ``--trace 1`` the profiler covers calls ``trace.skip`` to
              ``trace.skip + trace.calls - 1`` (the window runs on until
              they are done).
    check     after the window the device's peak memory is read, the
              program's state freed, and a sample of the kept answers
              held to the float64 reference (``core/judge.py``).

The metrics are read by their readers (``metrics/<name>.py``): the
cell's end-to-end ones untraced, its per-layer ones traced.

A loop (``loops/<loop>.py``) has a class ``Loop(ctx)`` with

    rays_per_call, work_bytes   what the readers count (``core/work.py``)
    occlusion                   the kind of a sample that names none
    kept                        the answers held for the check
    call(k), keep(k, result)    one call of the window, and what it keeps
    complete()                  an answer kept for every slot checked
    samples(rng, rays_per_slot) the checked samples, drawn from ``rng``
    release()                   drops the program's state
    triangles(key)              world-space float64 triangles of a sample

and optionally ``choose(rng, slots)`` (which answers to keep) and
``judge(sample, v, control=False)`` (its own numbers, below).

A sample is a dict: ``key`` (for ``triangles``), ``rays`` and ``got``
(``core/judge.py:numbers``), and optionally ``occlusion``, its kind: an
occlusion answer, or a closest hit. One loop can so hand one check both
kinds side by side. Each sample is held to the reference by its kind
and, where the loop has ``judge``, by the numbers ``judge(sample, v)``
returns for it: widest gaps of what the loop's call derived from the
program's answers, against a plain float64 reference of its own under
``cardbench/reference/`` (``v`` is the sample's ``triangles``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import subprocess
import sys
import time

import torch

from cardbench.core import judge, trace
from cardbench.core.grids import seed_rng
from cardbench.core.specs import Specs

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "raycore_tpu"})
PROGRAM = "raycore_tpu_torch"
# The kernel wrappers whose ``launches`` counters name a call's route.
ROUTE = (("ops.dense", "phase_a"), ("ops.dense", "run_worklist"),
         ("ops.dense", "run_occlusion"), ("ops.regroup", "run_regrouped"),
         ("ops.regroup", "run_packed"), ("ops.brute", "run_brute"))
CHECK_STREAM = 6
# How long the window may run past its end to reach every checked slot.
GRACE_S = 60.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclasses.dataclass
class Context:
    device: torch.device
    seed: int
    cell: dict
    config: dict
    traffic: dict
    specs: Specs
    program: object
    tracing: bool = False

    def module(self, kind: str, name: str):
        return self.specs.module(kind, name)

    def span(self, name: str):
        """A profiler span while the traced part runs, else nothing."""
        if self.tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def traced_sync(self) -> None:
        """The harness's own sync, only while the traced part runs."""
        if self.tracing:
            with self.span(trace.SYNC_SPAN):
                self.sync()


@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    setup_s: float
    window_s: float
    calls: int
    latencies: list          # seconds, one per call of the window
    rays_per_call: int
    work_bytes: int
    trace: trace.Summary | None = None


def parse(argv):
    p = argparse.ArgumentParser(prog="cardbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(specs: Specs, workload: str, seed: int, device):
    """The cell's loop, set up and warmed."""
    wl = specs.workload(workload)
    cell = specs.json("cells", workload)
    ctx = Context(device=device, seed=seed, cell=cell,
                  config=specs.json("configs", wl["config"]),
                  traffic=specs.json("traffic", wl["traffic"]), specs=specs,
                  program=importlib.import_module(PROGRAM))
    loop = specs.module("loops", cell["loop"]).Loop(ctx)
    if hasattr(loop, "choose"):
        loop.choose(seed_rng(seed, CHECK_STREAM, 0), cell["check"]["slots"])
    # The warm-up keeps answers as the window does, so the allocator's
    # pool holds them; the window then starts with none kept.
    for k in range(cell["warm_calls"]):
        loop.keep(k, loop.call(k))
        ctx.sync()
    loop.kept.clear()
    return ctx, loop


def window(ctx: Context, loop, seconds: float, traced: bool):
    """Run the window; returns (latencies, window seconds, profiler or
    None, route counts per traced call or None)."""
    plan = ctx.cell["trace"] if traced else None
    lat, prof, route = [], None, None
    gc.collect()
    k = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        if plan and k == plan["skip"]:
            zero_route()
            prof = torch.profiler.profile(activities=activities(ctx.device))
            prof.start()
            ctx.tracing = True
        t = time.perf_counter()
        with ctx.span(trace.CALL_SPAN):
            res = loop.call(k)
            with ctx.span(trace.SYNC_SPAN):
                ctx.sync()
        end = time.perf_counter()
        lat.append(end - t)
        loop.keep(k, res)
        res = None
        k += 1
        if ctx.tracing and k == plan["skip"] + plan["calls"]:
            prof.stop()
            ctx.tracing = False
            route = {n: c / plan["calls"]
                     for n, c in read_route().items()}
        if end >= deadline and not ctx.tracing and (
                not plan or k >= plan["skip"] + plan["calls"]) and (
                loop.complete() or end >= deadline + GRACE_S):
            break
    return lat, end - start, prof, route


def activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _wrappers():
    for mod, name in ROUTE:
        try:
            fn = getattr(importlib.import_module(f"{PROGRAM}.{mod}"), name)
        except (ImportError, AttributeError):
            continue
        if hasattr(fn, "launches"):
            yield name, fn


def zero_route() -> None:
    for _, fn in _wrappers():
        fn.launches = 0


def read_route() -> dict:
    return {name: fn.launches for name, fn in _wrappers()}


def check(ctx: Context, loop):
    """Hold a seeded sample of the kept answers to the reference, after
    freeing the program's state. Returns (numbers, samples failed)."""
    chk = ctx.cell["check"]
    samples = loop.samples(seed_rng(ctx.seed, CHECK_STREAM, 1),
                           chk["rays_per_slot"])
    loop.release()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = []
    for s in samples:
        v = loop.triangles(s["key"])
        readings.append(judged(loop, s, v))
        del v
    failed = sum(not judge.passes(r, chk["limits"]) for r in readings)
    return judge.combine(readings), failed


def occlusion(loop, sample) -> bool:
    """A sample's kind: its own where it names one, else the loop's."""
    return sample.get("occlusion", loop.occlusion)


def judged(loop, sample, v, ref=None) -> dict:
    """The numbers of one sample: the program's answers held to the
    reference by the sample's kind, and the loop's own numbers where it
    has ``judge``. ``ref`` is the float64 reference's answer when already
    computed."""
    nums = judge.numbers(v, sample["rays"], sample["got"],
                         occlusion=occlusion(loop, sample), ref=ref)
    if hasattr(loop, "judge"):
        nums = judge.joined(nums, loop.judge(sample, v))
    return nums


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None, roots=(), device=None, t0=None, out=None,
         err=None) -> int:
    """Run one cell once; returns the exit code. ``device`` None means
    the card, which must be there; a test passes the CPU."""
    t0 = time.perf_counter() if t0 is None else t0
    out, err = out or sys.stdout, err or sys.stderr
    args = parse(argv)
    specs = Specs(roots)
    wl = specs.workload(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            print(f"cardbench: {args.workload} needs {wl['chips']} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return 2
        device = torch.device("cuda", 0)
    traced = bool(args.trace)

    ctx, loop = prepare(specs, args.workload, args.seed, device)
    setup_s = time.perf_counter() - t0
    lat, window_s, prof, route = window(ctx, loop, args.seconds, traced)
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    summary = trace.summarize(trace.from_profiler(prof)) if prof else None
    prof = None
    record = Record(setup_s=setup_s, window_s=window_s, calls=len(lat),
                    latencies=lat, rays_per_call=loop.rays_per_call,
                    work_bytes=loop.work_bytes, trace=summary)
    metrics = {}
    for m in specs.metrics(args.workload, traced):
        value = specs.module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    nums, failed = check(ctx, loop)
    verdict = judge.verdict(nums, ctx.cell["check"]["limits"])
    correct = all(ok for _, _, ok in verdict.values())

    found = forbidden_modules()
    if found:
        print(f"cardbench: forbidden modules loaded: {', '.join(found)}",
              file=err)
        return 3

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": correct, "attempted": len(lat), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
        print("route " + json.dumps(route), file=out)
    result["checks"] = {k: {"value": x, "limit": lim}
                        for k, (x, lim, _) in verdict.items()}
    for k, (x, lim, ok) in verdict.items():
        print(f"check {k} {x!r} limit {lim!r} {'ok' if ok else 'FAIL'}",
              file=err)
    print(json.dumps(result), file=out, flush=True)
    return 0
