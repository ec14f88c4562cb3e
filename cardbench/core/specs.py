"""Find the benchmark's files by name.

Everything that belongs to one configuration, cell, traffic mix, scene,
loop or metric sits in a file of its own under ``cardbench/``:

    configs/<config>.json     cells/<cell>.json      traffic/<traffic>.json
    scenes/<generator>.py     traffic/<generator>.py loops/<loop>.py
    metrics/<metric>.py

``Specs`` looks each one up under a list of roots, the first match
winning, so a cell can be added (or tried in a scratch directory) by
adding files alone.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = "cardbench"


class Specs:
    def __init__(self, roots):
        self.roots = [Path(r) for r in roots]
        self._modules = {}

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for r in self.roots:
            p = r / BENCH_DIR / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(
            f"no {BENCH_DIR}/{kind}/{name}{suffix} under "
            f"{', '.join(map(str, self.roots))}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        """The Python file ``<kind>/<name>.py``, loaded once."""
        p = self.path(kind, name, ".py")
        if p not in self._modules:
            mod_name = "cardbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
            spec = importlib.util.spec_from_file_location(mod_name, p)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[p] = mod
        return self._modules[p]

    def benchmark(self) -> dict:
        for r in self.roots:
            p = r / "BENCHMARK.json"
            if p.is_file():
                return json.loads(p.read_text())
        raise FileNotFoundError("no BENCHMARK.json under "
                                f"{', '.join(map(str, self.roots))}")

    def workload(self, name: str) -> dict:
        for w in self.benchmark()["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics(self, workload: str, traced: bool) -> list:
        """The cell's metrics: its end-to-end ones untraced, its
        per-layer ones traced (an entry without ``workloads`` is every
        cell's)."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.benchmark()[key]
                if workload in m.get("workloads", [workload])]
