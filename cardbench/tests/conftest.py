"""Tiny cells for the CPU tests, written into a scratch root beside the
repository's own: they are found by name, as a later PR's new cell is."""
import io
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny workload -> (its config, its traffic, the real cell it copies)
TINY = {
    "tiny.primary": ("tiny-hf", "tiny-primary", "heightfield-1m.primary-1m"),
    "tiny.shadow": ("tiny-hf", "tiny-shadow", "heightfield-1m.shadow2-1m"),
    "tiny.moving": ("tiny-inst", "tiny-moving", "dynamic-128.refit-1m"),
    "tiny.worklist": ("tiny-hf", "tiny-primary-b", "heightfield-1m.primary-256k"),
}


def _load(kind, name):
    return json.loads((REPO / "cardbench" / kind / f"{name}.json").read_text())


def write_tiny_root(root: Path, hf_n: int = 24, rays_per_slot: int = 64) -> Path:
    """A root holding BENCHMARK.json and the files of the tiny cells: the
    real cells' loops, checks and limits at a few thousand triangles and
    rays. Metrics follow the real cell each copies."""
    cb = root / "cardbench"
    for d in ("cells", "configs", "traffic"):
        (cb / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [dict(name=k, config=c, traffic=t, chips=1,
                               why="a tiny CPU cell")
                          for k, (c, t, _) in TINY.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [k for k, (_, _, real) in TINY.items()
                              if real in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    hf = _load("configs", "heightfield-1m")
    hf["scene"]["params"]["n"] = hf_n
    hf["build"]["cluster_size"] = 32
    inst = _load("configs", "dynamic-128")
    p = inst["scene"]["params"]
    p["count"] = 12
    p["centers"] = [[-2.0, -2.0, -1.0], [2.0, 2.0, 1.0]]
    p["bases"][0].update(n_theta=6, n_phi=8)
    # A base without normals: the program's flat normals go unjudged.
    p["bases"].append(dict(kind="box", p_min=[-0.4, -0.4, -0.4],
                           p_max=[0.4, 0.4, 0.4]))
    inst["build"]["cluster_size"] = 32
    for name, cfg in (("tiny-hf", hf), ("tiny-inst", inst)):
        (cb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    traffic = {"tiny-primary": ("primary-1m", dict(side=32, batches=2)),
               "tiny-primary-b": ("primary-256k", dict(side=16, batches=3)),
               "tiny-shadow": ("shadow2-1m", dict(side=32, batches=2)),
               "tiny-moving": ("refit-1m", dict(side=32, half=2.5, sets=4))}
    for name, (real, over) in traffic.items():
        t = _load("traffic", real)
        t["params"].update(over)
        (cb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, (_, _, real) in TINY.items():
        c = _load("cells", real)
        c["warm_calls"] = 2
        c["trace"] = {"skip": 1, "calls": 2}
        c["check"]["slots"] = 2
        c["check"]["rays_per_slot"] = rays_per_slot
        (cb / "cells" / f"{name}.json").write_text(json.dumps(c))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_root(tmp_path)


def run_cell(root, workload, seed=3000000019, trace=0, seconds=0.2):
    """Run a cell on the CPU through the harness: (exit code, the last
    line of standard output parsed, standard error)."""
    from cardbench.core import harness
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      roots=[root, REPO], device=torch.device("cpu"),
                      out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()
