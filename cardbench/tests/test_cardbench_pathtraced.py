"""The path-traced frame's cell in small on the CPU: the configuration,
traffic and cell of ``heightfield-1m-pt.frame-1080p`` at a 1,152-
triangle heightfield, a 32 x 24, 3-bounce frame and 3 sets, in a
scratch root.
The twin is correct; a glue fault planted under the timed path (the
next-event factor ``n_lights`` dropped, the un-permute skipped, eps 0),
a frame that does not repeat itself and an occluder reported on a dead
lane are each not correct, on their own number; the control (the glue
reference in float16, the tracer at TF32) is not correct."""
import dataclasses
import io
import json

import pytest
import torch
from conftest import REPO, run_cell, write_tiny_root

from raycore_tpu_torch.accel import dispatch
from raycore_tpu_torch.render import pathtracer as tp

CELL = "heightfield-1m-pt.frame-1080p"
TWIN = "tiny.pathtraced"


def write_pathtraced_root(root):
    """The tiny roots with one more cell, the path-traced frame's twin."""
    write_tiny_root(root)
    cb = root / "cardbench"
    load = lambda kind, name: json.loads(
        (REPO / "cardbench" / kind / f"{name}.json").read_text())
    cfg = load("configs", "heightfield-1m-pt")
    cfg["name"] = "tiny-pt"
    cfg["scene"]["params"]["n"] = 24
    cfg["build"]["cluster_size"] = 32
    cfg["render"].update(width=32, height=24, bounces=3, tile_size=256)
    (cb / "configs" / "tiny-pt.json").write_text(json.dumps(cfg))
    traffic = load("traffic", "frame-1080p")
    traffic["params"]["sets"] = 3
    (cb / "traffic" / "tiny-frames.json").write_text(json.dumps(traffic))
    cell = load("cells", CELL)
    cell.update(warm_calls=3, trace=dict(skip=1, calls=2))
    cell["check"].update(slots=2, rays_per_slot=96)
    (cb / "cells" / f"{TWIN}.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name=TWIN, config="tiny-pt",
                                   traffic="tiny-frames", chips=1,
                                   why="a tiny CPU cell"))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    for m, r in zip(bench["end_to_end"] + bench["per_layer"],
                    real["end_to_end"] + real["per_layer"]):
        if CELL in r.get("workloads", []):
            m["workloads"].append(TWIN)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def pt_root(tmp_path):
    return write_pathtraced_root(tmp_path)


def _failing(res) -> set:
    return {k for k, c in res["checks"].items()
            if c["limit"] is None or not c["value"] <= c["limit"]}


@pytest.mark.parametrize("traced", [0, 1])
def test_the_twin_is_correct(pt_root, traced):
    rc, res, err = run_cell(pt_root, TWIN, trace=traced)
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    limits = json.loads((REPO / "cardbench" / "cells" / f"{CELL}.json")
                        .read_text())["check"]["limits"]
    assert set(res["checks"]) == set(limits)
    assert res["checks"]["glue_gap"]["value"] > 0
    assert res["checks"]["pixel_gap"]["value"] > 0
    if traced:
        # No device ran on the CPU: the roofline reader finds nothing, and
        # the tiny frame's queries take no route that fills K2's rows.
        assert set(res["metrics"]) == {"torch_ops_ms.frame",
                                       "port_kernels_ms.frame",
                                       "host_syncs.frame", "idle_pct.frame",
                                       "live_pct.pt"}
        assert 0 < res["metrics"]["live_pct.pt"]["value"] < 100
    else:
        assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def _with_arg(i, value):
    def fault(fn):
        def wrapped(*a, **kw):
            a = list(a)
            a[i] = value
            return fn(*a, **kw)
        return wrapped
    return fault


def _one_light(fn):
    return lambda *a, **kw: fn(*a, **dict(kw, n_lights=1))


def _not_unpermuted(fn):
    return lambda radiance, order, *a: fn(radiance,
                                          torch.arange(order.numel()), *a)


def _drifting(fn):
    calls = []

    def wrapped(*a, **kw):
        calls.append(None)
        return fn(*a, **kw) * (1.0 + 1e-6 * len(calls))
    return wrapped


FAULTS = {
    "n_lights_dropped": ([("_pt_shade_and_sample", _one_light)],
                         "pixel_gap"),
    "unpermute_skipped": ([("_image", _not_unpermuted)], "pixel_gap"),
    "eps_zero": ([("_pt_prep_nee", _with_arg(11, 0.0)),
                  ("_pt_shade_and_sample", _with_arg(22, 0.0))],
                 "glue_gap"),
    "frames_drift": ([("_image", _drifting)], "rerender_gap"),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(pt_root, monkeypatch, name):
    patches, number = FAULTS[name]
    for attr, fault in patches:
        monkeypatch.setattr(tp, attr, fault(getattr(tp, attr)))
    rc, res, err = run_cell(pt_root, TWIN)
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] >= 1
    assert number in _failing(res), res["checks"]
    if name != "eps_zero":
        # Self-intersecting shadow and bounce rays fail the queries' own
        # numbers too; the other faults leave the queries right.
        assert _failing(res) == {number}, res["checks"]


def test_an_occluder_on_a_dead_lane_is_not_correct(pt_root, monkeypatch):
    any_hit = dispatch.scene_any_hit

    def hits_dead(scene, rays, *a, **kw):
        res = any_hit(scene, rays, *a, **kw)
        return dataclasses.replace(res, hit=res.hit | (rays.t_max < 0))
    monkeypatch.setattr(dispatch, "scene_any_hit", hits_dead)
    rc, res, err = run_cell(pt_root, TWIN)
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] >= 1
    # The occluder names no triangle (``claim_gap``); the glue and the
    # image do not read it.
    assert "dead_hits" in _failing(res) <= {"dead_hits", "claim_gap"}, \
        res["checks"]


def test_the_control_is_not_correct(pt_root):
    from cardbench import control
    out = io.StringIO()
    rc = control.main(["--workload", TWIN, "--seeds", "17",
                       "--seconds", "0.2"], roots=[pt_root, REPO],
                      device=torch.device("cpu"), out=out)
    assert rc == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last["program_correct"] == 1 and last["control_correct"] == 0
    limits = last["limits"]
    for k in ("glue_gap", "pixel_gap", "t_gap"):
        assert last["lower"][k] <= limits[k] < last["upper"][k], k
