"""Whole runs of tiny cells on the CPU, found by name in a scratch root:
a correct run prints its metrics and checks; a run whose timed path is
broken underneath comes out not correct, and so does the control (the
reference at TF32 in the program's place)."""
import dataclasses
from types import SimpleNamespace

import pytest
import torch
from conftest import REPO, TINY, run_cell, write_tiny_root

import raycore_tpu_torch as rt
from cardbench.core.specs import Specs
from cardbench.reference import tracer

SPECS = Specs([REPO])


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("traced", [0, 1])
def test_a_cell_added_as_files_runs(tiny_root, workload, traced):
    rc, res, err = run_cell(tiny_root, workload, trace=traced)
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 2
    want = {m["name"] for m in Specs([tiny_root]).metrics(workload, traced)}
    if traced:
        # No device ran on the CPU: the roofline reader finds nothing.
        want = {w for w in want if not w.startswith("roofline_pct")}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["window_s"] > 0
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(
        SPECS.json("cells", TINY[workload][2])["check"]["limits"])
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def _half_left_out(fn):
    def entry(scene, rays):
        res = fn(scene, rays)
        keep = torch.arange(res.hit.shape[0]) < res.hit.shape[0] // 2
        return dataclasses.replace(res, hit=res.hit & keep,
                                   t=torch.where(keep, res.t, 0.0),
                                   prim_idx=torch.where(keep, res.prim_idx,
                                                        -1))
    return entry


def _answer_altered(fn):
    def entry(scene, rays):
        res = fn(scene, rays)
        bad = (torch.arange(res.hit.shape[0]) % 16) == 3
        return dataclasses.replace(
            res, t=torch.where(bad, res.t * 1.01, res.t),
            prim_idx=torch.where(bad & res.hit, res.prim_idx + 1,
                                 res.prim_idx),
            triangle=dataclasses.replace(
                res.triangle, metadata=torch.where(
                    bad & res.hit, res.triangle.metadata + 1,
                    res.triangle.metadata)))
    return entry


def _barycentric_altered(fn):
    def entry(scene, rays):
        res = fn(scene, rays)
        bad = ((torch.arange(res.hit.shape[0]) % 16) == 5)[:, None]
        return dataclasses.replace(res, barycentric=torch.where(
            bad, res.barycentric.roll(1, dims=1), res.barycentric))
    return entry


def _triangle_altered(fn):
    def entry(scene, rays):
        res = fn(scene, rays)
        bad = ((torch.arange(res.hit.shape[0]) % 16) == 7)[:, None, None]
        tri = res.triangle
        return dataclasses.replace(res, triangle=dataclasses.replace(
            tri, vertices=torch.where(bad, tri.vertices.roll(1, dims=1),
                                      tri.vertices)))
    return entry


FAULTS = [("tiny.primary", "closest_hit", _half_left_out),
          ("tiny.primary", "closest_hit", _answer_altered),
          ("tiny.worklist", "closest_hit", _half_left_out),
          ("tiny.worklist", "closest_hit", _answer_altered),
          ("tiny.shadow", "any_hit", _half_left_out),
          ("tiny.shadow", "any_hit", _answer_altered),
          ("tiny.moving", "closest_hit", _half_left_out),
          ("tiny.moving", "closest_hit", _answer_altered),
          ("tiny.primary", "closest_hit", _barycentric_altered),
          ("tiny.primary", "closest_hit", _triangle_altered),
          ("tiny.worklist", "closest_hit", _barycentric_altered),
          ("tiny.worklist", "closest_hit", _triangle_altered),
          ("tiny.moving", "closest_hit", _barycentric_altered),
          ("tiny.moving", "closest_hit", _triangle_altered)]


@pytest.mark.parametrize("workload,entry,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload,
                                            entry, fault):
    monkeypatch.setattr(rt, entry, fault(getattr(rt, entry)))
    rc, res, err = run_cell(tiny_root, workload)
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] >= 1


def test_a_refresh_that_returns_its_state_unchanged_is_not_correct(
        tiny_root, monkeypatch):
    monkeypatch.setattr(rt, "refresh_instances", lambda scene, mgr: scene)
    rc, res, err = run_cell(tiny_root, "tiny.moving")
    assert rc == 0, err
    assert res["correct"] is False


def _control(scene_tris, occlusion):
    """The reference at TF32 in the program's place."""
    def entry(scene, rays):
        v = scene_tris()
        o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
        out = tracer.trace(v, o, d, rays.t_min.reshape(-1),
                           rays.t_max.reshape(-1), occlusion=occlusion,
                           precision="tf32")
        idx = out["idx"]
        u, w = out["bary"].unbind(1)
        # The reference's own payload: the generated triangle it names.
        return SimpleNamespace(
            hit=out["hit"], t=out["t"].float(), prim_idx=idx,
            instance_idx=torch.full_like(idx, -1),
            barycentric=torch.stack([1 - u - w, u, w], 1).float(),
            triangle=SimpleNamespace(metadata=idx,
                                     vertices=v[idx.clamp_min(0)].float()))
    return entry


@pytest.mark.parametrize("seed", [3000000019, 2147483711, 17])
@pytest.mark.parametrize("workload,entry", [("tiny.primary", "closest_hit"),
                                            ("tiny.shadow", "any_hit")])
def test_the_control_is_not_correct(tmp_path, monkeypatch, workload, entry,
                                    seed):
    # The cells' n = 707 would not fit a CPU test; on this coarser grid
    # the control's products still cancel enough to fail.
    root = write_tiny_root(tmp_path, hf_n=360, rays_per_slot=512)
    params = Specs([root]).json("configs", "tiny-hf")["scene"]["params"]
    scene = SPECS.module("scenes", "heightfield").generate(params)
    tris = lambda: torch.as_tensor(scene["verts"][scene["faces"]],
                                   dtype=torch.float64)
    monkeypatch.setattr(rt, entry, _control(tris, entry == "any_hit"))
    rc, res, err = run_cell(root, workload, seed=seed)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def test_run_without_a_card_prints_no_result(tmp_path):
    import os
    import subprocess
    import sys
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "cardbench/run.py", "--workload",
                        "heightfield-1m.primary-256k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
