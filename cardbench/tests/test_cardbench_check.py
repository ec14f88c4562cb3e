"""The check's contract beyond one query a cell: a loop that hands one
check closest hits and occlusion answers side by side, each judged by
its own kind, and numbers of its own held to its own plain reference;
and the four cells' CPU twins judged as before."""
import dataclasses
import io
import json

import pytest
import torch
from conftest import REPO, TINY, run_cell, write_tiny_root

import raycore_tpu_torch as rt

# A bounce of a path tracer in small: closest hits of the traffic's rays,
# then occlusion rays from each hit toward the cell's light (the glue),
# through any_hit. Found by name in the scratch root, as a later cell's
# loop would be; its plain reference of the glue sits in the loop file
# itself, where a benchmark loop's would sit under cardbench/reference/.
BOUNCE_LOOP = '''
import torch

from cardbench.core import judge
from cardbench.reference.tracer import round_tf32


def shadow_rays(o, d, t, hit, light, lift, dtype):
    """Rays from each hit (o + t d, moved back ``lift`` along d) toward
    ``light``: origins, unit directions and t_max, the distance to the
    light (0 where nothing was hit), all in ``dtype``."""
    o, d, t, light = (x.to(dtype) for x in (o, d, t, light))
    start = o + (t - lift)[:, None] * d
    to = light - start
    dist = to.norm(dim=1)
    return start, to / dist[:, None], torch.where(hit, dist, 0.0)


class Loop:
    occlusion = False

    def __init__(self, ctx):
        self.ctx = ctx
        self.query = ctx.module("loops", "query").Loop(ctx)
        bounce = ctx.cell["bounce"]
        self.light = torch.tensor(bounce["light"], dtype=torch.float64,
                                  device=ctx.device)
        self.lift = bounce["lift"]
        self.glue_fault = bounce.get("glue_fault", 0.0)
        self.tagged = bounce.get("tagged", True)
        self.rays_per_call = 2 * self.query.rays_per_call
        self.work_bytes = self.query.work_bytes
        self.kept = {}

    def call(self, k):
        rt, q = self.ctx.program, self.query
        b = k % len(q.rays)
        batch = q.batches[b]
        hits = rt.closest_hit(q.scene, q.rays[b])
        o, d, t_max = shadow_rays(batch["o"], batch["d"], hits.t, hits.hit,
                                  self.light, self.lift, torch.float32)
        if self.glue_fault:
            bad = (torch.arange(o.shape[0], device=o.device) % 16) == 3
            o = o + torch.where(bad, self.glue_fault, 0.0)[:, None]
        shadow = dict(o=o, d=d, t_min=torch.zeros_like(t_max), t_max=t_max)
        occluded = rt.any_hit(q.scene, rt.Ray.create(
            o, d, t_min=shadow["t_min"], t_max=t_max))
        return hits, shadow, occluded

    def keep(self, k, res):
        self.kept[k % len(self.query.rays)] = res

    def complete(self):
        return len(self.kept) == len(self.query.rays)

    def samples(self, rng, per_slot):
        """Per kept call, a closest-hit sample and an occlusion sample of
        the same rows; the latter carries the hits its rays came from."""
        q, out = self.query, []
        for slot in sorted(self.kept):
            hits, shadow, occluded = self.kept[slot]
            batch = q.batches[slot]
            rows = torch.as_tensor(rng.choice(q.rays_per_call, per_slot,
                                              replace=False))
            hit = hits.hit[rows]
            idx = torch.where(hit, hits.prim_idx[rows].long(), -1)
            out.append(dict(
                key=None, occlusion=False,
                rays={k: x[rows] for k, x in batch.items()},
                got=dict(hit=hit, idx=idx, t=hits.t[rows],
                         bary=hits.barycentric[rows][:, 1:],
                         payload=hits.triangle.vertices[rows].reshape(-1, 9),
                         want=q.named_vertices(idx))))
            o_hit = occluded.hit[rows]
            s = dict(key=None,
                     rays={k: x[rows] for k, x in shadow.items()},
                     got=dict(hit=o_hit, t=occluded.t[rows],
                              idx=torch.where(o_hit, occluded.prim_idx[rows]
                                              .long(), -1)),
                     glue=dict(o=batch["o"][rows], d=batch["d"][rows],
                               t=hits.t[rows], hit=hit))
            if self.tagged:
                s["occlusion"] = True
            out.append(s)
        return out

    def judge(self, sample, v, control=False):
        """``glue_gap``: the occlusion rays against the float64 glue of
        the hits they came from (origin over the distance to the light,
        direction, t_max over that distance); with ``control`` that glue
        at TF32 takes the program's place."""
        if "glue" not in sample:
            return {}
        g = sample["glue"]
        o, d, t_max = shadow_rays(g["o"], g["d"], g["t"], g["hit"],
                                  self.light, self.lift, torch.float64)
        if control:
            got = shadow_rays(*(round_tf32(x.float()) for x in (
                g["o"], g["d"], g["t"])), g["hit"],
                round_tf32(self.light.float()), self.lift, torch.float32)
        else:
            r = sample["rays"]
            got = r["o"], r["d"], r["t_max"]
        scale = torch.where(t_max > 0, t_max, 1.0)
        gap = torch.stack([
            (got[0].double() - o).abs().amax(1) / scale,
            (got[1].double() - d).abs().amax(1),
            (got[2].double() - t_max).abs() / scale])
        return {"glue_gap": judge.widest(gap.amax(0)[g["hit"]])}

    def release(self):
        self.query.release()
        self.kept = None

    def triangles(self, key):
        return self.query.triangles(key)
'''

LIMITS = {"t_gap": 2e-5, "claim_gap": 1e-3, "missed_by": 1e-3,
          "bary_gap": 1e-3, "tri_gap": 0.0, "glue_gap": 1e-5}


def write_bounce_root(root, limits=LIMITS, **bounce):
    """The tiny roots with one more cell, ``tiny.bounce``: the bounce
    loop on the tiny heightfield, its rays leaving the surface toward two
    low lights, so that most hit a crest, and each such ray meets another
    triangle where it leaves the surface again."""
    write_tiny_root(root, rays_per_slot=128)
    cb = root / "cardbench"
    (cb / "loops").mkdir(exist_ok=True)
    (cb / "loops" / "bounce.py").write_text(BOUNCE_LOOP)
    traffic = json.loads((cb / "traffic" / "tiny-shadow.json").read_text())
    traffic["params"]["lights"] = [[2.5, -2.5, 0.6], [-2.0, 2.0, 0.5]]
    (cb / "traffic" / "tiny-bounce.json").write_text(json.dumps(traffic))
    cell = dict(loop="bounce", entry="closest_hit", warm_calls=2,
                trace=dict(skip=1, calls=2),
                check=dict(slots=2, rays_per_slot=128, limits=limits),
                bounce=dict(dict(light=[0.5, -0.5, 3.0], lift=0.05), **bounce))
    (cb / "cells" / "tiny.bounce.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny.bounce", config="tiny-hf",
                                   traffic="tiny-bounce", chips=1,
                                   why="a tiny CPU cell"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _pick(take, a, b):
    """Rows of hit results ``a`` where ``take``, else of ``b``."""
    def pick(x, y):
        return torch.where(take.view(-1, *[1] * (x.dim() - 1)), x, y)
    tri = {f.name: pick(getattr(a.triangle, f.name), getattr(b.triangle,
                                                               f.name))
           for f in dataclasses.fields(b.triangle)}
    return dataclasses.replace(
        b, hit=pick(a.hit, b.hit), t=pick(a.t, b.t),
        barycentric=pick(a.barycentric, b.barycentric),
        prim_idx=pick(a.prim_idx, b.prim_idx),
        instance_idx=pick(a.instance_idx, b.instance_idx),
        triangle=dataclasses.replace(b.triangle, **tri))


def _farther_triangle(fn):
    """Closest hits that name the next triangle along the ray, with its
    own t, barycentrics and vertices, where there is one."""
    def entry(scene, rays):
        res = fn(scene, rays)
        past = torch.where(res.hit, res.t * 1.001, rays.t_min)
        nxt = fn(scene, dataclasses.replace(rays, t_min=past))
        return _pick(res.hit & nxt.hit, nxt, res)
    return entry


def _occluder_behind(fn):
    """Occlusion answers that name the occluder behind the ray's origin,
    outside (0, t_max), where there is one."""
    def entry(scene, rays):
        res = fn(scene, rays)
        back = fn(scene, dataclasses.replace(
            rays, d=-rays.d, t_min=torch.zeros_like(rays.t_min),
            t_max=torch.full_like(rays.t_max, 10.0)))
        take = back.hit & (rays.t_max > 0)
        return dataclasses.replace(
            res, hit=res.hit | take,
            prim_idx=torch.where(take, back.prim_idx, res.prim_idx))
    return entry


def _failing(res) -> set:
    return {k for k, c in res["checks"].items()
            if c["limit"] is None or not c["value"] <= c["limit"]}


def test_closest_hits_and_occlusion_answers_side_by_side_are_correct(
        tmp_path):
    root = write_bounce_root(tmp_path)
    rc, res, err = run_cell(root, "tiny.bounce")
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["checks"]) == set(LIMITS)
    assert res["checks"]["glue_gap"]["value"] > 0


@pytest.mark.parametrize("entry,fault,number",
                         [("any_hit", _occluder_behind, "claim_gap"),
                          ("closest_hit", _farther_triangle, "t_gap")],
                         ids=["occluder_behind", "farther_triangle"])
def test_a_planted_answer_of_either_kind_is_not_correct(
        tmp_path, monkeypatch, entry, fault, number):
    root = write_bounce_root(tmp_path)
    monkeypatch.setattr(rt, entry, fault(getattr(rt, entry)))
    rc, res, err = run_cell(root, "tiny.bounce")
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] >= 1
    assert _failing(res) == {number}, res["checks"]


def test_an_occlusion_answer_judged_as_a_closest_hit_is_not_correct(
        tmp_path):
    root = write_bounce_root(tmp_path, tagged=False)
    rc, res, err = run_cell(root, "tiny.bounce")
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] >= 1
    # An occlusion answer's t names no nearest hit.
    assert _failing(res) and _failing(res) <= {"t_gap", "claim_gap"}, \
        res["checks"]


def test_a_planted_glue_fault_fails_the_loops_own_number(tmp_path):
    root = write_bounce_root(tmp_path, glue_fault=1e-3)
    rc, res, err = run_cell(root, "tiny.bounce")
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] >= 1
    assert _failing(res) == {"glue_gap"}, res["checks"]


def test_a_loops_own_number_without_a_limit_fails(tmp_path):
    limits = {k: x for k, x in LIMITS.items() if k != "glue_gap"}
    root = write_bounce_root(tmp_path, limits=limits)
    rc, res, err = run_cell(root, "tiny.bounce")
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] >= 1
    assert _failing(res) == {"glue_gap"}, res["checks"]
    assert res["checks"]["glue_gap"]["limit"] is None


def test_the_control_of_a_loop_with_its_own_numbers_is_not_correct(
        tmp_path):
    from cardbench import control
    root = write_bounce_root(tmp_path)
    out = io.StringIO()
    rc = control.main(["--workload", "tiny.bounce", "--seeds", "17",
                       "--seconds", "0.2"], roots=[root, REPO],
                      device=torch.device("cpu"), out=out)
    assert rc == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last["program_correct"] == 1 and last["control_correct"] == 0
    assert set(last["lower"]) == set(LIMITS)
    # The loop's own limit lies between its two readings.
    assert last["lower"]["glue_gap"] <= LIMITS["glue_gap"] \
        < last["upper"]["glue_gap"]


# The four cells' CPU twins at seed 2147483711, as the parent harness
# judged them (one sample kind a loop, no loop's own numbers).
PARENT = {
    "tiny.moving": (True, 0, {"bary_gap": 1.1267145494375796e-07,
                              "claim_gap": 1.1463359035031582e-07,
                              "missed_by": 0.0,
                              "t_gap": 5.18352670558096e-08,
                              "tri_gap": 0.0}),
    "tiny.primary": (True, 0, {"bary_gap": 9.751039420358154e-08,
                               "claim_gap": 2.0714999275943862e-07,
                               "missed_by": 0.0,
                               "t_gap": 1.7335198834809882e-07,
                               "tri_gap": 0.0}),
    "tiny.shadow": (True, 0, {"claim_gap": 0.0, "missed_by": 0.0}),
    "tiny.worklist": (True, 0, {"bary_gap": 9.314462889875585e-08,
                                "claim_gap": 2.0233905252836105e-07,
                                "missed_by": 0.0,
                                "t_gap": 2.023390523832828e-07,
                                "tri_gap": 0.0}),
}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_existing_cells_are_judged_as_before(tiny_root, workload):
    correct, failed, checks = PARENT[workload]
    rc, res, err = run_cell(tiny_root, workload, seed=2147483711)
    assert rc == 0, err
    assert (res["correct"], res["failed"]) == (correct, failed)
    assert list(res["checks"]) == sorted(checks)
    assert {k: c["value"] for k, c in res["checks"].items()} == \
        pytest.approx(checks, rel=1e-6, abs=1e-15)


# The control's readings of two twins at seed 2147483711, as the parent's
# control.py read them: (program, control, each side correct).
PARENT_CONTROL = {
    "tiny.primary": ({"bary_gap": 9.751039420358154e-08,
                      "claim_gap": 2.0714999275943862e-07, "missed_by": 0.0,
                      "t_gap": 1.7335198834809882e-07, "tri_gap": 0.0},
                     {"bary_gap": 0.011458016638646318,
                      "claim_gap": 0.00014819320676953855, "missed_by": 0.0,
                      "t_gap": 0.00014819320676953855, "tri_gap": 0.0},
                     True, False),
    "tiny.shadow": ({"claim_gap": 0.0, "missed_by": 0.0},
                    {"claim_gap": 0.0, "missed_by": 0.0}, True, True),
}


@pytest.mark.parametrize("workload", sorted(PARENT_CONTROL))
def test_the_existing_cells_controls_read_as_before(tiny_root, workload):
    from cardbench import control
    prog, ctl, prog_ok, ctl_ok = PARENT_CONTROL[workload]
    out = io.StringIO()
    rc = control.main(["--workload", workload, "--seeds", "2147483711",
                       "--seconds", "0.2"], roots=[tiny_root, REPO],
                      device=torch.device("cpu"), out=out)
    assert rc == 0
    seed = json.loads(out.getvalue().strip().splitlines()[0])
    assert (seed["program_correct"], seed["control_correct"]) == \
        (prog_ok, ctl_ok)
    assert seed["program"] == pytest.approx(prog, rel=1e-6, abs=1e-15)
    assert seed["control"] == pytest.approx(ctl, rel=1e-6, abs=1e-15)
