"""The plain reference on a hand-made scene, and its TF32 control."""
import math

import torch

from cardbench.core import judge
from cardbench.reference import tracer

# Triangle 0: z = 0 over the triangle (0,0)-(2,0)-(0,2); triangle 1: z = 1
# over (0,0)-(1,0)-(0,1); triangle 2: a wall x = 3 facing -x.
V = torch.tensor([[[0, 0, 0], [2, 0, 0], [0, 2, 0]],
                  [[0, 0, 1], [1, 0, 1], [0, 1, 1]],
                  [[3, -1, -1], [3, 1, -1], [3, 0, 2]]], dtype=torch.float64)


def rays(o, d, t_max=math.inf):
    o = torch.tensor(o, dtype=torch.float64)
    d = torch.tensor(d, dtype=torch.float64)
    S = o.shape[0]
    return dict(o=o, d=d, t_min=torch.zeros(S, dtype=torch.float64),
                t_max=torch.full((S,), t_max, dtype=torch.float64))


def trace(r, **kw):
    return tracer.trace(V, r["o"], r["d"], r["t_min"], r["t_max"], **kw)


def test_closest_hits_by_hand():
    r = rays([[0.25, 0.25, 5], [1.5, 0.2, 5], [5, 5, 5], [0, 0.5, 0]],
             [[0, 0, -1], [0, 0, -1], [0, 0, -1], [1, 0, 0]])
    out = trace(r, occlusion=False, chunk=2)
    assert out["hit"].tolist() == [True, True, False, True]
    assert out["idx"].tolist() == [1, 0, -1, 2]
    assert torch.allclose(out["t"][[0, 1, 3]],
                          torch.tensor([4.0, 5.0, 3.0], dtype=torch.float64))
    # Depths: min(u, v, 1 - u - v) of the winner.
    assert math.isclose(float(out["depth"][0]), 0.25)
    assert math.isclose(float(out["depth"][1]), 0.1)


def test_occlusion_by_hand():
    r = rays([[0.25, 0.25, 5], [0.25, 0.25, 0.5], [1.5, 0.2, 5]],
             [[0, 0, -1], [0, 0, 1], [0, 0, -1]], t_max=4.5)
    out = trace(r, occlusion=True)
    # Ray 0 meets triangle 1 at 4 (inside t_max), ray 1 triangle 1 at 0.5,
    # ray 2 reaches triangle 0 only at 5, past t_max.
    assert out["hit"].tolist() == [True, True, False]
    assert math.isclose(float(out["depth"][0]), min(0.25, 0.5 / 4.5))
    assert math.isclose(float(out["depth"][1]), min(0.25, 0.5 / 4.5))


def test_evaluate_names_the_triangle():
    r = rays([[0.25, 0.25, 5], [1.5, 1.5, 5]], [[0, 0, -1], [0, 0, -1]])
    margin, t = tracer.evaluate(V, torch.tensor([0, 0]), r["o"], r["d"])
    assert math.isclose(float(t[0]), 5.0)
    assert math.isclose(float(margin[0]), 0.125)
    assert math.isclose(float(margin[1]), -0.5)
    bad, _ = tracer.evaluate(V, torch.tensor([7, -1]), r["o"], r["d"])
    assert bool(torch.isnan(bad).all())


def test_judge_reads_zero_on_the_reference_and_more_on_faults():
    r = rays([[0.25, 0.25, 5], [1.5, 0.2, 5], [5, 5, 5]],
             [[0, 0, -1], [0, 0, -1], [0, 0, -1]])
    ref = trace(r, occlusion=False)
    got = dict(hit=ref["hit"], idx=ref["idx"], t=ref["t"].float())
    nums = judge.numbers(V, r, got, occlusion=False)
    assert max(nums.values()) < 1e-7
    # Ray 0 answered with the farther triangle 0.
    far = dict(hit=ref["hit"], idx=torch.tensor([0, 0, -1]),
               t=torch.tensor([5.0, 5.0, 0.0]))
    assert judge.numbers(V, r, far, occlusion=False)["t_gap"] == 0.25
    # A t nearer than the nearest hit names no true hit at that t.
    near = dict(hit=ref["hit"], idx=ref["idx"],
                t=torch.tensor([3.0, 5.0, 0.0]))
    nums = judge.numbers(V, r, near, occlusion=False)
    assert nums["t_gap"] < 1e-7 and nums["claim_gap"] == 0.25
    lost = dict(hit=torch.tensor([False, True, False]), idx=ref["idx"],
                t=ref["t"])
    assert judge.numbers(V, r, lost, occlusion=False)["missed_by"] == 0.25
    unnamed = dict(hit=ref["hit"], idx=torch.tensor([9, 0, -1]),
                   t=ref["t"])
    assert judge.numbers(V, r, unnamed,
                         occlusion=False)["claim_gap"] == judge.UNNAMED


def test_round_tf32():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-10,
                      -(1 + 3 * 2**-11), float("inf"), 3.0e38])
    got = tracer.round_tf32(x)
    want = [1.0, 1.0, 1 + 2**-9, 1 + 2**-10, -(1 + 2**-9), float("inf")]
    assert got[:6].tolist() == want
    assert math.isfinite(float(got[6]))


def test_the_tf32_control_departs_on_small_triangles():
    # A fine fan of thin triangles far from the origin: the four products
    # cancel, and TF32's 10 mantissa bits move the answers.
    g = torch.Generator().manual_seed(1)
    base = torch.rand((2000, 1, 3), generator=g, dtype=torch.float64)
    base[..., 2] = 0
    v = base + torch.tensor([[0, 0, 0], [2e-3, 0, 0], [0, 2e-3, 0]],
                            dtype=torch.float64)
    o = (base[:, 0] + 5e-4).clone()
    o[:, 2] = 3.0
    r = dict(o=o, d=torch.tensor([[0.0, 0.0, -1.0]]).double().expand_as(o),
             t_min=torch.zeros(2000, dtype=torch.float64),
             t_max=torch.full((2000,), math.inf, dtype=torch.float64))
    ref = tracer.trace(v, r["o"], r["d"], r["t_min"], r["t_max"],
                       occlusion=False)
    ctl = tracer.trace(v, r["o"], r["d"], r["t_min"], r["t_max"],
                       occlusion=False, precision="tf32")
    nums = judge.numbers(v, r, dict(hit=ctl["hit"], idx=ctl["idx"],
                                    t=ctl["t"]), occlusion=False, ref=ref)
    assert max(nums.values()) > 1e-3
