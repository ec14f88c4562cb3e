"""The division-free reject of the dense sweep K6 (``ops/brute.py:
u_may_pass``) and the sweep routed through it (``run_brute_model``), on
the CPU.

The kernel skips the division, u, v and t for every (ray, triangle) test
that ``u_may_pass`` refuses, unless another ray of its warp may pass. So
the reject must never refuse a test whose exact u = RN(unum * RN(1/det))
lies in [0, 1]: on adversarial (unum, det) pairs (+-0, +-2^-126,
subnormals, +-inf, NaN, u just inside and just outside [0, 1]), on
random bit patterns, and on the pairs of meshes with degenerate
triangles. ``run_brute_model`` must then equal ``run_brute_plain`` bit
for bit, and meet the contract that tests/test_torch_brute_pallas.py
holds the plain sweep to against the JAX package's kernel in interpret
mode: equal hit masks and prims, t within rtol 1e-5 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
from raycore_tpu.ops import pallas_brute as j_pb
from raycore_tpu_torch.ops import brute as t_pb
from test_torch_brute_pallas import _check, _meshes, _rays
from torch_adversarial import brute_case
from torch_parity import bits, np_

F32 = np.float32


def _exact_u_passes(det, unum):
    """The exact path's u test: u = RN(unum * RN(1/det)) in [0, 1]."""
    u = unum * (1.0 / det)
    return (u >= 0.0) & (u <= 1.0)


def _adversarial_pairs():
    """Every (unum, det) of a grid of special dets and numerators built
    around them: u = unum/det at 0, 1, just inside and just outside each,
    and the special values themselves."""
    specials = [0.0, 2.0 ** -149, 3 * 2.0 ** -140, 2.0 ** -130,
                2.0 ** -128, 2.0 ** -127, 2.0 ** -126, 2.0 ** -100,
                2.0 ** -60, 1e-30, 2.0 ** -20, 0.37, 1.0, 3.0, 2.0 ** 60,
                2.0 ** 100, 2.0 ** 126, 2.0 ** 127, float(np.finfo(F32).max),
                np.inf]
    dets = np.array([s * sg for s in specials for sg in (1.0, -1.0)]
                    + [np.nan], F32)
    ulp = 2.0 ** -23
    scales = [0.0, 1.0, 1 + ulp, 1 - ulp / 2, 1 + 2 * ulp, 1 - ulp,
              1 + 2.0 ** -20, 1 + 2.0 ** -19, 2.0 ** -20, 2.0 ** -21,
              2.0 ** -30, 2.0 ** -149, 0.5, 2.0]
    rows = []
    for det in dets:
        for s in scales:
            for sg in (1.0, -1.0):
                with np.errstate(all="ignore"):
                    rows.append((det, F32(sg * s) * det))
                    rows.append((det, np.nextafter(F32(sg * s) * det,
                                                   F32(np.inf))))
                    rows.append((det, np.nextafter(F32(sg * s) * det,
                                                   F32(-np.inf))))
        for x in specials + [np.nan]:
            for sg in (1.0, -1.0):
                rows.append((det, F32(sg * x)))
    det, unum = np.array(rows, F32).T
    return torch.as_tensor(det), torch.as_tensor(unum)


def _random_pairs(kind, n=1 << 20, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "bits":
        # Any float32 bit pattern, NaNs and infs included.
        raw = rng.integers(0, 2 ** 32, (2, n), dtype=np.uint64)
        det, unum = raw.astype(np.uint32).view(F32)
    else:
        # Numerators within a few ulps of 0 and of det, across exponents.
        det = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-140, 127, n)
               * rng.choice([-1, 1], n)).astype(F32)
        near = rng.choice([0.0, 1.0, -1.0, 2.0 ** -20, 1 + 2.0 ** -20], n)
        wiggle = 1 + rng.integers(-4, 5, n) * 2.0 ** -24
        with np.errstate(all="ignore"):
            unum = (det.astype(np.float64) * near * wiggle).astype(F32)
    return torch.as_tensor(det), torch.as_tensor(unum)


@pytest.mark.parametrize("kind", ["adversarial", "bits", "near"])
def test_u_may_pass_never_refuses_an_accepted_u(kind):
    det, unum = (_adversarial_pairs() if kind == "adversarial"
                 else _random_pairs(kind))
    may = t_pb.u_may_pass(det, unum)
    ok = _exact_u_passes(det, unum)
    bad = ok & ~may
    assert not bool(bad.any()), (det[bad][:5], unum[bad][:5])
    # Not vacuous: it refuses most of what the exact test refuses.
    refused = int((~ok & ~may).sum())
    assert refused > 0.5 * int((~ok).sum())


def test_u_may_pass_on_special_dets():
    """det +-0 refuses every numerator (u = +-inf or NaN), NaN det and
    NaN numerators are refused (u = NaN), det +-inf refuses only a NaN or
    same-signed infinite numerator (u = NaN; else u = +-0 passes)."""
    inf, nan = float("inf"), float("nan")
    det = torch.tensor([0.0, -0.0, 0.0, nan, 1.0, inf, -inf, inf, -inf])
    unum = torch.tensor([1e-30, -3.0, 0.0, 0.5, nan, 5.0, -5.0, nan, -inf])
    want = torch.tensor([False, False, False, False, False, True, True,
                         False, False])
    assert torch.equal(t_pb.u_may_pass(det, unum), want)
    assert float(np.float32(t_pb.U_MARGIN_HI)) == t_pb.U_MARGIN_HI


@pytest.mark.parametrize("mesh", ["adversarial", "sphere"])
def test_u_may_pass_on_a_mesh_own_pairs(mesh):
    """Every (ray, triangle) test of a mesh: the reject refuses none that
    passes u, and refuses most tests overall."""
    if mesh == "adversarial":
        tbl, o, d, t_min, t_max = (torch.as_tensor(a) for a in brute_case())
    else:
        _, tm = _meshes("sphere")
        tbl = t_pb.make_tri_table(tm)
        o, d = (torch.as_tensor(a) for a in _rays((300,), seed=5))
        d[:, :2] = torch.as_tensor(
            np.random.default_rng(5).normal(0, 0.2, (300, 2)), dtype=d.dtype)
        t_min, t_max = torch.zeros(300), torch.full((300,), float("inf"))
    verts = tbl.T.reshape(-1, 3, 3)
    _, _, u, _, may = t_pb.pair_tests(o, d, t_min, t_max, verts)
    passes = (u >= 0.0) & (u <= 1.0)
    assert int(passes.sum()) > 0
    assert not bool((passes & ~may).any())
    assert float(may.float().mean()) < 0.5


@pytest.mark.parametrize("case", ["adversarial", "sphere_padded",
                                  "sphere_ragged"])
def test_run_brute_model_equals_plain_bitwise(case):
    """The model sweep against the plain sweep: t, index, u and v bit for
    bit, on the adversarial set (degenerate triangles, rays through shared
    edges, empty and NaN t ranges) and on a sphere with t ranges, its table
    zero-padded to a whole TRI_BLOCK or not."""
    if case == "adversarial":
        args = [torch.as_tensor(a) for a in brute_case()]
    else:
        _, tm = _meshes("sphere")
        tbl = t_pb.make_tri_table(tm)
        if case == "sphere_ragged":
            tbl = tbl[:, :tm.vertices.shape[0]].contiguous()
        o, d = _rays((300,), seed=3)
        d[:, 0] = F32(0.05)
        t_min = np.zeros(300, F32)
        t_max = np.full(300, 4.6, F32)
        t_min[::7] = 4.0
        args = [tbl] + [torch.as_tensor(a) for a in (o, d, t_min, t_max)]
    ref = t_pb.run_brute_plain(*args)
    got = t_pb.run_brute_model(*args)
    assert 0 < int((ref[1] >= 0).sum()) < args[1].shape[0]
    for g, r in zip(got, ref):
        assert np.array_equal(bits(g), bits(r))


@pytest.mark.parametrize("kind,shape", [("sphere", (300,)),
                                        ("box", (7, 5))])
def test_run_brute_model_matches_jax(kind, shape):
    """The model sweep inside closest_hit_brute_pallas against JAX's
    kernel in interpret mode (tests/test_pallas.py:22-29's contract)."""
    jm, tm = _meshes(kind)
    o, d = _rays(shape)
    jr = rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))
    ref = j_pb.closest_hit_brute_pallas(jm, jr, interpret=True)
    tbl = t_pb.make_tri_table(tm)
    R = int(np.prod(shape))
    t, idx, _, _ = t_pb.run_brute_model(
        tbl, torch.as_tensor(o.reshape(R, 3)), torch.as_tensor(d.reshape(R, 3)),
        torch.zeros(R), torch.full((R,), float("inf")))
    hit = idx >= 0
    got = type("Hits", (), dict(hit=hit.reshape(shape), t=t.reshape(shape),
                                prim_idx=idx.reshape(shape)))
    _check(ref, got, 20 if kind == "sphere" else 1)
    assert np.array_equal(np_(ref.prim_idx), np_(idx.reshape(shape)))
