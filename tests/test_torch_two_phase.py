"""Parity of the two-phase interval classifier (``ops/two_phase.py``) with
the JAX package, on the CPU: twins of ``tests/test_two_phase.py``.

``classify`` and ``ray_verdict`` are held to JAX's bit for bit on equal
inputs, adversarial ones included (det of +-0, NaN and inf quantities,
ties). ``classify_block`` rounds its operands to bfloat16 and sums in
float32: it is held to JAX's ``classify`` on its own products, those
products to the JAX test's bf16 simulation within float32 summation
order (2^-20 of the magnitude sum), and, as the JAX tests do, to float64
truth for soundness.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raycore_tpu.accel.dense import _featurize_tris, ray_features
from raycore_tpu.ops import two_phase as j_tp
from raycore_tpu_torch.ops import two_phase as t_tp
from torch_parity import bits, np_

FEAT = 16


def _features(rng, n_rays, n_tris, near_edge=False):
    """tests/test_two_phase.py:_features."""
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    o[:, 2] = 3.0
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0 = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    if near_edge:
        hit = o[rng.integers(0, n_rays, n_tris)] \
            + 2.5 * d[rng.integers(0, n_rays, n_tris)]
        v0 = (hit + rng.normal(scale=1e-4, size=(n_tris, 3))).astype(
            np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    phi = np.asarray(ray_features(jnp.asarray(o), jnp.asarray(d)))
    psi = np.asarray(_featurize_tris(jnp.asarray(v0), jnp.asarray(v0 + e1),
                                     jnp.asarray(v0 + e2)))
    return phi, psi.transpose(1, 2, 0).reshape(FEAT, 4 * n_tris)


def _simulate(phi, feats, mode):
    """tests/test_two_phase.py:_simulate: the products on bf16-rounded
    operands (three passes on split operands for bf16x3)."""
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    mm = lambda a, b: np.array(jnp.einsum(
        "rf,fc->rc", a, b, preferred_element_type=jnp.float32))
    if mode == "bf16":
        q = mm(bf(phi), bf(feats))
        eps = j_tp.EPS_BF16
    else:
        ah, bh = bf(phi), bf(feats)
        al, bl = bf(jnp.asarray(phi) - ah), bf(jnp.asarray(feats) - bh)
        q = mm(ah, bh) + mm(ah, bl) + mm(al, bh)
        eps = j_tp.EPS_BF16X3
    return q, mm(bf(np.abs(phi)), bf(np.abs(feats))), eps


def _truth(phi, feats, C, t_min, t_max):
    q64 = phi.astype(np.float64) @ feats.astype(np.float64)
    det = q64[:, :C]
    with np.errstate(divide="ignore", invalid="ignore"):
        u, v, t = (q64[:, k * C:(k + 1) * C] / det for k in (1, 2, 3))
    e = j_tp.EDGE_EPS
    acc = ((u >= -e) & (u <= 1 + e) & (v >= -e) & (u + v <= 1 + e)
           & (t >= t_min) & (t <= t_max) & (det != 0.0))
    return acc, t


def _both_classify(q, s, t_min, t_max, C, **kw):
    ref = j_tp.classify(jnp.asarray(q), jnp.asarray(s), jnp.asarray(t_min),
                        jnp.asarray(t_max), C, **kw)
    got = t_tp.classify(torch.as_tensor(q), torch.as_tensor(s),
                        torch.as_tensor(t_min), torch.as_tensor(t_max), C,
                        **kw)
    for name, r, g in zip(("certain", "possible", "t_lo", "t_hi"), ref, got):
        assert np.array_equal(bits(r) if r.dtype == jnp.float32
                              else np.asarray(r), bits(g) if
                              g.dtype == torch.float32 else np_(g)), name
    return got


def test_constants_match_jax():
    assert t_tp.EPS_BF16 == j_tp.EPS_BF16
    assert t_tp.EPS_BF16X3 == j_tp.EPS_BF16X3
    assert t_tp.EDGE_EPS == j_tp.EDGE_EPS


@pytest.mark.parametrize("mode", ["bf16", "bf16x3"])
@pytest.mark.parametrize("near_edge", [False, True])
def test_classify_sound_and_bitwise(mode, near_edge):
    rng = np.random.default_rng(1234)
    R, C = 128, 48
    phi, feats = _features(rng, R, C, near_edge)
    t_min = np.zeros((R, 1), np.float32)
    t_max = np.full((R, 1), np.inf, np.float32)
    acc, t = _truth(phi, feats, C, t_min, t_max)
    q, s, eps = _simulate(phi, feats, mode)
    certain, possible, t_lo, t_hi = (
        np_(x) for x in _both_classify(q, s, t_min, t_max, C, eps=eps))
    assert not np.any(acc & ~possible), "sound rejection violated"
    assert not np.any(certain & ~acc), "unsound certainty"
    ct = certain & acc
    assert np.all(t_lo[ct] <= t[ct] + 1e-12)
    assert np.all(t_hi[ct] >= t[ct] - 1e-12)
    if not near_edge:
        decided = (~possible) | certain
        assert decided.mean() > (0.2 if mode == "bf16" else 0.9)


def test_classify_adversarial_bitwise():
    """Zero, negative-zero, NaN and infinite quantities, zero magnitude
    sums, finite and infinite t ranges: every output bit equal."""
    rng = np.random.default_rng(3)
    R, C = 64, 32
    q = rng.normal(size=(R, 4 * C)).astype(np.float32)
    s = np.abs(rng.normal(size=(R, 4 * C))).astype(np.float32) * 0.01
    q[:, :C][rng.random((R, C)) < 0.1] = 0.0
    q[:, :C][rng.random((R, C)) < 0.1] = -0.0
    q[rng.random((R, 4 * C)) < 0.02] = np.nan
    q[rng.random((R, 4 * C)) < 0.02] = np.inf
    q[rng.random((R, 4 * C)) < 0.02] = -np.inf
    s[rng.random((R, 4 * C)) < 0.1] = 0.0
    t_min = rng.uniform(0, 0.5, (R, 1)).astype(np.float32)
    t_max = np.where(rng.random((R, 1)) < 0.5, np.inf,
                     rng.uniform(1, 3, (R, 1))).astype(np.float32)
    for eps in (t_tp.EPS_BF16, t_tp.EPS_BF16X3):
        _both_classify(q, s, t_min, t_max, C, eps=eps)


def test_ray_verdict_matches_exact_winner():
    rng = np.random.default_rng(1234)
    R, C = 256, 96
    phi, feats = _features(rng, R, C)
    t_min = np.zeros((R, 1), np.float32)
    t_max = np.full((R, 1), np.inf, np.float32)
    acc, t = _truth(phi, feats, C, t_min, t_max)
    t_acc = np.where(acc, t, np.inf)
    exact_best = np.argmin(t_acc, axis=1)
    exact_hit = np.isfinite(t_acc[np.arange(R), exact_best])
    q, s, eps = _simulate(phi, feats, "bf16x3")
    cls = _both_classify(q, s, t_min, t_max, C, eps=eps)
    ids = torch.arange(C, dtype=torch.int32).expand(R, C)
    ub, winner, amb = (np_(x) for x in t_tp.ray_verdict(*cls, ids))
    jref = j_tp.ray_verdict(*(jnp.asarray(np_(x)) for x in cls),
                            jnp.asarray(np_(ids)))
    assert np.array_equal(bits(jref[0]), bits(ub))
    assert np.array_equal(np.asarray(jref[1]), winner)
    assert np.array_equal(np.asarray(jref[2]), amb)
    ok = ~amb
    w = ok & exact_hit
    assert np.array_equal(winner[w], exact_best[w])
    assert not np.any(ok & ~exact_hit & (winner >= 0))
    assert ok.mean() > 0.9


def test_ray_verdict_ties_and_signed_zeros_bitwise():
    """Equal certain upper bounds take the first slot, as jnp.argmin;
    -0 lower bounds, +inf and empty rows too."""
    rng = np.random.default_rng(5)
    R, N = 128, 16
    certain = rng.random((R, N)) < 0.3
    possible = certain | (rng.random((R, N)) < 0.3)
    t_hi = rng.integers(1, 4, (R, N)).astype(np.float32)
    t_lo = t_hi - rng.integers(0, 3, (R, N)).astype(np.float32)
    t_lo[rng.random((R, N)) < 0.2] = -0.0
    t_lo[rng.random((R, N)) < 0.1] = -np.inf
    t_hi[rng.random((R, N)) < 0.1] = np.inf
    certain[:4] = False
    possible[:2] = False
    keys = rng.integers(0, 1000, (R, N)).astype(np.int32)
    ref = j_tp.ray_verdict(*(jnp.asarray(a) for a in
                             (certain, possible, t_lo, t_hi, keys)))
    got = t_tp.ray_verdict(*(torch.as_tensor(a) for a in
                             (certain, possible, t_lo, t_hi, keys)))
    assert np.array_equal(bits(ref[0]), bits(got[0]))
    assert np.array_equal(np.asarray(ref[1]), np_(got[1]))
    assert np.array_equal(np.asarray(ref[2]), np_(got[2]))


def test_classify_block_matches_jax_on_bf16_operands():
    rng = np.random.default_rng(21)
    R, C = 128, 64
    phi, feats = _features(rng, R, C)
    t_min = np.zeros(R, np.float32)
    t_max = np.full(R, np.inf, np.float32)
    tphi, tfeats = torch.as_tensor(phi), torch.as_tensor(feats)
    got = t_tp.classify_block(tphi, tfeats, torch.as_tensor(t_min),
                              torch.as_tensor(t_max), C)
    # Its products: the JAX test's bf16 simulation, up to float32
    # summation order.
    q = torch.matmul(t_tp._bf16(tphi), t_tp._bf16(tfeats))
    s = torch.matmul(t_tp._bf16(tphi.abs()), t_tp._bf16(tfeats.abs()))
    jq, js, _ = _simulate(phi, feats, "bf16")
    assert np.all(np.abs(np_(q) - jq) <= 2.0 ** -20 * js)
    assert np.all(np.abs(np_(s) - js) <= 2.0 ** -20 * js)
    # Its verdicts: JAX's classify on those products, bit for bit.
    ref = j_tp.classify(jnp.asarray(np_(q)), jnp.asarray(np_(s)),
                        jnp.asarray(t_min[:, None]),
                        jnp.asarray(t_max[:, None]), C)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r).view(np.uint8),
                              np_(g).view(np.uint8))
    acc, _ = _truth(phi, feats, C, t_min[:, None], t_max[:, None])
    certain, possible = np_(got[0]), np_(got[1])
    assert not np.any(acc & ~possible) and not np.any(certain & ~acc)
