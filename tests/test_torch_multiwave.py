"""The ordered multiwave of the regrouped engine (passes >= 2 and "auto")
against the JAX package, on the CPU: the scene statistic
``depth_layers``, the wave internals of the compact stage 1, the pass-1
merge rule, the payloads and batch shapes. End-to-end parity at each
``passes`` against JAX's two stage-1 variants and the oracle is in
tests/test_torch_multiwave_parity.py.

The wave internals compare the port's stage 1 with JAX's
``_stage1_cm(..., waves=W, interpret=True)`` on the same padded rays:
- the wave set (each subgroup's W chosen clusters) is exactly a NumPy
  transcription of the reference rule (``pallas_regroup.py:1180-1194``)
  run on the port's compacted pairs, and the wave grid holds exactly it;
- per-ray (k1, p1) meet the sweep contract of
  tests/test_torch_regroup.py:_sweep_close;
- on every subgroup whose bound ``ub`` is bitwise equal in both (the test
  asserts that is all of them here), the remainder's (subgroup, cluster)
  multiset and the counts equal JAX's, but for one decided divergence
  (ROADMAP.md Q7): where ``ub`` is +inf, JAX's compact stage 1 keeps the
  already swept wave pairs in its remainder (its test ``entry <= ub``
  holds for +inf), the port leaves them out, as JAX's sort stage 1 does.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu_torch.accel import dense as t_dense
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.scene import mesh as t_mesh
from test_torch_regroup import _sweep_close
from torch_adversarial import morton_grid, stage1_rows
from torch_parity import (CPU, check_hits, jax_rays, np_, spy, torch_rays)

INT32_MAX = 0x7FFFFFFF


def incoherent_rays(R=1536, seed=7, dz=0.3):
    """tests/test_pallas_regroup.py's depth-complex recipe (:108-124)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    o[:, 2] = 2.5
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2]) - dz
    return o, np.ascontiguousarray(d)


@pytest.fixture(scope="module")
def blobby64():
    """blobby_mesh(64, 64) at C=64 in both packages."""
    return (j_dense.build_dense(rc.blobby_mesh(64, 64), cluster_size=64),
            rt.build_dense(t_mesh.blobby_mesh(64, 64, device=CPU),
                           cluster_size=64))


# --- the scene statistic -----------------------------------------------------

@pytest.mark.parametrize("blobby,want", [(False, 1), (True, 4)],
                         ids=["heightfield", "blobby"])
def test_depth_layers_match_jax(blobby, want):
    """tests/test_pallas_regroup.py:318-337's scenes at C=128: the same
    float, and auto_passes 1 on the heightfield, 4 on blobby."""
    if blobby:
        jm, tm = rc.blobby_mesh(n_theta=96, n_phi=96), \
            t_mesh.blobby_mesh(n_theta=96, n_phi=96, device=CPU)
    else:
        kw = dict(n=64, extent=2.0, amplitude=0.35)
        jm, tm = rc.displaced_grid_mesh(**kw), \
            t_mesh.displaced_grid_mesh(**kw, device=CPU)
    js = j_dense.build_dense(jm, cluster_size=128)
    ts = rt.build_dense(tm, cluster_size=128)
    assert t_dense.depth_layers(ts) == j_dense.depth_layers(js)
    assert t_pr.auto_passes(ts) == j_pr.auto_passes(js) == want
    assert rt.depth_layers(ts) == t_dense.depth_layers(ts)


def test_depth_layers_is_cached_per_scene(blobby64, monkeypatch):
    """The statistic is computed once per scene and never read from
    another scene: a scene made by ``dataclasses.replace`` (new tables)
    computes its own."""
    _, ts = blobby64
    calls = []
    spy(monkeypatch, t_dense, "_depth_layers", calls)
    first = dataclasses.replace(ts)
    v = t_dense.depth_layers(first)
    assert t_dense.depth_layers(first) == v and len(calls) == 1
    flat = dataclasses.replace(first,
                               cluster_max=first.cluster_min.clone())
    flat.cluster_max[:, 2] = first.cluster_min[:, 2]
    assert t_dense.depth_layers(flat) != v and len(calls) == 2
    assert t_dense.depth_layers(first) == v and len(calls) == 2
    # Clusters that touch the capacity padding are left out, as in JAX
    # (whose cache is keyed on the table, so its twin gets a new one).
    pad = dataclasses.replace(first, cluster_max=first.cluster_max.clone())
    pad.cluster_max[:3] = 1e30
    js, _ = blobby64
    jpad = js.replace(tri_feats=jnp.array(js.tri_feats),
                      cluster_min=jnp.asarray(np_(first.cluster_min)),
                      cluster_max=jnp.asarray(np_(pad.cluster_max)))
    assert t_dense.depth_layers(pad) == j_dense.depth_layers(jpad) != v


# --- the wave internals ------------------------------------------------------

def numpy_wave_select(entry, sub, cid, W, n_sub, K):
    """The reference rule (pallas_regroup.py:1180-1194) in NumPy: per
    subgroup, the minimum finite entry, the smallest cluster id among
    equal ones, then that pair excluded. Subgroups without a candidate
    get K (the reference: K or INT32_MAX)."""
    ent = entry.copy()
    chosen = []
    for _ in range(W):
        fin = np.isfinite(ent)
        e = np.where(fin, ent, np.float32(3e38))
        emin = np.full(n_sub + 1, np.inf, np.float32)
        np.minimum.at(emin, sub, e)
        tied = fin & (e == emin[sub])
        csel = np.full(n_sub + 1, K, np.int64)
        np.minimum.at(csel, sub, np.where(tied, cid, K))
        chosen.append(csel[:n_sub])
        ent = np.where(cid == csel[sub], np.inf, ent)
    return np.stack(chosen, 1), ent


def _pairs(block_cid, block_subs, n_sub):
    """Sorted (subgroup, cluster) pairs of a block grid's live slots."""
    bc, bs = np_(block_cid), np_(block_subs)
    live = bs != n_sub
    cids = np.broadcast_to(bc[:, None], bs.shape)[live]
    return sorted(zip(bs[live].tolist(), cids.tolist()))


@pytest.mark.parametrize("W,rays", [(1, "morton"), (3, "morton"),
                                    (3, "incoherent")])
def test_wave_internals_match_jax(blobby64, W, rays):
    js, ts = blobby64
    o, d = morton_grid(64) if rays == "morton" else incoherent_rays()
    po, pd, ptmin, ptmax, _, G, TILE = t_pr._padded_batch(
        torch_rays(o, d), 512, 32)
    SPB, K = 16, ts.n_clusters
    n_tiles, SPT, n_sub = po.shape[0] // TILE, TILE // G, po.shape[0] // G
    P_cap = n_tiles * K
    jbc, jbs, _, tot, jk1, jp1 = (np.asarray(x) for x in j_pr._stage1_cm(
        js, *(jnp.asarray(np_(x)) for x in (po, pd, ptmin, ptmax)),
        TILE=TILE, G=G, SPB=SPB, P_cap=P_cap, Q_cap=P_cap * SPT,
        interpret=True, waves=W))
    P, sub, cid, entry, _ = t_pr.subgroup_pairs(
        ts, *stage1_rows(po, pd, ptmin, ptmax), TILE, G)
    bc, bs, _, counts, wave = t_pr._stage1_cm_core(
        ts, po, pd, ptmin, ptmax, TILE, G, SPB, waves=W)

    # The wave set: the reference rule on the same pairs, and the grid.
    want, ent_w = numpy_wave_select(np_(entry), np_(sub), np_(cid), W, n_sub,
                                    K)
    chosen, t_ent_w = t_pr.wave_select(entry, sub, cid, W, n_sub, K)
    assert np.array_equal(np_(chosen), want)
    assert np.array_equal(np_(wave.chosen), want)
    assert np.array_equal(np_(t_ent_w), ent_w)
    wave_pairs = sorted((s, int(c)) for s in range(n_sub) for c in want[s]
                        if c < K)
    assert _pairs(wave.block_cid, wave.block_subs, n_sub) == wave_pairs
    assert counts[4:] == (len(wave_pairs), int(tot[3]))

    # The wave sweep's per-ray results.
    _sweep_close(jk1, jp1, wave.k1, wave.p1)
    jt1 = np.where(jk1 == INT32_MAX, np.inf, jk1.view(np.float32))
    jub = jt1.reshape(n_sub, G).max(1)
    ub = np_(wave.ub)
    same_ub = jub.view(np.int32) == ub.view(np.int32)
    assert same_ub.all(), f"{(~same_ub).sum()} subgroups differ in ub"
    assert np.isfinite(ub).any() or rays == "incoherent"

    # The remainder and the counts; JAX's compact stage 1 also keeps the
    # wave pairs of subgroups whose ub is +inf (Q7).
    q7 = sorted(p for p in wave_pairs if np.isinf(ub[p[0]]))
    got = sorted(_pairs(bc, bs, n_sub) + q7)
    ref = _pairs(jbc[:int(tot[2])], jbs[:int(tot[2])], n_sub)
    assert got == ref
    assert (counts[0], counts[1]) == (int(tot[0]), int(tot[1])) == (
        P, sub.shape[0])
    assert counts[2] == len(ref) - len(q7)
    if rays == "morton":
        assert q7 and counts[2] < counts[1] - counts[4]  # the prune bites


def test_merge_rule_matches_reference_transcription():
    """merge_pass1 against a NumPy transcription of
    pallas_regroup.py:1327-1331 on synthetic keys with ties, misses and
    pair < 0."""
    rng = np.random.default_rng(21)
    n = 4096
    key = rng.integers(1000, 1004, n).astype(np.int32)
    k1 = rng.integers(1000, 1004, n).astype(np.int32)
    pair = rng.integers(0, 6, n).astype(np.int32)
    p1 = rng.integers(0, 6, n).astype(np.int32)
    key[rng.uniform(size=n) < 0.2] = INT32_MAX
    k1[rng.uniform(size=n) < 0.2] = INT32_MAX
    pair[key == INT32_MAX] = -1
    p1[k1 == INT32_MAX] = -1
    pair[rng.uniform(size=n) < 0.05] = -1     # a hit key with no pair
    better1 = (k1 < key) | ((k1 == key) & (p1 >= 0)
                            & ((p1 < pair) | (pair < 0)))
    want_k, want_p = np.where(better1, k1, key), np.where(better1, p1, pair)
    got_k, got_p = t_pr.merge_pass1(*(torch.as_tensor(x) for x in
                                      (key, pair, k1, p1)))
    assert np.array_equal(np_(got_k), want_k)
    assert np.array_equal(np_(got_p), want_p)
    assert better1.any() and (~better1).any() and (
        (k1 == key) & (p1 >= 0)).any()


# --- queries -----------------------------------------------------------------

def test_multiwave_sweeps_a_wave_and_a_remainder_grid(blobby64,
                                                      monkeypatch):
    """At passes >= 2 the sweep runs on the wave grid, then on the
    remainder grid; at passes = 1 once."""
    _, ts = blobby64
    o, d = morton_grid(64)
    calls = []
    spy(monkeypatch, t_pr, "run_regrouped", calls)
    r4 = t_pr.closest_hit_regrouped(ts, torch_rays(o, d), passes=4)
    assert len(calls) == 2
    r1 = t_pr.closest_hit_regrouped(ts, torch_rays(o, d), passes=1)
    assert len(calls) == 3
    check_hits(r1, r4)


@pytest.mark.parametrize("payload", ["slim", "occlusion"])
def test_payloads_at_passes_4_match_jax(blobby64, payload):
    js, ts = blobby64
    o, d = morton_grid(48, half=0.9)
    ref = j_pr.closest_hit_regrouped(js, jax_rays(o, d), passes=4,
                                     payload=payload)
    got = t_pr.closest_hit_regrouped(ts, torch_rays(o, d), passes=4,
                                     payload=payload)
    assert np.array_equal(np.asarray(ref.hit), np_(got.hit))
    assert np.array_equal(np.asarray(ref.prim_idx), np_(got.prim_idx))
    assert np.array_equal(np.asarray(ref.instance_idx),
                          np_(got.instance_idx))
    assert 0.3 < float(got.hit.float().mean()) < 1.0
    if payload == "slim":
        check_hits(ref, got)
        h = np.asarray(ref.hit)
        assert np.array_equal(np.asarray(ref.triangle.metadata)[h],
                              np_(got.triangle.metadata)[h])


def test_ragged_2d_batches_and_t_ranges_at_passes_4(blobby64):
    """A ragged batch, a 2-D batch and t ranges at passes=4: the brute
    oracle's hits, and passes=1's within check_hits."""
    js, ts = blobby64
    o, d = incoherent_rays(R=777, seed=5, dz=0.8)
    full = t_pr.closest_hit_regrouped(ts, torch_rays(o, d), passes=4)
    # Halfway between the two middle hits' t: no hit lies on the bound.
    ts_ = full.t[full.hit].sort().values
    t_mid = float(ts_[len(ts_) // 2 - 1:len(ts_) // 2 + 1].mean())
    for kw in ({}, {"t_min": t_mid}, {"t_max": t_mid}):
        tr = torch_rays(o, d, **kw)
        got = t_pr.closest_hit_regrouped(ts, tr, passes=4)
        check_hits(rt.closest_hit_brute(ts.prims, tr), got)
        check_hits(t_pr.closest_hit_regrouped(ts, tr, passes=1), got)
        assert got.hit.any()
    r2 = rt.Ray.create(torch.as_tensor(o[:750]).reshape(25, 30, 3),
                       torch.as_tensor(d[:750]).reshape(25, 30, 3))
    res2 = t_pr.closest_hit_regrouped(ts, r2, passes=4)
    assert res2.hit.shape == (25, 30)
    assert res2.triangle.vertices.shape == (25, 30, 3, 3)
    flat = t_pr.closest_hit_regrouped(ts, torch_rays(o[:750], d[:750]),
                                      passes=4)
    assert torch.equal(res2.prim_idx.reshape(-1), flat.prim_idx)
