"""Parity of the tile-worklist closest hit (kernel K3's plain version and
its drivers) with the JAX package, on the CPU.

Sizes are those of tests/test_pallas_dense.py: ``displaced_grid_mesh(n=32)``
at C=64 and ``blobby_mesh(64, 64)`` at C=128, 1024 rays at tile 128, scenes
with SUB = 1 and 4. The JAX side runs its Pallas kernels in interpret mode.

The sweep against JAX's ``_run_worklist`` compares keys: both truncate t to
23 - bits mantissa bits, so decoded keys agree within rtol 2e-6 (the
product's summation order may differ) and pairs agree where keys do. End
to end, the drivers meet the engine contract against JAX and the brute
oracle with the worklist's widened tie bound (``worklist_tie_rtol``): two
hits within 2^-(23 - bits) relative tie on the key and the smaller lane
wins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel.brute import closest_hit_brute as j_brute
from raycore_tpu.ops import pallas_dense as j_pd
from raycore_tpu_torch.accel import dispatch as t_dispatch
from raycore_tpu_torch.ops import dense as t_pd
from raycore_tpu_torch.ops import regroup as t_pr
from torch_parity import (check_worklist_hits, jax_rays, jax_worklist_args,
                          np_, pallas_dense_scenes as _scenes, ray_arrays,
                          spy, torch_rays)

TILE = 128


def _bits(scene):
    return t_pd._idx_bits(scene.cluster_size // scene.sub_chunks)


def _keys_close(kj, pj, kt, pt, bits):
    kj, pj, kt, pt = (np_(x) for x in (kj, pj, kt, pt))
    hj, ht = pj >= 0, pt >= 0
    assert np.array_equal(hj, ht)
    assert ht.sum() > 0
    mask = (1 << bits) - 1
    tj = (kj[ht] & ~mask).view(np.float32)
    tt = (kt[ht] & ~mask).view(np.float32)
    np.testing.assert_allclose(tt, tj, rtol=2e-6, atol=0)
    same = kj == kt
    assert np.array_equal(pj[same], pt[same])


@pytest.mark.parametrize("blobby,SUB,coherent", [
    (False, 1, True), (False, 4, False), (True, 1, False), (True, 4, False)])
def test_run_worklist_plain_matches_jax(blobby, SUB, coherent):
    """The same worklist through both sweeps, seeded from t_max; then its
    second half again, seeded with the first run's keys and pairs."""
    js, ts = _scenes(blobby, SUB)
    C, bits = ts.cluster_size, _bits(ts)
    o, d = ray_arrays(R=1024, seed=1, coherent=coherent,
                      zero_dirs=not coherent)
    t_max = np.full(1024, np.inf, np.float32)
    t_max[5::11] = 2.2
    tr = torch_rays(o, d, t_max=torch.as_tensor(t_max))
    tids, cids, phi, tmin, key0, _, _, _ = t_pd._phase_a_and_worklist(
        ts, *t_pd.flat_rays(tr), TILE=TILE)
    pair0 = torch.full_like(key0, -1)
    for _ in range(2):
        jt, jc, jphi, jtmin, jkey0, jpair0 = jax_worklist_args(
            tids, cids, phi, tmin, key0, pair0, TILE)
        kj, pj = j_pd._run_worklist(
            jt, jc, jphi, js.tri_feats, js.sub_bounds, jtmin, jkey0,
            TILE=TILE, C=C, SUB=SUB, n_blocks=int(tids.shape[0]),
            interpret=True, pair0=jpair0)
        kt, pt = t_pd.run_worklist(tids, cids, phi, ts.tri_feats,
                                   ts.sub_bounds, tmin, key0, pair0,
                                   TILE=TILE, C=C, SUB=SUB)
        _keys_close(np_(kj)[:1024], np_(pj)[:1024], kt, pt, bits)
        key0, pair0 = kt, pt
        half = tids.shape[0] // 2
        tids, cids = tids[half:], cids[half:]


@pytest.mark.parametrize("SUB", [1, 4])
def test_plain_counts_live_sub_chunks(SUB):
    """The plain sweep counts the (block, sub-chunk) pairs whose lanes it
    tests: every one at SUB = 1; at SUB > 1 only those some ray of the
    tile enters before its held hit, so never more than the ray enters on
    [t_min, t_max], and the same keys and pairs as run_worklist_plain."""
    _, ts = _scenes(SUB=SUB)
    C = ts.cluster_size
    o, d = ray_arrays(R=1024, seed=1, coherent=True)
    tids, cids, phi, tmin, key0, _, _, _ = t_pd._phase_a_and_worklist(
        ts, *t_pd.flat_rays(torch_rays(o, d)), TILE=TILE)
    args = (tids, cids, phi, ts.tri_feats, ts.sub_bounds, tmin, key0,
            torch.full_like(key0, -1))
    key, pair, live = t_pd.worklist_plain_live(*args, TILE=TILE, C=C,
                                               SUB=SUB)
    kp, pp = t_pd.run_worklist_plain(*args, TILE=TILE, C=C, SUB=SUB)
    assert torch.equal(key, kp) and torch.equal(pair, pp)
    n = tids.numel()
    if SUB == 1:
        assert live == n
        return
    tiles = lambda a: a.reshape(-1, TILE, *a.shape[1:])[tids.long()]
    t_max = t_pd._t_from_keys(key0, _bits(ts))
    entered = sum(int(t_pd._slab_live(
        tiles(phi), ts.sub_bounds[cids.long(), 0, s * 6:(s + 1) * 6],
        tiles(tmin), tiles(t_max)).any(dim=1).sum()) for s in range(SUB))
    assert 0 < live <= entered <= SUB * n
    assert live < SUB * n


def test_tile_ranges_and_empty_tiles_keep_their_seed():
    tids = torch.tensor([0, 0, 2, 2, 2, 5], dtype=torch.int32)
    assert t_pd.tile_ranges(tids, 7).tolist() == [0, 2, 2, 5, 5, 5, 6, 6]
    # A tile with no block returns key0/pair0 unchanged.
    _, ts = _scenes()
    o, d = ray_arrays(R=256, seed=2, coherent=True)
    tids, cids, phi, tmin, key0, _, _, _ = t_pd._phase_a_and_worklist(
        ts, *t_pd.flat_rays(torch_rays(o, d)), TILE=TILE)
    keep = tids != 1
    pair0 = torch.arange(256, dtype=torch.int32)
    key, pair = t_pd.run_worklist(tids[keep], cids[keep], phi, ts.tri_feats,
                                  ts.sub_bounds, tmin, key0, pair0, TILE=TILE,
                                  C=ts.cluster_size, SUB=1)
    assert torch.equal(key[TILE:], key0[TILE:])
    assert torch.equal(pair[TILE:], pair0[TILE:])
    assert bool((pair[:TILE] != pair0[:TILE]).any())


def _drivers():
    return {
        "auto": (lambda m, s, r: m.closest_hit_dense_pallas_auto(
            s, r, tile=TILE)),
        "passes1": (lambda m, s, r: m.closest_hit_dense_pallas(
            s, r, tile=TILE, passes=1, max_pairs_per_tile=64)),
        "passes2": (lambda m, s, r: m.closest_hit_dense_pallas(
            s, r, tile=TILE, passes=2, max_pairs_per_tile=64)),
        "topk": (lambda m, s, r: m.closest_hit_dense_pallas_topk(
            s, r, tile=TILE, cap=8)),
    }


@pytest.mark.parametrize("blobby,SUB,coherent", [
    (False, 1, True), (False, 4, False), (True, 1, False), (True, 4, False)])
def test_drivers_match_jax_and_oracle(blobby, SUB, coherent):
    js, ts = _scenes(blobby, SUB)
    o, d = ray_arrays(R=1024, seed=3, coherent=coherent,
                      zero_dirs=not coherent)
    jr, tr = jax_rays(o, d), torch_rays(o, d)
    oracle = j_brute(js.prims, jr)
    bits = _bits(ts)
    for name, run in _drivers().items():
        ref, got = run(j_pd, js, jr), run(t_pd, ts, tr)
        check_worklist_hits(ref, got, bits)
        assert np.array_equal(np_(ref.instance_idx), np_(got.instance_idx))
        assert np.array_equal(np_(ref.triangle.metadata).astype(np.int64),
                              np_(got.triangle.metadata))
        if name != "topk":            # topk is approximate past its cap
            check_worklist_hits(oracle, got, bits)


def test_closest_hit_on_sub_chunk_scene_matches_jax():
    """closest_hit on a sub_chunks=4 scene goes to the worklist in both
    packages (the regrouped engine takes only sub_chunks == 1)."""
    js, ts = _scenes(blobby=True, SUB=4)
    o, d = ray_arrays(R=1000, seed=4)
    jr, tr = jax_rays(o, d), torch_rays(o, d)
    got = rt.closest_hit(ts, tr)
    check_worklist_hits(rc.closest_hit(js, jr), got, _bits(ts))
    check_worklist_hits(j_brute(js.prims, jr), got, _bits(ts))
    with pytest.raises(ValueError):
        t_pr.closest_hit_regrouped(ts, tr)


def test_query_tile_size_and_deferred_match_jax():
    """The reference's query arguments: ``closest_hit`` and ``any_hit``
    with tile_size=64 and deferred=True take the worklist at tile 64 in
    both packages and return (result, None)."""
    js, ts = _scenes()
    o, d = ray_arrays(R=300, seed=6)
    jr, tr = jax_rays(o, d), torch_rays(o, d)
    ref, jfin = rc.closest_hit(js, jr, tile_size=64, deferred=True)
    got, fin = rt.closest_hit(ts, tr, tile_size=64, deferred=True)
    assert jfin is None and fin is None
    check_worklist_hits(ref, got, _bits(ts))
    direct = t_pd.closest_hit_dense_pallas_auto(ts, tr, tile=64)
    assert torch.equal(direct.prim_idx, got.prim_idx)
    jocc, jfin = rc.any_hit(js, jr, tile_size=64, deferred=True)
    occ, fin = rt.any_hit(ts, tr, tile_size=64, deferred=True)
    assert jfin is None and fin is None
    assert np.array_equal(np_(jocc.hit), np_(occ.hit)) and np_(occ.hit).any()


def test_overflow_raises_before_the_sweep():
    """A spreading bundle whose tile needs more than one cluster (JAX's
    test_overflow_detection): one pass at a capacity of one pair per tile
    raises; without the check, both packages drop the same blocks."""
    _, ts = _scenes()
    js, _ = _scenes()
    ang = np.linspace(0.0, 2 * np.pi, 64, endpoint=False, dtype=np.float32)
    tgt = np.stack([np.cos(ang), np.sin(ang), -np.ones_like(ang)], -1)
    o = np.zeros((64, 3), np.float32)
    o[:, 2] = 2.0
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    d = np.ascontiguousarray(d, np.float32)
    kw = dict(tile=64, max_pairs_per_tile=1, passes=1)
    with pytest.raises(RuntimeError, match="overflow"):
        t_pd.closest_hit_dense_pallas(ts, torch_rays(o, d), **kw)
    with pytest.raises(RuntimeError, match="overflow"):
        j_pd.closest_hit_dense_pallas(js, jax_rays(o, d), **kw)
    got = t_pd.closest_hit_dense_pallas(ts, torch_rays(o, d),
                                        check_overflow=False, **kw)
    ref = j_pd.closest_hit_dense_pallas(js, jax_rays(o, d),
                                        check_overflow=False, **kw)
    check_worklist_hits(ref, got, _bits(ts))
    assert np.array_equal(np_(ref.prim_idx), np_(got.prim_idx))
    with pytest.raises(ValueError):
        t_pd.closest_hit_dense_pallas(ts, torch_rays(o, d), passes=3)


def test_t_ranges():
    """tests/test_pallas_dense.py:102-110: a ray beside the scene and a ray
    whose t_max stops short of the surface miss, with a zero triangle; a
    one-ray batch runs at TILE 8."""
    _, ts = _scenes()
    for kw in (dict(o=[9.0, 9, 2.0]), dict(o=[0.0, 0, 2.0], t_max=1.0)):
        o = torch.tensor(kw.pop("o"))
        ray = rt.Ray.create(o, torch.tensor([0.0, 0, -1.0]), **kw)
        res = t_pd.closest_hit_dense_pallas(ts, ray, tile=8)
        assert res.hit.shape == () and not bool(res.hit)
        assert not res.triangle.vertices.any()
    hit = t_pd.closest_hit_dense_pallas_auto(
        ts, rt.Ray.create(torch.tensor([0.0, 0, 2.0]),
                          torch.tensor([0.0, 0, -1.0])))
    assert bool(hit.hit) and 1.5 < float(hit.t) < 2.5


def test_dispatch_routes_on_batch_size(monkeypatch):
    """Batches below REGROUP_MIN_RAYS go to the worklist (tile 512) on
    every scene; larger ones to the regrouped engine (tile 2048, passes 1)
    on a sub_chunks == 1 scene and to the packed engine (tile 2048) on a
    sub_chunks == 4 scene. The threshold is lowered to reach them at test
    size."""
    calls = []
    spy(monkeypatch, t_pd, "closest_hit_dense_pallas_auto", calls)
    spy(monkeypatch, t_pr, "closest_hit_regrouped", calls)
    spy(monkeypatch, t_pr, "closest_hit_packed", calls)
    _, ts = _scenes()
    _, ts4 = _scenes(SUB=4)
    o, d = ray_arrays(R=1024, seed=5)
    tr = torch_rays(o, d)
    worklist = rt.closest_hit(ts, tr)
    assert calls == [("closest_hit_dense_pallas_auto", dict(tile=512))]
    calls.clear()
    rt.closest_hit(ts4, tr)
    assert calls == [("closest_hit_dense_pallas_auto", dict(tile=512))]
    monkeypatch.setattr(t_dispatch, "REGROUP_MIN_RAYS", 1024)
    calls.clear()
    regrouped = rt.closest_hit(ts, tr, payload="slim")
    assert calls == [("closest_hit_regrouped",
                      dict(tile=2048, passes=1, payload="slim"))]
    calls.clear()
    packed = rt.closest_hit(ts4, tr, payload="slim")
    assert calls == [("closest_hit_packed", dict(tile=2048))]
    # The packed engine has no slim mode: the full payload comes back.
    assert packed.triangle.vertices[packed.hit].any()
    check_worklist_hits(regrouped, worklist, _bits(ts))
    check_worklist_hits(packed, worklist, _bits(ts))
