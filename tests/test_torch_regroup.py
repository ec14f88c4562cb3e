"""Parity of the regroup sweep (kernel K2's plain version), the grouped
combine and the end-to-end closest hit with the JAX package, on the CPU.

The sweep's plain version is a matrix product whose summation order may
differ from the reference's: where both hit, the decoded t agrees within
rtol 2e-6 and the hit masks agree. End to end, the port meets the JAX
package's own engine contract (tests/test_pallas_regroup.py:_check)
against both the JAX regrouped engine and the brute-force oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.accel.brute import closest_hit_brute as j_brute
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch import convert
from raycore_tpu_torch.ops import dense as t_pd
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import (CPU, check_hits, jax_rays, jax_scene_arrays, np_,
                          ray_arrays, torch_rays)

INT32_MAX = 0x7FFFFFFF


def _scenes(C=128, blobby=False):
    if blobby:
        return (j_dense.build_dense(j_mesh.blobby_mesh(64, 64),
                                    cluster_size=C),
                rt.build_dense(t_mesh.blobby_mesh(64, 64, device=CPU),
                               cluster_size=C))
    return (j_dense.build_dense(j_mesh.displaced_grid_mesh(n=40),
                                cluster_size=C),
            rt.build_dense(t_mesh.displaced_grid_mesh(n=40, device=CPU),
                           cluster_size=C))


def _blobby_rays(R=1024, seed=3):
    """Rays through a depth-complex scene: misses and several layers."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    o[:, 2] = 2.5
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return o, np.ascontiguousarray(d)


def _sweep_close(kj, pj, kt, pt):
    kj, pj, kt, pt = (np_(x) for x in (kj, pj, kt, pt))
    hj, ht = kj != INT32_MAX, kt != INT32_MAX
    assert np.array_equal(hj, ht)
    assert hj.sum() > 0
    tj, tt = kj[hj].view(np.float32), kt[hj].view(np.float32)
    np.testing.assert_allclose(tt, tj, rtol=2e-6, atol=0)
    same = kj[hj] == kt[hj]
    assert np.array_equal(pj[hj][same], pt[hj][same])
    assert np.array_equal(pt[~ht], np.full((~ht).sum(), -1))


@pytest.mark.parametrize("C,G,SPB", [(128, 32, 16), (64, 32, 16),
                                     (128, 16, 32)])
def test_sweep_plain_matches_jax_run_regrouped(C, G, SPB):
    js, ts = _scenes(C=C)
    o, d = ray_arrays(R=1024, seed=2)
    rays = torch_rays(o, d)
    po, pd, ptmin, ptmax, _, G, TILE = t_pr._padded_batch(rays, 256, G)
    bc, bs, tbl, (_, _, nb) = t_pr._stage1_cm_core(ts, po, pd, ptmin, ptmax,
                                                   TILE, G, SPB)
    kj, pj = j_pr.run_regrouped(jnp.asarray(np_(bs)), jnp.asarray(np_(bc)),
                                jnp.asarray(np_(tbl)), js.tri_feats, G=G,
                                SPB=SPB, C=C, n_blocks=nb, interpret=True)
    kt, pt = t_pr.run_regrouped(bs, bc, tbl, ts.tri_feats, G=G, SPB=SPB, C=C)
    _sweep_close(kj, pj, kt, pt)


def test_sweep_padding_blocks_and_dummy_subgroup():
    """Random tables as in the reference's own sweep test: blocks with
    cid = -1 write the miss sentinels (the reference leaves them
    unwritten), the dummy subgroup never hits, valid blocks agree."""
    rng = np.random.default_rng(3)
    G, SPB, C, n_sub, K, n_blocks = 8, 4, 16, 20, 6, 12
    tbl = rng.normal(size=(n_sub + 1, G, 16)).astype(np.float32)
    tbl[:, :, 13] = 0.0
    tbl[:, :, 14] = 10.0
    tbl[-1, :, 14] = -np.inf
    feats = rng.normal(size=(K, 16, 4 * C)).astype(np.float32)
    feats[:, 10:] = 0.0           # as the build lays them out
    subs = rng.integers(0, n_sub + 1, (n_blocks, SPB)).astype(np.int32)
    subs[0, 1] = n_sub
    cids = rng.integers(0, K, (n_blocks,)).astype(np.int32)
    cids[[3, 7]] = -1
    kj, pj = j_pr.run_regrouped(jnp.asarray(subs), jnp.asarray(cids),
                                jnp.asarray(tbl), jnp.asarray(feats), G=G,
                                SPB=SPB, C=C, n_blocks=n_blocks,
                                interpret=True)
    kt, pt = t_pr.run_regrouped(torch.as_tensor(subs), torch.as_tensor(cids),
                                torch.as_tensor(tbl), torch.as_tensor(feats),
                                G=G, SPB=SPB, C=C)
    rows = G * SPB
    kt2, pt2 = np_(kt).reshape(n_blocks, rows), np_(pt).reshape(n_blocks,
                                                              rows)
    assert (kt2[[3, 7]] == INT32_MAX).all() and (pt2[[3, 7]] == -1).all()
    assert (kt2[0, G:2 * G] == INT32_MAX).all()      # dummy subgroup slot
    valid = np.repeat(cids >= 0, rows)
    _sweep_close(np_(kj)[valid], np_(pj)[valid], np_(kt)[valid],
                 np_(pt)[valid])


def test_combine_rows_grouped_matches_jax():
    """Equal keys across a subgroup's rows resolve to the smallest pair."""
    rng = np.random.default_rng(4)
    G, SPB, n_sub, n_blocks = 8, 4, 30, 25
    subs = rng.integers(0, n_sub + 1, (n_blocks, SPB)).astype(np.int32)
    keys = rng.integers(1000, 1006, n_blocks * SPB * G).astype(np.int32)
    keys[rng.uniform(size=keys.size) < 0.3] = INT32_MAX
    pairs = np.where(keys == INT32_MAX, -1,
                     rng.integers(0, 500, keys.size)).astype(np.int32)
    kj, pj = j_pr.combine_rows_grouped(jnp.asarray(keys), jnp.asarray(pairs),
                                       jnp.asarray(subs), n_blocks, G, SPB,
                                       n_sub)
    kt, pt = t_pr.combine_rows_grouped(torch.as_tensor(keys),
                                       torch.as_tensor(pairs),
                                       torch.as_tensor(subs), G, SPB, n_sub)
    assert np.array_equal(np_(kj), np_(kt))
    assert np.array_equal(np_(pj), np_(pt))


@pytest.mark.parametrize("C,G,SPB,coherent,payload", [
    (128, 32, 16, True, "full"), (128, 32, 16, False, "full"),
    (64, 32, 16, False, "full"), (128, 16, 32, True, "full"),
    (128, 32, 16, False, "slim")])
def test_closest_hit_matches_jax_and_oracle(C, G, SPB, coherent, payload):
    js, ts = _scenes(C=C)
    o, d = ray_arrays(R=1024, seed=0, coherent=coherent)
    jr, tr = jax_rays(o, d), torch_rays(o, d)
    got = t_pr.closest_hit_regrouped(ts, tr, subgroup=G, spb=SPB,
                                     payload=payload)
    ref = j_pr.closest_hit_regrouped(js, jr, subgroup=G, spb=SPB, passes=1,
                                     payload=payload)
    check_hits(ref, got)
    check_hits(j_brute(js.prims, jr), got)
    assert np.array_equal(np_(ref.instance_idx), np_(got.instance_idx))
    assert np.array_equal(np_(ref.triangle.metadata).astype(np.int64),
                          np_(got.triangle.metadata))
    if payload == "slim":
        assert not got.triangle.vertices.any()
        assert not got.barycentric.any()
    else:
        h = np_(got.hit)
        np.testing.assert_allclose(np_(got.barycentric)[h],
                                   np_(ref.barycentric)[h], atol=2e-5)


def test_closest_hit_depth_complex_blobby():
    js, ts = _scenes(C=128, blobby=True)
    o, d = _blobby_rays()
    jr, tr = jax_rays(o, d), torch_rays(o, d)
    got = rt.closest_hit(ts, tr)
    h = np_(got.hit)
    assert 0.2 < h.mean() < 0.98          # misses and hits
    check_hits(j_brute(js.prims, jr), got)
    check_hits(j_pr.closest_hit_regrouped(js, jr, tile=2048, passes=1), got)


def test_diagonal_edge_cracks_match_jax():
    """Rays exactly on shared edges, far from the origin: the featurized
    test's rounding (about |o| * 6e-8 / triangle size in u and v) exceeds
    its 1e-5 edge slack, so rays can slip between the two triangles of an
    edge. A grid moved to x, y = 32 puts its cells' diagonal edges under
    rays along x == y. The JAX engine misses there too, ray for ray, while
    the exact oracle hits every one."""
    base = j_mesh.displaced_grid_mesh(n=40)
    v = np.asarray(base.vertices).copy()
    v[:, :, :2] += np.float32(32.0)
    meta = np.array(base.metadata)
    js = j_dense.build_dense(rc.Triangle.create(jnp.asarray(v), metadata=meta),
                             cluster_size=128)
    ts = rt.build_dense(rt.Triangle.create(torch.as_tensor(v),
                                           metadata=torch.as_tensor(meta)),
                        cluster_size=128)
    s = np.linspace(-0.9, 0.9, 1024, dtype=np.float32) + np.float32(32.0)
    o = np.stack([s, s, np.full_like(s, 3.0)], -1)
    d = np.ascontiguousarray(np.broadcast_to(
        np.array([0, 0, -1], np.float32), o.shape))
    jr = jax_rays(o, d)
    ref = j_pr.closest_hit_regrouped(js, jr, tile=2048, passes=1)
    got = rt.closest_hit(ts, torch_rays(o, d))
    assert np_(j_brute(js.prims, jr).hit).all()
    assert (~np_(got.hit)).sum() >= 100           # the cracks reproduce
    check_hits(ref, got)


def test_query_on_scene_converted_from_jax():
    """The query alone, on tables the JAX package built."""
    js, _ = _scenes(C=64)
    scene = convert.dense_scene_from_numpy(jax_scene_arrays(js), device=CPU)
    o, d = ray_arrays(R=1024, seed=9)
    got = rt.closest_hit(scene, torch_rays(o, d))
    check_hits(j_pr.closest_hit_regrouped(js, jax_rays(o, d), passes=1),
               got)


def test_dispatch_ragged_batch_and_batch_shape():
    js, ts = _scenes()
    o, d = ray_arrays(R=777, seed=5)
    tr = torch_rays(o, d, t_min=0.05)
    res = rt.closest_hit(ts, tr)
    check_hits(j_brute(js.prims, jax_rays(o, d, t_min=0.05)), res)
    # 777 rays are below REGROUP_MIN_RAYS: dispatch takes the worklist.
    direct = t_pd.closest_hit_dense_pallas_auto(ts, tr, tile=512)
    assert torch.equal(direct.prim_idx, res.prim_idx)
    r2 = rt.Ray.create(tr.o[:750].reshape(25, 30, 3),
                       tr.d[:750].reshape(25, 30, 3))
    res2 = rt.closest_hit(ts, r2)
    assert res2.hit.shape == (25, 30) and res2.triangle.vertices.shape == \
        (25, 30, 3, 3)
    assert torch.equal(res2.prim_idx.reshape(-1), res.prim_idx[:750])


def test_t_range_is_respected():
    _, ts = _scenes()
    o, d = ray_arrays(R=256, seed=6, coherent=True)
    assert not rt.closest_hit(ts, torch_rays(o, d, t_max=0.5)).hit.any()
    assert not rt.closest_hit(ts, torch_rays(o, d, t_min=100.0)).hit.any()


def test_unported_options_raise():
    _, ts = _scenes()
    o, d = ray_arrays(R=64, seed=1)
    tr = torch_rays(o, d)
    # passes takes an int >= 1 or "auto" (tests/test_torch_multiwave.py);
    # anything else is refused.
    with pytest.raises(ValueError, match="passes"):
        t_pr.closest_hit_regrouped(ts, tr, passes=0)
    with pytest.raises(ValueError, match="passes"):
        t_pr.closest_hit_regrouped(ts, tr, passes=-1)
    with pytest.raises(ValueError, match="passes"):
        t_pr.closest_hit_regrouped(ts, tr, passes="fast")
    with pytest.raises(ValueError):
        t_pr.closest_hit_regrouped(ts, tr, payload="fat")
    # The regrouped engine takes only sub_chunks == 1 scenes, as in the
    # reference; closest_hit sends the others to the tile worklist.
    sub4 = rt.build_dense(t_mesh.displaced_grid_mesh(n=8, device=CPU),
                          cluster_size=32, sub_chunks=4)
    with pytest.raises(ValueError):
        t_pr.closest_hit_regrouped(sub4, tr)
    # Dispatch routes DenseScene, StaticTLAS and DenseInstancedScene
    # (tests/test_torch_instanced.py); any other object is refused.
    with pytest.raises(TypeError, match="no query route"):
        rt.closest_hit(object(), tr)
    with pytest.raises(TypeError, match="no query route"):
        rt.any_hit(object(), tr)
