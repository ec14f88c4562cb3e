"""Parity of the packed sub-cluster sweep (kernel K5's plain version), its
stage 1 and ``closest_hit_packed`` with the JAX package, on the CPU.

Sizes are the JAX package's own packed tests
(tests/test_pallas_regroup.py:421-450 and :540): ``displaced_grid_mesh``
n=40, C=128, SUBC=4 (and SUBC=1), 1024 rays. Tolerances:
- ``subchunk_bounds``: bitwise;
- stage 1: the same set of subgroups per sub-cluster and the same counts
  (JAX groups with an unstable sort, so which subgroups share a block is
  not part of the contract);
- the sweep: equal hit masks, decoded t within rtol 2e-6 (the product's
  summation order may differ), equal pairs where the keys are equal;
- end to end: the JAX package's engine contract (``check_hits``) against
  JAX's ``closest_hit_packed`` and against the brute-force oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.accel.brute import closest_hit_brute as j_brute
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch import convert
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.scene import mesh as t_mesh
from test_torch_regroup import _sweep_close
from torch_parity import (CPU, bits, check_hits, jax_rays, jax_scene_arrays,
                          np_, ray_arrays, torch_rays)

INT32_MAX = 0x7FFFFFFF


def _scenes(SUBC=4, C=128):
    return (j_dense.build_dense(j_mesh.displaced_grid_mesh(n=40),
                                cluster_size=C, sub_chunks=SUBC),
            rt.build_dense(t_mesh.displaced_grid_mesh(n=40, device=CPU),
                           cluster_size=C, sub_chunks=SUBC))


def _stage1(ts, o, d, tile=512, G=32, spb_sub=2):
    po, pd, ptmin, ptmax, _, G, TILE = t_pr._padded_batch(
        torch_rays(o, d), tile, G)
    out = t_pr._stage1_packed_core(ts, po, pd, ptmin, ptmax, TILE, G,
                                   spb_sub)
    return out, (po, pd, ptmin, ptmax), G, TILE


def _subgroups_per_subcluster(block_cid, block_subs, n_sub):
    """{sub-cluster: sorted real subgroups} over the given blocks."""
    out = {}
    for q, subs in zip(np_(block_cid).tolist(), np_(block_subs).tolist()):
        out.setdefault(q, []).extend(s for s in subs if s != n_sub)
    return {q: sorted(s) for q, s in out.items()}


@pytest.mark.parametrize("SUBC", [4, 1])
def test_subchunk_bounds_match_jax(SUBC):
    js, ts = _scenes(SUBC)
    for a, b in zip(j_pr.subchunk_bounds(js), t_pr.subchunk_bounds(ts)):
        assert np.array_equal(bits(a), bits(b))
    assert tuple(t_pr.subchunk_bounds(ts)[0].shape) == \
        (ts.n_clusters * SUBC, 3)


@pytest.mark.parametrize("SUBC,spb_sub,coherent", [(4, 2, False),
                                                   (4, 4, True),
                                                   (1, 2, False)])
def test_stage1_blocks_match_jax_as_sets(SUBC, spb_sub, coherent):
    js, ts = _scenes(SUBC)
    o, d = ray_arrays(R=1024, seed=3, coherent=coherent)
    (bc, bs, tbl, counts), rows, G, TILE = _stage1(ts, o, d,
                                                   spb_sub=spb_sub)
    n_tiles, n_sub = rows[0].shape[0] // TILE, rows[0].shape[0] // G
    K = ts.n_clusters
    jbc, jbs, _, totals = j_pr._stage1_packed(
        js, *(jnp.asarray(np_(a)) for a in rows), TILE=TILE, G=G,
        SPB_sub=spb_sub, P_cap=n_tiles * K, Q_cap=n_sub * K, interpret=True)
    coarse, q_total, total = (int(x) for x in np.asarray(totals))
    assert (counts[0], counts[1], counts[3]) == (coarse, q_total, total)
    assert counts[2] >= counts[3] > 0
    got = _subgroups_per_subcluster(bc, bs, n_sub)
    ref = _subgroups_per_subcluster(np.asarray(jbc)[:total],
                                    np.asarray(jbs)[:total], n_sub)
    assert got == ref
    # Blocks of one sub-cluster are adjacent, each fills its SPB_sub slots
    # before the next starts, and only a sub-cluster's last block has
    # dummy slots.
    bc_, bs_ = np_(bc), np_(bs)
    assert (np.diff(bc_) >= 0).all()
    last = np.append(bc_[1:] != bc_[:-1], True)
    assert not (bs_[~last] == n_sub).any()


def _jax_run_packed(bs, bc, tbl, feats, *, G, SPB_sub, PACKS, C_eff, SUBC):
    """JAX's run_packed (interpret mode) on the port's blocks, padded with
    q = -1 blocks to a multiple of PACKS as it requires."""
    nb = bc.shape[0]
    pad = (-nb) % PACKS
    n_sub = tbl.shape[0] - 1
    bs = np.concatenate([np_(bs), np.full((pad, SPB_sub), n_sub, np.int32)])
    bc = np.concatenate([np_(bc), np.full((pad,), -1, np.int32)])
    kj, pj = j_pr.run_packed(jnp.asarray(bs), jnp.asarray(bc),
                             jnp.asarray(np_(tbl)), feats, G=G,
                             SPB_sub=SPB_sub, PACKS=PACKS, C_eff=C_eff,
                             SUBC=SUBC, n_blocks=nb + pad, interpret=True)
    rows = nb * G * SPB_sub
    return np.asarray(kj)[:rows], np.asarray(pj)[:rows]


@pytest.mark.parametrize("SUBC,spb_sub,packs", [(4, 2, 8), (4, 4, 4),
                                                (1, 2, 4)])
def test_sweep_plain_matches_jax_run_packed(SUBC, spb_sub, packs):
    js, ts = _scenes(SUBC)
    o, d = ray_arrays(R=1024, seed=2)
    (bc, bs, tbl, _), _, G, _ = _stage1(ts, o, d, spb_sub=spb_sub)
    C_eff = ts.cluster_size // SUBC
    kw = dict(G=G, SPB_sub=spb_sub, C_eff=C_eff, SUBC=SUBC)
    kj, pj = _jax_run_packed(bs, bc, tbl, js.tri_feats, PACKS=packs, **kw)
    kt, pt = t_pr.run_packed(bs, bc, tbl, ts.tri_feats, PACKS=packs, **kw)
    _sweep_close(kj, pj, kt, pt)


def test_sweep_padding_blocks_and_dummy_subgroup():
    """Random tables: blocks with q = -1 write the miss sentinels, the
    dummy subgroup never hits, a block count that is not a multiple of
    PACKS is taken as it is, and real blocks agree with JAX's kernel."""
    rng = np.random.default_rng(5)
    G, SPB_sub, PACKS, C_eff, SUBC, n_sub, K, nb = 8, 2, 4, 16, 4, 20, 3, 11
    tbl = rng.normal(size=(n_sub + 1, G, 16)).astype(np.float32)
    tbl[:, :, 13] = 0.0
    tbl[:, :, 14] = 10.0
    tbl[-1, :, 14] = -np.inf
    feats = rng.normal(size=(K, 16, 4 * C_eff * SUBC)).astype(np.float32)
    feats[:, 10:] = 0.0
    subs = rng.integers(0, n_sub + 1, (nb, SPB_sub)).astype(np.int32)
    subs[0, 1] = n_sub
    cids = rng.integers(0, K * SUBC, (nb,)).astype(np.int32)
    cids[[2, 9]] = -1
    kw = dict(G=G, SPB_sub=SPB_sub, C_eff=C_eff, SUBC=SUBC)
    kj, pj = _jax_run_packed(subs, cids, tbl, jnp.asarray(feats),
                             PACKS=PACKS, **kw)
    kt, pt = t_pr.run_packed(torch.as_tensor(subs), torch.as_tensor(cids),
                             torch.as_tensor(tbl), torch.as_tensor(feats),
                             PACKS=PACKS, **kw)
    rows = G * SPB_sub
    kt2, pt2 = np_(kt).reshape(nb, rows), np_(pt).reshape(nb, rows)
    assert (kt2[[2, 9]] == INT32_MAX).all() and (pt2[[2, 9]] == -1).all()
    assert (kt2[0, G:] == INT32_MAX).all()          # dummy subgroup slot
    hit = pt2 >= 0
    q = cids[:, None].repeat(rows, 1)
    assert ((pt2[hit] // C_eff) == q[hit]).all()    # pair = q*C_eff + lane
    valid = np.repeat(cids >= 0, rows)
    _sweep_close(kj[valid], pj[valid], np_(kt)[valid], np_(pt)[valid])


@pytest.mark.parametrize("SUBC,packs,spb_sub,R,seed,t_range", [
    (4, 4, 4, 1024, 3, False), (1, 4, 2, 1024, 7, False),
    (4, 8, 2, 777, 5, True)], ids=["subc4", "subc1", "ragged-t-range"])
def test_closest_hit_packed_matches_jax_and_oracle(SUBC, packs, spb_sub, R,
                                                   seed, t_range):
    js, ts = _scenes(SUBC)
    o, d = ray_arrays(R=R, seed=seed)
    kw = {}
    if t_range:
        # tests/test_pallas_regroup.py:460-466: t_min halfway to the first
        # hit, t_max short of some hits.
        t0 = np_(j_brute(js.prims, jax_rays(o, d)).t)
        kw = dict(t_min=(t0 * 0.5 + 0.1).astype(np.float32),
                  t_max=np.full(R, 2.2, np.float32))
    jr = jax_rays(o, d, **{k: jnp.asarray(v) for k, v in kw.items()})
    tr = torch_rays(o, d, **{k: torch.as_tensor(v) for k, v in kw.items()})
    got = t_pr.closest_hit_packed(ts, tr, tile=512, packs=packs,
                                  spb_sub=spb_sub)
    ref = j_pr.closest_hit_packed(js, jr, tile=512, packs=packs,
                                  spb_sub=spb_sub)
    oracle = j_brute(js.prims, jr)
    assert np_(oracle.hit).sum() > 50
    check_hits(ref, got)
    check_hits(oracle, got)
    assert np.array_equal(np_(ref.instance_idx), np_(got.instance_idx))
    h = np_(got.hit)
    np.testing.assert_allclose(np_(got.barycentric)[h],
                               np_(ref.barycentric)[h], atol=2e-5)


def test_packed_equals_regrouped_on_the_same_mesh():
    """The same (ray, triangle) tests in both engines: the packed result
    on a SUBC=4 scene and at cluster granularity equals the regrouped
    result on the SUBC=1 build of the same mesh, ray for ray."""
    _, ts1 = _scenes(1)
    _, ts4 = _scenes(4)
    o, d = ray_arrays(R=1024, seed=4)
    tr = torch_rays(o, d)
    ref = t_pr.closest_hit_regrouped(ts1, tr, tile=512)
    for got in (t_pr.closest_hit_packed(ts4, tr, tile=512),
                t_pr.closest_hit_packed(ts1, tr, tile=512)):
        assert torch.equal(got.hit, ref.hit)
        assert torch.equal(got.prim_idx, ref.prim_idx)
        assert torch.equal(got.t.view(torch.int32), ref.t.view(torch.int32))


def test_query_on_sub_chunked_scene_converted_from_jax():
    """The query alone, on SUBC=4 tables the JAX package built."""
    js, _ = _scenes(4)
    scene = convert.dense_scene_from_numpy(jax_scene_arrays(js), device=CPU)
    o, d = ray_arrays(R=1024, seed=9)
    got = t_pr.closest_hit_packed(scene, torch_rays(o, d), tile=512)
    check_hits(j_pr.closest_hit_packed(js, jax_rays(o, d), tile=512), got)


def test_batch_shape_and_small_batches():
    _, ts = _scenes(4)
    o, d = ray_arrays(R=750, seed=6)
    tr = torch_rays(o, d)
    flat = t_pr.closest_hit_packed(ts, tr)
    r2 = rt.Ray.create(tr.o.reshape(25, 30, 3), tr.d.reshape(25, 30, 3))
    res2 = t_pr.closest_hit_packed(ts, r2)
    assert res2.hit.shape == (25, 30)
    assert res2.triangle.vertices.shape == (25, 30, 3, 3)
    assert torch.equal(res2.prim_idx.reshape(-1), flat.prim_idx)
    one = t_pr.closest_hit_packed(ts, rt.Ray.create(
        torch.tensor([0.1, 0.2, 2.0]), torch.tensor([0.0, 0.0, -1.0])))
    assert one.hit.shape == () and bool(one.hit)
