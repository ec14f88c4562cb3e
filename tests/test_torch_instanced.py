"""Parity of the instanced engine with the JAX package, on the CPU: the
baked tables bit for bit, stage 1's candidates as a set, K2's plain
version in its pairrow mode against JAX's kernel in interpret mode,
closest_hit_instanced under the engine contract (equal hit masks, t
within rtol 2e-5 / atol 2e-6, a differing (instance, prim) only as a t
tie), refresh_instances, any_hit, the dispatch routes and bake_dense.
The scenes are tests/test_instanced_engine.py's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.ops import pallas_instanced as j_inst
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu.scene.bake import bake_dense as j_bake_dense
from raycore_tpu.scene.bake import flatten_world_triangles as j_flatten
from raycore_tpu.scene.instanced import bake_instanced as j_bake
from raycore_tpu.scene.instanced import refresh_instances as j_refresh
from raycore_tpu_torch import convert
from raycore_tpu_torch.accel import traversal as t_trav
from raycore_tpu_torch.core.transforms import _apply_mat3_fused
from raycore_tpu_torch.ops import affine as t_aff
from raycore_tpu_torch.ops import instanced as t_inst
from raycore_tpu_torch.ops import regroup as t_pr
from torch_parity import (CPU, Twin, bits, check_hits, engine_rays,
                          instanced_twin, jax_instanced_arrays,
                          jax_scene_arrays, np_, random_transform,
                          sphere_of)
from torch_adversarial import AFFINE_CASES, affine_case, affine_rays

INT32_MAX = 0x7FFFFFFF
_ARRAYS = ("tri_feats", "cluster_min", "cluster_max", "prims_hot",
           "inst_inv", "inst_blas", "inst_cbase", "inst_ncl",
           "inst_aabb_min", "inst_aabb_max", "inst_local_min",
           "inst_local_max", "root_aabb")
ENGINE_KW = dict(tile=256, subgroup=8, spb=16)


def assert_tables_equal(js, ts):
    for k in _ARRAYS:
        a, b = np_(getattr(js, k)), np_(getattr(ts, k))
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), k
    for k in ("vertices", "normals", "tangents", "uv"):
        assert np.array_equal(bits(getattr(js.prims, k)),
                              bits(getattr(ts.prims, k))), k
    assert np.array_equal(np_(js.prims.metadata).astype(np.int64),
                          np_(ts.prims.metadata))
    for k in ("n_instances", "cluster_size", "max_clusters_per_blas",
              "payload_mask"):
        assert getattr(js, k) == getattr(ts, k), k
    assert np.array_equal(np_(ts.inst_blas), ts.inst_blas_host)


def _rays(o, d, **kw):
    return (rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d), **kw),
            rt.Ray.create(torch.as_tensor(o), torch.as_tensor(d), **kw))


def check_instanced(ref, got):
    """The engine contract, with the winner named by (instance, prim)."""
    check_hits(ref, got)
    h = np_(ref.hit)
    same = (np_(ref.prim_idx)[h] == np_(got.prim_idx)[h]) \
        & (np_(ref.instance_idx)[h] == np_(got.instance_idx)[h])
    if not same.all():
        rt_, gt = np_(ref.t)[h][~same], np_(got.t)[h][~same]
        assert (np.abs(gt - rt_) / np.maximum(rt_, 1e-6)).max() < 2e-6


@pytest.fixture(scope="module")
def case12():
    """The 12-instance scene at C=32 and 2048 rays, with JAX's result."""
    tw, rng = instanced_twin()
    js, ts = j_bake(tw.j, cluster_size=32), rt.bake_instanced(tw.t,
                                                              cluster_size=32)
    o, d = engine_rays(rng)
    jr, tr = _rays(o, d)
    return dict(tw=tw, js=js, ts=ts, o=o, d=d, tr=tr,
                ref=j_inst.closest_hit_instanced(js, jr, **ENGINE_KW))


def test_bake_instanced_tables_match_jax(case12):
    assert_tables_equal(case12["js"], case12["ts"])
    conv = convert.instanced_scene_from_numpy(
        jax_instanced_arrays(case12["js"]), device=CPU)
    assert_tables_equal(case12["js"], conv)


def test_closest_hit_instanced_matches_jax(case12):
    got = t_inst.closest_hit_instanced(case12["ts"], case12["tr"],
                                       **ENGINE_KW)
    check_instanced(case12["ref"], got)
    assert int(got.hit.sum()) > 50
    # The same query on the tables converted from JAX's bake.
    conv = convert.instanced_scene_from_numpy(
        jax_instanced_arrays(case12["js"]), device=CPU)
    again = t_inst.closest_hit_instanced(conv, case12["tr"], **ENGINE_KW)
    for k in ("hit", "t", "prim_idx", "instance_idx", "barycentric"):
        assert torch.equal(getattr(got, k), getattr(again, k)), k


def _stage1_both(case):
    po, pd, ptn, ptx, _, G, TILE = t_pr._padded_batch(case["tr"], 256, 8)
    s1 = t_inst._stage1_inst_core(case["ts"], po, pd, ptn, ptx, TILE, G, 16)
    n_tiles, n_sub = po.shape[0] // TILE, po.shape[0] // G
    I = case["ts"].n_instances
    j = j_inst._stage1_inst(
        case["js"], *(jnp.asarray(np_(a)) for a in (po, pd, ptn, ptx)),
        TILE=TILE, G=G, SPB=16, P_cap=n_tiles * I, Q_cap=n_sub * I,
        interpret=True)
    return s1, j, G


def _candidates(block_cid, block_subs, n_blocks, Q):
    bc, bs = np_(block_cid)[:n_blocks], np_(block_subs)[:n_blocks]
    return {(int(p), int(c)) for c, row in zip(bc, bs) for p in row
            if p < Q and c >= 0}


def test_stage1_candidates_match_jax(case12):
    """qsub and qinst equal JAX's, the local ray table bit for bit, and the
    (pair, cluster row) candidates equal as a set (JAX's block order
    within a cluster is that of an unstable sort)."""
    s1, (bc, bs, tbl, qsub, qinst, totals), _ = _stage1_both(case12)
    coarse, q, nb = (int(x) for x in np_(totals))
    assert (s1.counts[0], s1.counts[1], s1.counts[3]) == (coarse, q, nb)
    assert np.array_equal(np_(qsub)[:q], np_(s1.qsub))
    assert np.array_equal(np_(qinst)[:q], np_(s1.qinst))
    assert np.array_equal(bits(np_(tbl)[:q]), bits(s1.tbl[:q]))
    assert _candidates(bc, bs, nb, q) == _candidates(
        s1.block_cid, s1.block_subs, nb, q)
    assert len(_candidates(s1.block_cid, s1.block_subs, nb, q)) \
        == s1.counts[2]


def test_pairrow_sweep_plain_matches_jax(case12):
    """K2's plain version in the pairrow mode against JAX's
    run_regrouped(payload="pairrow") in interpret mode on the same
    blocks: equal hit masks, t within rtol 2e-6 (the product's summation
    order), equal pair ids wherever the keys are equal; the prim mode's
    keys are the pairrow mode's; the kernel-order model names a sampled
    block by its index in the whole grid."""
    s1, _, G = _stage1_both(case12)
    ts = case12["ts"]
    C, SPB, nb = ts.cluster_size, 16, s1.counts[3]
    args = (s1.block_subs, s1.block_cid, s1.tbl, ts.tri_feats)
    kt, pt = t_pr.run_regrouped(*args, G=G, SPB=SPB, C=C, payload="pairrow")
    kj, pj = j_pr.run_regrouped(*(jnp.asarray(np_(a)) for a in args), G=G,
                                SPB=SPB, C=C, n_blocks=nb, interpret=True,
                                payload="pairrow")
    kj, pj, kt, pt = np_(kj), np_(pj), np_(kt), np_(pt)
    hj, ht = kj != INT32_MAX, kt != INT32_MAX
    assert np.array_equal(hj, ht) and hj.sum() > 0
    np.testing.assert_allclose(kt[hj].view(np.float32),
                               kj[hj].view(np.float32), rtol=2e-6, atol=0)
    same = kj == kt
    assert same[hj].mean() > 0.9
    assert np.array_equal(pj[same], pt[same])
    rows = np.arange(nb * SPB * G)
    assert np.array_equal(pt[ht] // C, rows[ht] // G)
    kp, _ = t_pr.run_regrouped(*args, G=G, SPB=SPB, C=C)
    assert np.array_equal(np_(kp), kt)
    blocks = torch.tensor([0, nb // 2, nb - 1])
    km, pm = t_pr.run_regrouped_model(*args, G=G, SPB=SPB, C=C,
                                      payload="pairrow", blocks=blocks)
    kall, pall = t_pr.run_regrouped_model(*args, G=G, SPB=SPB, C=C,
                                          payload="pairrow")
    sel = (blocks[:, None] * SPB * G + torch.arange(SPB * G)).reshape(-1)
    assert torch.equal(km, kall[sel]) and torch.equal(pm, pall[sel])


def test_pairrow_payload_int32_range():
    """The largest pairrow id, n_blocks*SPB*C - 1, must fit int32: one
    block past that raises on either device, before anything runs."""
    t_pr.check_sweep_payload("pairrow", 65536, 16, 2048)
    SPB, C, G = 16, 2048, 8
    nb = (1 << 31) // (SPB * C) + 1
    subs = torch.zeros((nb, SPB), dtype=torch.int32)
    cid = torch.zeros((nb,), dtype=torch.int32)
    tbl = torch.zeros((2, G, 16))
    feats = torch.zeros((1, 16, 4 * C))
    for fn in (t_pr.run_regrouped, t_pr.run_regrouped_plain,
               t_pr.run_regrouped_model):
        with pytest.raises(ValueError, match="int32"):
            fn(subs, cid, tbl, feats, G=G, SPB=SPB, C=C, payload="pairrow")
    with pytest.raises(ValueError, match="payload"):
        t_pr.run_regrouped(subs[:1], cid[:1], tbl, feats, G=G, SPB=SPB, C=C,
                           payload="cluster")


def test_instanced_defaults_ragged_batch():
    """tests/test_instanced_engine.py:test_instanced_default_params: five
    instances at C=64, 777 rays (not a power of two), default tiles."""
    tw, rng = instanced_twin(n_inst=5)
    js, ts = j_bake(tw.j, cluster_size=64), rt.bake_instanced(tw.t,
                                                              cluster_size=64)
    assert_tables_equal(js, ts)
    jr, tr = _rays(*engine_rays(rng, n=777))
    ref = j_inst.closest_hit_instanced(js, jr)
    got = rt.closest_hit(ts, tr)
    assert got.t.shape == (777,)
    check_instanced(ref, got)


def test_instanced_matches_traversal_and_any_hit(case12):
    """Against the port's own traversal (tests/test_instanced_engine.py's
    oracle, at its 2e-4), and any_hit's hit mask equals the closest
    hit's."""
    ts, tr = case12["ts"], case12["tr"]
    got = t_inst.closest_hit_instanced(ts, tr, **ENGINE_KW)
    ref = t_trav.closest_hit(case12["tw"].t.sync(), tr, tile_size=2048)
    h = np_(ref.hit)
    assert np.array_equal(h, np_(got.hit))
    np.testing.assert_allclose(np_(got.t)[h], np_(ref.t)[h], rtol=2e-4,
                               atol=2e-4)
    assert (np_(ref.instance_idx)[h] == np_(got.instance_idx)[h]).mean() \
        > 0.98
    occ = t_inst.any_hit_instanced(ts, tr, **ENGINE_KW)
    assert torch.equal(occ.hit, got.hit)
    assert torch.equal(occ.instance_idx[occ.hit], got.instance_idx[got.hit])


def test_t_ranges():
    """tests/test_instanced_engine.py:test_instanced_t_ranges: t_min past
    the plane misses, any_hit (t_min forced to 0) hits, a short t_max
    misses."""
    t = rt.TLAS(device=CPU)
    t.push(rt.plane_mesh(center=(0, 0, 0), u=(4, 0, 0), v=(0, 4, 0),
                         device=CPU))
    ds = rt.bake_instanced(t, cluster_size=32)
    o, d = torch.tensor([[0.1, 0.1, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    assert bool(t_inst.closest_hit_instanced(ds, rt.Ray.create(o, d)).hit[0])
    late = rt.Ray.create(o, d, t_min=5.0)
    assert not bool(t_inst.closest_hit_instanced(ds, late).hit[0])
    assert bool(t_inst.any_hit_instanced(ds, late).hit[0])
    short = rt.Ray.create(o, d, t_max=1.0)
    assert not bool(t_inst.closest_hit_instanced(ds, short).hit[0])


def test_refresh_dynamics_match_jax():
    """Transform-only updates: refresh_instances gives JAX's refreshed
    tables bit for bit with unchanged shapes, and the query follows the
    refit TLAS traversal."""
    tw, rng = instanced_twin(n_inst=8)
    js, ts = j_bake(tw.j, cluster_size=32), rt.bake_instanced(tw.t,
                                                              cluster_size=32)
    shapes = {k: tuple(getattr(ts, k).shape) for k in _ARRAYS}
    _, tr = _rays(*engine_rays(rng, n=1024))
    handles = list(tw.t._handles)
    for _ in range(2):
        for hid in handles[:4]:
            m = random_transform(rng)
            tw.j.update_transform(rc.TLASHandle(hid), m)
            tw.t.update_transform(rt.TLASHandle(hid), m)
        js, ts = j_refresh(js, tw.j), rt.refresh_instances(ts, tw.t)
        assert_tables_equal(js, ts)
        assert {k: tuple(getattr(ts, k).shape) for k in _ARRAYS} == shapes
        ref = t_trav.closest_hit(tw.t.sync(), tr, tile_size=2048)
        got = t_inst.closest_hit_instanced(ts, tr, **ENGINE_KW)
        h = np_(ref.hit)
        assert np.array_equal(h, np_(got.hit)) and h.sum() > 50
        np.testing.assert_allclose(np_(got.t)[h], np_(ref.t)[h], rtol=2e-4,
                                   atol=2e-4)


def test_refresh_rejects_changed_assignment():
    """A delete and push that keep the count but change a slot's BLAS,
    and a changed count, are refused: re-bake."""
    rng = np.random.default_rng(7)
    tw = Twin()
    h1 = tw.push(sphere_of, random_transform(rng))
    tw.push(sphere_of, random_transform(rng))
    tw.sync()
    ds = rt.bake_instanced(tw.t, cluster_size=32)
    tw.t.delete(h1)
    tw.t.push(rt.box_mesh(device=CPU), random_transform(rng))
    with pytest.raises(ValueError, match="re-bake"):
        rt.refresh_instances(ds, tw.t)
    tw.t.push(rt.box_mesh(device=CPU), random_transform(rng))
    with pytest.raises(ValueError, match="re-bake"):
        rt.refresh_instances(ds, tw.t)


def test_dispatch_routes(case12):
    """rt.closest_hit / rt.any_hit on the three scene forms: the
    instanced scene goes to the instanced engine, the StaticTLAS to the
    traversal (with its options), the baked DenseScene to the dense
    engines; traversal options on an instanced scene raise TypeError."""
    tw, ts, tr = case12["tw"], case12["ts"], case12["tr"]
    direct = t_inst.closest_hit_instanced(ts, tr)
    routed, fin = rt.closest_hit(ts, tr, deferred=True)
    assert fin is None
    for k in ("hit", "t", "prim_idx", "instance_idx"):
        assert torch.equal(getattr(direct, k), getattr(routed, k)), k
    assert torch.equal(rt.any_hit(ts, tr).hit, direct.hit)
    with pytest.raises(TypeError, match="instanced"):
        rt.closest_hit(ts, tr, stack_size=8)
    with pytest.raises(TypeError, match="instanced"):
        rt.any_hit(ts, tr, substeps=2)
    static = tw.t.sync()
    trav = rt.closest_hit(static, tr, stack_size=32, substeps=2)
    assert torch.equal(trav.hit, t_trav.closest_hit(static, tr).hit)
    assert torch.equal(rt.any_hit(static, tr).hit, trav.hit)
    baked = rt.bake_dense(tw.t)
    dense = rt.closest_hit(baked, tr)
    assert torch.equal(dense.hit, trav.hit)
    h = trav.hit
    assert (dense.instance_idx[h] == trav.instance_idx[h]).float().mean() \
        > 0.98


def test_bake_dense_matches_jax(case12):
    """flatten_world_triangles and bake_dense (C=128) bit for bit."""
    tw = case12["tw"]
    jsoup, jinst = j_flatten(tw.j)
    tsoup, tinst = rt.flatten_world_triangles(tw.t)
    for k in ("vertices", "normals", "tangents", "uv"):
        assert np.array_equal(bits(getattr(jsoup, k)),
                              bits(getattr(tsoup, k))), k
    assert np.array_equal(np_(jinst), np_(tinst))
    jd, td = j_bake_dense(tw.j), rt.bake_dense(tw.t)
    ja, ta = jax_scene_arrays(jd), jax_scene_arrays(td)
    for k in ("tri_feats", "cluster_min", "cluster_max", "sub_bounds",
              "prims_hot", "root_aabb"):
        assert np.array_equal(ja[k].view(np.int32), ta[k].view(np.int32)), k
    assert np.array_equal(np_(jd.instance_of_prim), np_(td.instance_of_prim))
    assert jd.payload_mask == td.payload_mask


def test_static_wrapper_and_capacity_hint(case12):
    """closest_hit_instanced_static returns the query's true counts
    beside the exact result; instanced_capacity_hint returns capacities
    no query of that size exceeds; with_checksum returns (result,
    None)."""
    ts, tr = case12["ts"], case12["tr"]
    caps = t_inst.instanced_capacity_hint(ts, 2048, **ENGINE_KW)
    res, totals = t_inst.closest_hit_instanced_static(
        ts, tr, p_cap=1, q_cap=1, nb=1, **ENGINE_KW)
    totals = np_(totals)
    assert totals.dtype == np.int32 and (totals > 0).all()
    assert (totals <= np.asarray(caps)).all()
    ref, cs = t_inst.closest_hit_instanced(ts, tr, with_checksum=True,
                                           **ENGINE_KW)
    assert cs is None
    for k in ("hit", "t", "prim_idx", "instance_idx"):
        assert torch.equal(getattr(res, k), getattr(ref, k)), k


# K8's plain versions (ops/affine.py), which run on CPU tensors: the
# expressions the refresh and the engine computed before the kernel.

def _affine_inverses(case):
    return t_aff.refresh_tables_plain(*(torch.as_tensor(a)
                                        for a in affine_case(case)))[0]


def _pair_operands(G, R=1024, Q=97, seed=2):
    rng = np.random.default_rng(seed)
    o, d = (torch.as_tensor(a) for a in affine_rays(R, seed))
    sub = torch.as_tensor(rng.integers(0, R // G, Q), dtype=torch.int32)
    t_min = torch.as_tensor(rng.uniform(0, 1, R).astype(np.float32))
    t_max = torch.where(torch.arange(R) % 3 == 0, -np.inf, np.inf).float()
    return o, d, sub, t_min, t_max, rng


@pytest.mark.parametrize("case", AFFINE_CASES)
@pytest.mark.parametrize("G", [8, 32])
def test_local_rays_pair_mode_is_the_gather_expression(G, case):
    """Pair mode equals, bit for bit, what stage 1 computed before K8:
    the subgroups' rays and the pairs' inverses gathered, through the
    fused dots, -0 directions turned into +0, t_min and t_max gathered."""
    inv = _affine_inverses(case)
    o, d, sub, t_min, t_max, rng = _pair_operands(G)
    inst = torch.as_tensor(rng.integers(0, inv.shape[0], sub.shape[0]),
                           dtype=torch.int32)
    got = t_aff.local_rays(inv, inst, o, d, (sub, t_min, t_max, G))
    n_sub, qs = o.shape[0] // G, sub.long()
    m = inv[inst.long()][:, None]
    R_, p, v = m[..., :3], o.reshape(n_sub, G, 3)[qs], \
        d.reshape(n_sub, G, 3)[qs]
    o_l = _apply_mat3_fused(R_, p) + m[..., 3]
    d_l = _apply_mat3_fused(R_, v)
    want = (o_l.reshape(-1, 3),
            torch.where(d_l == 0.0, 0.0, d_l).reshape(-1, 3),
            t_min.reshape(n_sub, G)[qs].reshape(-1),
            t_max.reshape(n_sub, G)[qs].reshape(-1))
    for g, w in zip(got, want):
        assert np.array_equal(bits(g), bits(w))
    assert not bool(((got[1] == 0) & torch.signbit(got[1])).any())


def test_local_rays_ray_mode_keeps_negative_zero():
    """Ray mode (the finalize's rays) keeps a -0 direction component, as
    the finalize did before K8; pair mode on the same rays turns it into
    +0; instance -1 reads instance 0."""
    inv = _affine_inverses("cell_poses")
    o, d, sub, t_min, t_max, _ = _pair_operands(8)
    inst = torch.arange(o.shape[0]) % inv.shape[0] - 1
    o_l, d_l = t_aff.local_rays(inv, inst, o, d)
    neg = (d_l == 0) & torch.signbit(d_l)
    assert int(neg.sum()) > 0
    first = inst == -1
    want = t_aff.local_rays(inv, torch.zeros_like(inst[first]), o[first],
                            d[first])
    assert np.array_equal(bits(o_l[first]), bits(want[0]))
    assert np.array_equal(bits(d_l[first]), bits(want[1]))
    every = torch.arange(o.shape[0] // 8, dtype=torch.int32)
    _, d_p, _, _ = t_aff.local_rays(inv, torch.zeros_like(every), o, d,
                                    (every, t_min, t_max, 8))
    assert not bool(((d_p == 0) & torch.signbit(d_p)).any())


def test_affine_counters_move_without_launching():
    """On the CPU the wrappers count their rows and launch nothing: a
    refresh and a query add rows (stage 1's pair rows and the finalize's
    rays) and leave ``launches`` alone."""
    tw, rng = instanced_twin(n_inst=6)
    ts = rt.bake_instanced(tw.t, cluster_size=32)
    _, tr = _rays(*engine_rays(rng, n=512))
    launches = (t_aff.refresh_tables.launches, t_aff.local_rays.launches)
    rows = t_aff.local_rays.rows
    ts = rt.refresh_instances(ts, tw.t)
    _, s1 = t_inst._query(ts, tr, **{"tile": 256, "subgroup": 8, "spb": 16})
    G = 8
    assert t_aff.local_rays.rows == rows + s1.qsub.shape[0] * G + 512
    assert (t_aff.refresh_tables.launches,
            t_aff.local_rays.launches) == launches
