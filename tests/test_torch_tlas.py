"""Parity of the TLAS manager and the two-level traversal with the JAX
package, on the CPU.

The manager: twins of tests/test_stress.py and tests/test_bvh.py:241-370
(push, multi-transform push, delete with compaction, update,
update_transform(s), rebuild against refit, instance_buffer, free,
instance-id override against inherit) run on both packages, and every
``StaticTLAS`` array is equal bit for bit. The traversal: closest_hit and
any_hit against JAX's traversal and the brute-force oracle under the
engine contract (equal hit masks, t within rtol 2e-5 / atol 2e-6, a
differing prim only as a t tie below 2e-6 relative; any_hit on its hit
mask), and the stack-overflow re-run.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import traversal as j_trav
from raycore_tpu_torch import convert
from raycore_tpu_torch.accel import traversal as t_trav
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import (CPU, Twin, box_of, sphere_of, assert_static_equal,
                          check_hits, engine_rays, instanced_twin,
                          jax_static_tlas_arrays, np_, random_transform,
                          translation)


def test_manager_mutations_match_jax():
    """Push, multi-transform push, refit, update_transforms,
    instance_buffer, geometry swap, delete with compaction: every sync
    gives JAX's StaticTLAS, and a refit keeps the shapes."""
    tw = Twin()
    h1 = tw.push(sphere_of, translation(0.0))
    trs = [translation(3.0 * k, 1.0) for k in range(3)]
    h2 = tw.push(box_of, transforms=trs, instance_ids=[0, 7, 0])
    _, s0 = tw.sync()
    assert tw.t.n_instances == 4 and tw.t.n_geometries == 2
    tw.update_transform(h1, random_transform(np.random.default_rng(1)))
    _, s1 = tw.sync()
    assert s1.unified_nodes.shape == s0.unified_nodes.shape
    tw.update_transforms(h2, [translation(1.0, 2.0, k) for k in range(3)])
    tw.sync()
    bj, bt = tw.j.instance_buffer(h2), tw.t.instance_buffer(h2)
    for b in (bj, bt):
        b[:, 0, 3] += 0.5
    js, ts = tw.j.refit_tlas(), rt.refit_tlas(tw.t)
    assert_static_equal(js, ts)
    tw.update(h1, lambda m: box_of(m, p_min=(-1, -1, -1), p_max=(1, 1, 1)))
    tw.sync()
    h3 = tw.push(lambda m: sphere_of(m, 0.5, 6, 8), translation(-4.0))
    tw.sync()
    tw.delete(h2)
    _, ts = tw.sync()
    assert tw.t.n_instances == 2 and not tw.t.is_valid(h2)
    assert tw.t.is_valid(h3)
    tw.t.free()
    assert tw.t.n_instances == 0 and tw.t.n_geometries == 0


def test_churn_matches_jax():
    """tests/test_stress.py's churn at a smaller step count: random push,
    delete, move and geometry swap, every sync equal to JAX's."""
    rng = np.random.default_rng(1234)
    tw = Twin()
    handles, xs, x_next = {}, {}, 0.0
    for _ in range(12):
        op = rng.integers(0, 4)
        if op == 0 or not handles:
            h = tw.push(lambda m: sphere_of(m, 0.4, 6, 8),
                        translation(x_next))
            handles[h.id], xs[h.id] = h, x_next
            x_next += 3.0
        elif op == 1 and len(handles) > 1:
            hid = list(handles)[rng.integers(0, len(handles))]
            tw.delete(handles.pop(hid))
            xs.pop(hid)
        elif op == 2:
            hid = list(handles)[rng.integers(0, len(handles))]
            xs[hid] += 0.5
            tw.update_transform(handles[hid], translation(xs[hid]))
        else:
            hid = list(handles)[rng.integers(0, len(handles))]
            nt = int(rng.integers(5, 9))
            tw.update(handles[hid], lambda m: sphere_of(m, 0.4, nt, 10))
        tw.sync()
    _, scene = tw.sync()
    for hid in handles:
        o = torch.tensor([[xs[hid] + 0.03, 0.02, -4.0]])
        r = rt.closest_hit(scene, rt.Ray.create(o, torch.tensor(
            [[0.0, 0.0, 1.0]])), tile_size=64)
        assert bool(r.hit[0]) and float(r.t[0]) == pytest.approx(3.6,
                                                                 abs=0.1)


def test_instance_ids_padding_and_handles():
    """Instance-id override against inherit, the world bound without the
    capacity padding, deleted handles and single-instance buffers raise,
    and a mesh on another device is refused."""
    t = rt.TLAS(device=CPU)
    h0 = t.push(sphere_of(t_mesh), None, instance_id=0)
    t.push(sphere_of(t_mesh), translation(3.0), instance_id=42)
    t.push(sphere_of(t_mesh), translation(-3.0))
    scene = t.sync()
    assert np_(scene.instances.instance_id)[:3].tolist() == [0, 42, 0]
    assert scene.instance_capacity == 4
    assert np.all(np.abs(t.world_bound()) < 5.0)
    with pytest.raises(ValueError, match="single-instance"):
        t.instance_buffer(h0)
    t.delete(h0)
    for op in (lambda: t.delete(h0), lambda: t.update(h0, box_of(t_mesh)),
               lambda: t.update_transform(h0, translation(1.0)),
               lambda: t.get_instance(h0)):
        with pytest.raises(KeyError):
            op()
    meta = dataclasses.replace(
        box_of(t_mesh), vertices=torch.zeros((12, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="device"):
        t.push(meta)
    tlas, handles = rt.TLAS.from_meshes([sphere_of(t_mesh), box_of(t_mesh)],
                                        [None, translation(3.0)])
    assert tlas.device == CPU and len(handles) == 2
    tlas, _ = rt.TLAS.from_primitives([box_of(t_mesh)],
                                      metadata_fn=lambda mi, ti: 100 + ti)
    assert sorted(np_(tlas.sync().prims.metadata)[:12].tolist()) == \
        list(range(100, 112))


@pytest.fixture(scope="module")
def instanced_case():
    tw, rng = instanced_twin()
    js, ts = tw.sync()
    o, d = engine_rays(rng)
    jr = rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))
    return dict(tw=tw, js=js, ts=ts, o=o, d=d,
                ref=j_trav.closest_hit(js, jr, tile_size=1024),
                ref_any=j_trav.any_hit(js, jr, tile_size=1024))


def _torch_rays(o, d, **kw):
    return rt.Ray.create(torch.as_tensor(o), torch.as_tensor(d), **kw)


def test_traversal_matches_jax_on_instances(instanced_case):
    c = instanced_case
    got = t_trav.closest_hit(c["ts"], _torch_rays(c["o"], c["d"]),
                             tile_size=1024)
    check_hits(c["ref"], got)
    assert np.array_equal(np_(c["ref"].instance_idx)[np_(got.hit)],
                          np_(got.instance_idx)[np_(got.hit)])
    assert int(got.hit.sum()) > 50
    anyh = t_trav.any_hit(c["ts"], _torch_rays(c["o"], c["d"]),
                          tile_size=1024)
    assert np.array_equal(np_(c["ref_any"].hit), np_(anyh.hit))
    assert np.array_equal(np_(anyh.hit), np_(got.hit))


def test_traversal_matches_oracle_on_world_soup(instanced_case):
    """Against the brute-force oracle on the world-space soup
    (flatten_world_triangles): the traversal tests in local space, so t
    and hit masks agree within tests/test_instanced_engine.py's 2e-4."""
    c = instanced_case
    soup, inst_of = rt.flatten_world_triangles(c["tw"].t)
    rays = _torch_rays(c["o"], c["d"])
    got = t_trav.closest_hit(c["ts"], rays, tile_size=1024)
    ref = rt.closest_hit_brute(soup, rays)
    h = np_(ref.hit)
    assert np.array_equal(h, np_(got.hit))
    np.testing.assert_allclose(np_(got.t)[h], np_(ref.t)[h], rtol=2e-4,
                               atol=2e-4)
    ii = np_(inst_of)[np_(ref.prim_idx)[h]]
    assert (ii == np_(got.instance_idx)[h]).mean() > 0.98


@pytest.mark.parametrize("n_tris", [5, 100, 777])
def test_traversal_matches_jax_and_brute_on_one_blas(n_tris):
    """tests/test_bvh.py:test_closest_hit_matches_brute's scenes (metadata
    names each triangle), against JAX's traversal and the oracle."""
    rng = np.random.default_rng(n_tris)
    base = rng.uniform(-2, 2, (n_tris, 1, 3)).astype(np.float32)
    v = base + rng.uniform(-0.1, 0.1, (n_tris, 3, 3)).astype(np.float32)
    meta = np.arange(n_tris)
    jt = rc.Triangle.create(jnp.asarray(v), metadata=jnp.asarray(
        meta.astype(np.uint32)))
    tt = rt.Triangle.create(torch.as_tensor(v), metadata=torch.as_tensor(meta))
    c = v.mean(1)
    tgt = c[rng.integers(0, n_tris, 256)] \
        + rng.normal(0, 0.02, (256, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (256, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js = rc.blas_to_static_tlas(rc.build_blas(jt))
    ts = rt.blas_to_static_tlas(rt.build_blas(tt))
    assert_static_equal(js, ts)
    ref = j_trav.closest_hit(js, rc.Ray.create(o=jnp.asarray(o),
                                               d=jnp.asarray(d)))
    got = rt.closest_hit(ts, _torch_rays(o, d))
    check_hits(ref, got)
    oracle = rt.closest_hit_brute(tt, _torch_rays(o, d))
    h = np_(oracle.hit)
    assert np.array_equal(h, np_(got.hit)) and h.sum() > 30
    np.testing.assert_allclose(np_(got.t)[h], np_(oracle.t)[h], rtol=2e-5,
                               atol=2e-6)
    same = np_(got.triangle.metadata)[h] == np_(oracle.prim_idx)[h]
    if not same.all():
        rel = np.abs(np_(got.t)[h][~same] - np_(oracle.t)[h][~same]) \
            / np_(oracle.t)[h][~same]
        assert rel.max() < 2e-6


def test_stack_overflow_is_detected_and_rerun():
    """tests/test_bvh.py:test_stack_overflow_detected_and_retried: slivers
    with near-duplicate centroids make deep index-tiebreak subtrees; at
    stack_size=4 the short-stack pass overflows and the query re-runs at
    the proven bound, matching the oracle and JAX."""
    rng = np.random.default_rng(1234)
    base = rng.uniform(-0.01, 0.01, (40, 1, 3)).astype(np.float32) \
        + rng.uniform(-0.5, 0.5, (40, 3, 3)).astype(np.float32)
    far = rng.uniform(-2, 2, (24, 1, 3)).astype(np.float32) \
        + rng.uniform(-0.2, 0.2, (24, 3, 3)).astype(np.float32)
    v = np.concatenate([base, far])
    tt = rt.Triangle.create(torch.as_tensor(v))
    ts = rt.blas_to_static_tlas(rt.build_blas(tt))
    c = v.mean(1)
    tgt = c[rng.integers(0, len(c), 128)] \
        + rng.normal(0, 0.02, (128, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (128, 3)).astype(np.float32)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    rays = _torch_rays(o, d.astype(np.float32))
    flat = (rays.o, rays.d, rays.t_min, rays.t_max)
    kw = dict(any_hit=False, max_iters=1 << 17, tile_size=128)
    _, ovf_small = t_trav._trace(ts, *flat, stack_size=4, **kw)
    assert ovf_small
    _, ovf_bound = t_trav._trace(ts, *flat,
                                 stack_size=t_trav.stack_depth_bound(ts),
                                 **kw)
    assert not ovf_bound
    small = t_trav.closest_hit(ts, rays, stack_size=4)
    oracle = rt.closest_hit_brute(tt, rays)
    h = np_(oracle.hit)
    assert np.array_equal(h, np_(small.hit))
    np.testing.assert_allclose(np_(small.t)[h], np_(oracle.t)[h], rtol=2e-5,
                               atol=2e-6)
    js = rc.blas_to_static_tlas(rc.build_blas(rc.Triangle.create(
        jnp.asarray(v))))
    ref = j_trav.closest_hit(js, rc.Ray.create(
        o=jnp.asarray(o), d=jnp.asarray(d.astype(np.float32))), stack_size=4)
    check_hits(ref, small)


def test_t_range_and_any_hit_semantics():
    """tests/test_bvh.py:test_t_min_respected: closest_hit honours t_min
    and t_max, any_hit forces t_min to 0."""
    t = rt.TLAS(device=CPU)
    t.push(t_mesh.plane_mesh(center=(0, 0, 0), u=(2, 0, 0), v=(0, 2, 0),
                             device=CPU))
    scene = t.sync()
    up = torch.tensor([[0.0, 0.0, 1.0]])
    late = rt.Ray.create(torch.tensor([[0.0, 0.0, -1.0]]), up, t_min=2.0)
    assert not bool(rt.closest_hit(scene, late).hit[0])
    assert bool(rt.any_hit(scene, late).hit[0])
    short = rt.Ray.create(torch.tensor([[0.0, 0.0, -5.0]]), up, t_max=4.0)
    assert not bool(rt.closest_hit(scene, short).hit[0])
    res, fin = rt.closest_hit(scene, short, deferred=True, stack_size=8,
                              substeps=2)
    assert fin is None and not bool(res.hit[0])


def test_traversal_on_jax_built_tables(instanced_case):
    """convert.static_tlas_from_numpy takes JAX's StaticTLAS; the port's
    traversal on it gives the port's result on its own tables."""
    c = instanced_case
    conv = convert.static_tlas_from_numpy(jax_static_tlas_arrays(c["js"]),
                                          device=CPU)
    assert_static_equal(c["js"], conv)
    rays = _torch_rays(c["o"][:256], c["d"][:256])
    a = t_trav.closest_hit(conv, rays)
    b = t_trav.closest_hit(c["ts"], rays)
    for k in ("hit", "t", "prim_idx", "instance_idx", "barycentric"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
