"""Parity of the rounds engine (``accel/dense.py:closest_hit_dense``,
``any_hit_dense`` and ``morton_sort_rays``) with the JAX package, on the
CPU.

Twins of ``tests/test_dense.py``'s query tests: the same seeded inputs
through both packages, the port held to JAX under the engine contract
(``torch_parity.check_hits``: equal hit masks, t within rtol 2e-5 and
atol 2e-6, a differing prim only as a t tie) and to the JAX test's own
assertions. Phase A on this path is the port's K1 (``ops/dense.py:
phase_a_entry``), held to JAX's ``_phase_a_tile_entry`` with
``assert_array_equal`` (+0 equals -0, Q6).
"""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.core.triangle import safe_invdir as j_safe_invdir
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch.accel import dense as t_dense
from raycore_tpu_torch.ops import dense as t_ops
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_adversarial import stage1_rows
from torch_parity import (CPU, check_hits, jax_rays, np_, ray_arrays,
                          torch_rays)


@pytest.fixture(scope="module")
def heightfield():
    kw = dict(n=32, extent=2.0, amplitude=0.3)
    return (j_dense.build_dense(j_mesh.displaced_grid_mesh(**kw),
                                cluster_size=64),
            rt.build_dense(t_mesh.displaced_grid_mesh(**kw, device=CPU),
                           cluster_size=64))


def _grid(side, z=2.0, half=0.9):
    xs = np.linspace(-half, half, side, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    o = np.stack([X, Y, np.full_like(X, z)], -1).reshape(-1, 3)
    d = np.broadcast_to(np.float32([0, 0, -1]), o.shape).copy()
    return o, d


def _both(js, ts, o, d, jax_kw=None, **kw):
    """The same rays through both packages' closest_hit_dense."""
    ref = j_dense.closest_hit_dense(js, jax_rays(o, d, **(jax_kw or {})),
                                    **kw)
    got = rt.closest_hit_dense(ts, torch_rays(o, d, **(jax_kw or {})), **kw)
    return ref, got


def test_rounds_match_jax_and_brute_coherent(heightfield):
    js, ts = heightfield
    o, d = _grid(40)
    ref, got = _both(js, ts, o, d, tile=256)
    check_hits(ref, got)
    rb = rt.closest_hit_brute(ts.prims, torch_rays(o, d))
    m = np_(got.hit)
    assert m.all() and np.array_equal(m, np_(rb.hit))
    np.testing.assert_allclose(np_(got.t)[m], np_(rb.t)[m], rtol=1e-4,
                               atol=1e-4)
    assert (np_(got.prim_idx)[m] == np_(rb.prim_idx)[m]).mean() > 0.97


def test_rounds_match_jax_incoherent(heightfield):
    js, ts = heightfield
    rng = np.random.default_rng(1234)
    n = 400
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    verts = np_(ts.prims.vertices)
    d = verts[rng.integers(0, len(verts), n)].mean(1) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ref, got = _both(js, ts, o, d, tile=128, select_per_round=2)
    check_hits(ref, got)
    rb = rt.closest_hit_brute(ts.prims, torch_rays(o, d))
    assert np.array_equal(np_(got.hit), np_(rb.hit))
    m = np_(got.hit)
    np.testing.assert_allclose(np_(got.t)[m], np_(rb.t)[m], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("ray,kw,hit", [
    (([0.0, 0, 2.0], [0.0, 0, -1.0]), dict(t_max=1.0), False),
    (([0.0, 0, 2.0], [0.0, 0, -1.0]), dict(t_min=5.0), False),
    (([0.0, 0, 2.0], [0.0, 0, -1.0]), {}, True),
    (([9.0, 9, 2.0], [0.0, 0, -1.0]), {}, False)])
def test_rounds_t_range_semantics(heightfield, ray, kw, hit):
    js, ts = heightfield
    o, d = (np.float32(v) for v in ray)
    ref, got = _both(js, ts, o, d, jax_kw=kw, tile=8)
    assert bool(ref.hit) == bool(got.hit) == hit
    assert float(got.t) == pytest.approx(float(ref.t), rel=2e-5, abs=2e-6)
    if not hit:      # the zero sentinel on a miss
        assert (np_(got.triangle.vertices) == 0).all()
        assert int(got.prim_idx) == int(got.instance_idx) == -1


@pytest.mark.parametrize("t_min", [0.0, 5.0])
def test_any_hit_dense(heightfield, t_min):
    js, ts = heightfield
    o, d = np.float32([0.0, 0, 2.0]), np.float32([0.0, 0, -1.0])
    ref = j_dense.any_hit_dense(js, jax_rays(o, d, t_min=t_min), tile=8)
    got = rt.any_hit_dense(ts, torch_rays(o, d, t_min=t_min), tile=8)
    assert bool(got.hit) and bool(ref.hit)      # t_min forced to 0
    assert int(got.prim_idx) == int(ref.prim_idx)


def test_any_hit_dense_batch_matches_jax(heightfield):
    js, ts = heightfield
    o, d = ray_arrays(R=512, seed=3)
    ref = j_dense.any_hit_dense(js, jax_rays(o, d, t_min=0.5), tile=128)
    got = rt.any_hit_dense(ts, torch_rays(o, d, t_min=0.5), tile=128)
    check_hits(ref, got)


def test_rounds_nonpow2_counts():
    kw = dict(radius=1.0, n_theta=11, n_phi=23)      # odd count
    js = j_dense.build_dense(j_mesh.sphere_mesh(**kw), cluster_size=32)
    ts = rt.build_dense(t_mesh.sphere_mesh(**kw, device=CPU),
                        cluster_size=32)
    o, d = np.float32([0.05, 0.02, -4.0]), np.float32([0.0, 0, 1.0])
    ref, got = _both(js, ts, o, d, tile=8)
    assert bool(got.hit) and float(got.t) == pytest.approx(3.0, abs=0.05)
    check_hits(ref, got)


def test_rounds_payload_fields_follow_probe():
    """A Triangle that shares vertices but gains uv must report its uv
    (tests/test_dense.py:test_probe_cache_tracks_payload_fields)."""
    jm = j_mesh.sphere_mesh(radius=1.0, n_theta=8, n_phi=16)
    tm = t_mesh.sphere_mesh(radius=1.0, n_theta=8, n_phi=16, device=CPU)
    tm0 = dataclasses.replace(tm, uv=torch.zeros_like(tm.uv))
    assert not rt.build_dense(tm0, cluster_size=32).payload_mask & 4
    tm1 = dataclasses.replace(tm0, uv=torch.ones_like(tm0.uv))
    ts = rt.build_dense(tm1, cluster_size=32)
    js = j_dense.build_dense(jm.replace(uv=jnp.ones_like(jm.uv)),
                             cluster_size=32)
    assert ts.payload_mask & 4
    o, d = np.float32([0.05, 0.02, -4.0]), np.float32([0.0, 0, 1.0])
    ref, got = _both(js, ts, o, d, tile=8)
    assert bool(got.hit) and float(got.triangle.uv.abs().max()) > 0.0
    assert np.array_equal(np_(ref.triangle.uv), np_(got.triangle.uv))


@pytest.mark.parametrize("smooth", [False, True])
def test_rounds_flat_and_smooth_normals(smooth):
    jm = j_mesh.displaced_grid_mesh(n=16)
    tm = t_mesh.displaced_grid_mesh(n=16, device=CPU)
    if smooth:
        jm = jm.replace(normals=jnp.ones_like(jm.normals))
        tm = dataclasses.replace(tm, normals=torch.ones_like(tm.normals))
    js = j_dense.build_dense(jm, cluster_size=32)
    ts = rt.build_dense(tm, cluster_size=32)
    assert bool(ts.payload_mask & 8) == (not smooth)
    o, d = _grid(16, z=3.0, half=0.8)
    ref, got = _both(js, ts, o, d, tile=64)
    check_hits(ref, got)
    assert np_(got.hit).all()
    if smooth:
        np.testing.assert_allclose(np_(got.triangle.normals), 1.0)
    else:
        stored = np_(tm.normals)[np_(got.prim_idx)]
        np.testing.assert_allclose(np_(got.triangle.normals), stored,
                                   atol=2e-6)


def test_rounds_on_baked_tlas_match_traversal():
    """tests/test_dense.py:test_bake_dense_matches_tlas on the port: the
    rounds engine on the baked scene against the traversal, and against
    JAX's rounds engine on JAX's baked scene."""
    from raycore_tpu.scene.bake import bake_dense as j_bake
    from torch_parity import Twin, box_of, sphere_of
    tw = Twin()
    tw.push(lambda p: sphere_of(p, nt=12, nphi=24), None)
    tr = np.eye(3, 4, dtype=np.float32)
    tr[0, 3] = 3.0
    tr[:, :3] *= 0.5
    tw.push(box_of, tr)
    _, t_static = tw.sync()
    js = j_bake(tw.j, cluster_size=64)
    ts = rt.bake_dense(tw.t, cluster_size=64)
    xs = np.linspace(-1.5, 4.0, 24, dtype=np.float32)
    X, Y = np.meshgrid(xs, np.linspace(-1.2, 1.2, 16, dtype=np.float32),
                       indexing="ij")
    o = np.stack([X, Y, np.full_like(X, -4.0)], -1).reshape(-1, 3)
    d = np.broadcast_to(np.float32([0, 0, 1]), o.shape).copy()
    ref, got = _both(js, ts, o, d, tile=128)
    check_hits(ref, got)
    trav = rt.closest_hit(t_static, torch_rays(o, d), tile_size=128)
    m = np_(trav.hit)
    assert np.array_equal(m, np_(got.hit))
    np.testing.assert_allclose(np_(trav.t)[m], np_(got.t)[m], rtol=2e-4,
                               atol=2e-4)
    assert np.array_equal(np_(trav.instance_idx)[m],
                          np_(got.instance_idx)[m])
    assert np_(got.instance_idx)[~m].max(initial=-1) == -1


# --- phase A on the rounds path: the port's K1 against JAX -------------

_O = np.array([0.3, 0.7 - 1e-6, 3.0], np.float32)   # 1e-6 inside the y face
_D = np.array([0.0, 0.0, -1.0], np.float32)
_BMIN = np.array([-1.0, -1.0, -1.0], np.float32)
_BMAX = np.array([1.0, 0.7, 0.0], np.float32)


def _jax_tile_entry(scene, o, d, t_min, t_max, n_tiles, tile):
    d = jnp.where(d == 0.0, 0.0, d)
    return j_dense._phase_a_tile_entry(scene, o, d, j_safe_invdir(d), t_min,
                                       t_max, n_tiles=n_tiles, tile=tile)


@pytest.mark.parametrize("outside", [False, True])
def test_phase_a_entry_parallel_ray_matches_jax(outside):
    """tests/test_interval_parallel.py:41 and :65: a ray parallel to the y
    face with its origin 1e-6 inside keeps the box (entry 3); 1e-3
    outside it is pruned."""
    o = np.broadcast_to(_O, (8, 3)).copy()
    if outside:
        o[:, 1] = 0.7 + 1e-3
    d = np.broadcast_to(_D, (8, 3)).copy()
    t_min = np.zeros(8, np.float32)
    t_max = np.full(8, np.inf, np.float32)
    jscene = SimpleNamespace(cluster_min=jnp.asarray(_BMIN)[None],
                             cluster_max=jnp.asarray(_BMAX)[None],
                             n_clusters=1)
    ref = _jax_tile_entry(jscene, *(jnp.asarray(a) for a in
                                    (o, d, t_min, t_max)), 1, 8)
    got = t_ops.phase_a_entry(
        *stage1_rows(*(torch.as_tensor(a) for a in (o, d, t_min, t_max))),
        torch.as_tensor(_BMIN)[None], torch.as_tensor(_BMAX)[None], 8)
    np.testing.assert_array_equal(np_(got), np.asarray(ref))
    if outside:
        assert not np.isfinite(np_(got)[0, 0])
    else:
        assert abs(float(got[0, 0]) - 3.0) < 1e-3


@pytest.mark.parametrize("coherent,zero_dirs,tile", [
    (True, False, 256), (False, True, 64), (False, False, 512)])
def test_phase_a_entry_matches_jax_tile_entry(heightfield, coherent,
                                             zero_dirs, tile):
    js, ts = heightfield
    o, d = ray_arrays(R=1024, seed=5, coherent=coherent, zero_dirs=zero_dirs)
    t_min = np.zeros(len(o), np.float32)
    t_max = np.full(len(o), np.inf, np.float32)
    t_max[3::7] = 1.5
    n = len(o) // tile
    ref = _jax_tile_entry(js, *(jnp.asarray(a) for a in (o, d, t_min,
                                                         t_max)), n, tile)
    got = t_ops.phase_a_entry(
        *stage1_rows(*(torch.as_tensor(a) for a in (o, d, t_min, t_max))),
        ts.cluster_min, ts.cluster_max, tile)
    np.testing.assert_array_equal(np_(got), np.asarray(ref))
    assert np.isfinite(np_(got)).any()


def test_cluster_pick_is_jax_argmin_sequence():
    """Each round's picks: a repeated first-index argmin with the pick set
    to +inf, as the reference's loop; a row with fewer finite entries than
    picks picks cluster 0 again and again."""
    rng = np.random.default_rng(11)
    e = rng.integers(0, 4, (6, 9)).astype(np.float32)
    e[e == 3] = np.inf
    e[0] = np.inf
    e[1] = [np.inf] * 8 + [2.0]
    je, te = jnp.asarray(e), torch.as_tensor(e)
    for _ in range(4):
        jc = jnp.argmin(je, axis=1)
        tc = t_dense._first_argmin(te)
        assert np.array_equal(np.asarray(jc), np_(tc))
        je = je.at[jnp.arange(6), jc].set(jnp.inf)
        te[torch.arange(6), tc] = float("inf")
    assert list(np_(tc)[:2]) == [0, 0]


def _edge_scene():
    """Two flat 2x2-quad planes of 8 triangles each, far apart in x, so
    that the Morton build puts the near one (z = -1, x in [-1, 0]) in
    cluster 0 and the far one (z = 0, x in [1, 3]) in cluster 1."""
    def plane(x0, x1, z):
        xs, ys = np.linspace(x0, x1, 3), np.linspace(-0.5, 0.5, 3)
        tris = []
        for i in range(2):
            for j in range(2):
                p = [[xs[i + a], ys[j + b], z] for a, b in
                     ((0, 0), (1, 0), (1, 1), (0, 1))]
                tris += [[p[0], p[1], p[2]], [p[0], p[2], p[3]]]
        return np.asarray(tris, np.float32)
    v = np.concatenate([plane(-1.0, 0.0, -1.0), plane(1.0, 3.0, 0.0)])
    js = j_dense.build_dense(rc.Triangle.create(jnp.asarray(v)),
                             cluster_size=8, layout="morton")
    ts = rt.build_dense(rt.Triangle.create(torch.as_tensor(v)),
                        cluster_size=8, layout="morton")
    return v, js, ts


def test_exhausted_row_repicks_cluster_zero():
    """A tile with one finite entry (the far plane, cluster 1) tests
    cluster 0 in its other picks. Its rays cross z = -1 at x = 2e-6, just
    outside the near plane, which phase A culls; the epilogue's edge
    slack accepts that triangle, so the hit is the near plane's, as in
    the reference. A pick by topk or by sort would test other culled
    clusters instead and report the far plane."""
    v, js, ts = _edge_scene()
    orig = np_(ts.prims_hot[:, 10])
    assert (orig[:8] < 8).all() and (orig[8:] >= 8).all()  # near = cluster 0
    d = np.float32([1.5, 0.0, 1.0])
    d /= np.linalg.norm(d)
    o = np.float32([2e-6, 0.0, -1.0]) - d * np.float32(1.0 / d[2])
    o, d = np.tile(o, (8, 1)), np.tile(d, (8, 1))
    ref, got = _both(js, ts, o, d, tile=8, select_per_round=4)
    entry = t_ops.phase_a_entry(
        *stage1_rows(*t_ops.pad_rays(torch.as_tensor(o), torch.as_tensor(d),
                                     torch.zeros(8),
                                     torch.full((8,), float("inf")), 8)),
        ts.cluster_min, ts.cluster_max, 8)
    assert not np.isfinite(np_(entry)[0, 0]) and np.isfinite(np_(entry)[0, 1])
    assert np_(got.hit).all() and (np_(got.prim_idx) < 8).all()
    assert np.array_equal(np_(got.prim_idx), np.asarray(ref.prim_idx))
    np.testing.assert_array_equal(np_(got.t), np.asarray(ref.t))


def test_rounds_count_and_group_size_do_not_change_results(heightfield,
                                                           monkeypatch):
    """Tiles are independent: a group of one tile a product gives the
    same bits as one group for all."""
    _, ts = heightfield
    o, d = _grid(32)
    rays = torch_rays(o, d)
    res, rounds = t_dense._dense_query(ts, rays, tile=128,
                                       select_per_round=4, max_rounds=1024)
    assert rounds >= 1
    monkeypatch.setattr(t_dense, "ROUND_GROUP_ELEMS", 1)
    res1, rounds1 = t_dense._dense_query(ts, rays, tile=128,
                                         select_per_round=4, max_rounds=1024)
    assert rounds1 == rounds
    for k in ("hit", "t", "prim_idx", "barycentric"):
        assert torch.equal(getattr(res, k), getattr(res1, k)), k


def test_morton_sort_rays_matches_jax():
    rng = np.random.default_rng(9)
    o = rng.uniform(-2, 2, (777, 3)).astype(np.float32)
    d = rng.normal(size=(777, 3)).astype(np.float32)
    d[::5, 1] = 0.0
    d[1::5, 2] = -0.0
    lo, hi = np.float32([-2, -2, -2]), np.float32([2, 2, 1])
    js, jinv = j_dense.morton_sort_rays(jax_rays(o, d), jnp.asarray(lo),
                                        jnp.asarray(hi))
    ts, tinv = rt.morton_sort_rays(torch_rays(o, d), lo, hi)
    assert np.array_equal(np.asarray(js.o), np_(ts.o))
    assert np.array_equal(np.asarray(js.d), np_(ts.d))
    assert np.array_equal(np.asarray(jinv), np_(tinv))
    assert np.array_equal(np_(ts.o)[np_(tinv)], o)


def test_morton_sorted_query_unpermutes_to_the_plain_query(heightfield):
    js, ts = heightfield
    rng = np.random.default_rng(2)
    o, d = _grid(24)
    perm = rng.permutation(len(o))
    rays = torch_rays(o[perm], d[perm])
    root = np_(ts.root_aabb)
    srt, inv = rt.morton_sort_rays(rays, root[0], root[1])
    got = rt.closest_hit_dense(ts, srt, tile=64).map(lambda a: a[inv])
    want = rt.closest_hit_dense(ts, rays, tile=64)
    check_hits(want, got)
