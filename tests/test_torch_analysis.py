"""Parity of the port's analyses with the JAX package, on the CPU: twins
of tests/test_analysis.py's ray-grid, centroid, illumination, view-factor
and collision tests. The grid origins within rtol 2e-6, the hit masks and
illumination counts equal, the centroid within 1e-5; view factors with
the JAX package's draws for the same key equal count for count; the
collision pairs equal, and on particle_scene's manager as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.analysis import collision as jc
from raycore_tpu.analysis import kernels as jk
from raycore_tpu.render import scenes as j_scenes
from raycore_tpu.scene.tlas import TLAS as JTLAS
from raycore_tpu_torch.analysis import collision as tc
from raycore_tpu_torch.analysis import kernels as tk
from torch_parity import (CPU, JaxDraws, Twin, assert_static_equal,
                          feed_jax_draws, np_, sphere_of, translation)

DOWN = (0.0, 0.0, -1.0)


@pytest.fixture(scope="module")
def spheres():
    """tests/test_analysis.py:sphere_scene in both packages."""
    j = JTLAS()
    j.push(rc.sphere_mesh(radius=1.0, n_theta=16, n_phi=32), None)
    t = rt.TLAS(device=CPU)
    t.push(rt.sphere_mesh(radius=1.0, n_theta=16, n_phi=32, device=CPU))
    js, ts = j.sync(), t.sync()
    assert_static_equal(js, ts)
    return js, ts


@pytest.mark.parametrize("direction", [DOWN, (0.3, -0.5, 0.8),
                                       (0.95, 0.1, 0.0)])
def test_generate_ray_grid_matches_jax(spheres, direction):
    js, ts = spheres
    want = np.asarray(jk.generate_ray_grid(js, jnp.asarray(direction), 16))
    got = tk.generate_ray_grid(ts, torch.tensor(direction), 16)
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(np_(got), want, rtol=2e-6, atol=2e-6)
    if direction == DOWN:
        assert np_(got)[..., 2].min() > 1.0


def test_hits_from_grid_and_centroid_match_jax(spheres):
    js, ts = spheres
    jh, jcen = jk.get_centroid(js, jnp.asarray(DOWN), grid_size=32,
                               tile_size=1024)
    th, tcen = tk.get_centroid(ts, DOWN, grid_size=32, tile_size=1024)
    h = np_(th.hit)
    assert np.array_equal(h, np.asarray(jh.hit))
    assert 0.3 < h.mean() < 0.85
    assert np.array_equal(np_(th.metadata).astype(np.int64),
                          np.asarray(jh.metadata).astype(np.int64))
    np.testing.assert_allclose(np_(th.point), np.asarray(jh.point),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np_(tcen), np.asarray(jcen), atol=1e-5)
    c = np_(tcen)
    assert abs(c[0]) < 0.1 and abs(c[1]) < 0.1 and c[2] > 0.3


def test_illumination_counts_match_jax(spheres):
    js, ts = spheres
    n_bins = int(ts.prims.metadata.shape[0])
    want = np.asarray(jk.get_illumination(js, jnp.asarray(DOWN),
                                          grid_size=64, n_bins=n_bins,
                                          tile_size=1024))
    got = tk.get_illumination(ts, DOWN, grid_size=64, n_bins=n_bins,
                              tile_size=1024)
    assert got.dtype == torch.float32
    assert np.array_equal(np_(got), want)
    hits = tk.hits_from_grid(ts, DOWN, grid_size=64, tile_size=1024)
    assert float(got.sum()) == float(hits.hit.sum()) > 0


def _quads(pkg):
    """Two parallel unit quads facing each other, metadata 0-1 and 2-3."""
    if pkg is rc:
        a = rc.plane_mesh(center=(0, 0, 0), u=(1, 0, 0), v=(0, 1, 0))
        b = rc.plane_mesh(center=(0, 0, 1.0), u=(1, 0, 0), v=(0, 1, 0))
        a = a.replace(metadata=jnp.asarray([0, 1], jnp.uint32))
        b = b.replace(metadata=jnp.asarray([2, 3], jnp.uint32))
        mgr = JTLAS()
        tris = jax.tree_util.tree_map(lambda x, y: jnp.concatenate([x, y]),
                                      a, b)
    else:
        a = rt.plane_mesh(center=(0, 0, 0), u=(1, 0, 0), v=(0, 1, 0),
                          metadata=[0, 1], device=CPU)
        b = rt.plane_mesh(center=(0, 0, 1.0), u=(1, 0, 0), v=(0, 1, 0),
                          metadata=[2, 3], device=CPU)
        mgr = rt.TLAS(device=CPU)
        tris = rt.Triangle(**{f: torch.cat([getattr(a, f), getattr(b, f)])
                              for f in a.__dataclass_fields__})
    mgr.push(a, None)
    mgr.push(b, None)
    return mgr.sync(), tris


def test_view_factors_match_jax(monkeypatch):
    """With the JAX package's draws (split per batch) the count matrices
    are equal; the reference test's checks hold."""
    feed_jax_draws(monkeypatch)
    (js, jtris), (ts, ttris) = _quads(rc), _quads(rt)
    assert_static_equal(js, ts)
    key = jax.random.PRNGKey(0)
    kw = dict(rays_per_triangle=512, n_bins=4, ray_batch=128,
              tile_size=1024)
    want = np.asarray(jk.view_factors(js, jtris, key, **kw))
    got = np_(tk.view_factors(ts, ttris, JaxDraws(key, "batches"), **kw))
    assert got.shape == (4, 4)
    assert np.array_equal(got, want)
    assert np.all(np.diag(got) == 0) and got[:2, 2:].sum() > 0
    assert got.max() <= 512


def test_view_factors_draw_from_the_generator():
    (ts, ttris) = _quads(rt)
    kw = dict(rays_per_triangle=256, n_bins=4, ray_batch=128)
    g = lambda: torch.Generator(device=CPU).manual_seed(2)
    a = tk.view_factors(ts, ttris, g(), **kw)
    assert torch.equal(a, tk.view_factors(ts, ttris, g(), **kw))
    assert torch.equal(tk.view_factors(ts, ttris, None, **kw),
                       tk.view_factors(ts, ttris, torch.Generator(
                           device=CPU).manual_seed(0), **kw))
    # Both quads face +z: A's rays reach B, B's go away from A.
    assert a[:2, 2:].sum() > 0 and a[2:, :2].sum() == 0


def _pairs(res):
    return {tuple(p) for p in np_(res.contacts)[:res.num_contacts]
            .tolist()}


def test_collide_instances_pairs_match_jax():
    tw = Twin()
    for x in (0.0, 1.5, 3.0, 10.0):
        tw.push(lambda m: sphere_of(m, 1.0, 8, 16), translation(x))
    js, ts = tw.sync()
    want, got = jc.collide_instances(js), tc.collide_instances(ts)
    assert got.contacts.dtype == torch.int32
    assert got.num_contacts == want.num_contacts == 2
    assert np.array_equal(np_(got.contacts), np.asarray(want.contacts))
    assert _pairs(got) == {(0, 1), (1, 2)}


def test_collide_instances_none():
    tw = Twin()
    for k in range(3):
        tw.push(lambda m: sphere_of(m, 0.5, 8, 16), translation(5.0 * k))
    js, ts = tw.sync()
    res = tc.collide_instances(ts)
    assert res.num_contacts == jc.collide_instances(js).num_contacts == 0
    assert res.contacts.shape == (0, 2)


def test_collide_instances_any_matches_jax():
    tw = Twin()
    h1 = tw.push(lambda m: sphere_of(m, 1.0, 8, 16), None)
    h2 = tw.push(lambda m: sphere_of(m, 1.0, 8, 16), translation(1.0))
    h3 = tw.push(lambda m: sphere_of(m, 1.0, 8, 16), translation(9.0))
    for a, b, want in ((h1, h2, True), (h1, h3, False), (h2, h3, False)):
        assert tc.collide_instances_any(tw.t, a, b) is want
        assert jc.collide_instances_any(tw.j, a, b) is want


def test_collide_particles_match_jax():
    """particle_scene()'s overlapping pairs (1,024 particles; 256 have
    none at seed 0), as phase 22 runs them on the card: equal to JAX's,
    in the same order."""
    jm, _, _ = j_scenes.particle_scene()
    tm, _, _ = rt.particle_scene(device=CPU)
    js, ts = jm.sync(), tm.sync()
    assert_static_equal(js, ts)
    want, got = jc.collide_instances(js), tc.collide_instances(ts)
    assert got.num_contacts == want.num_contacts > 0
    assert np.array_equal(np_(got.contacts), np.asarray(want.contacts))


def test_package_exports_analysis():
    for name in ("RayHits", "generate_ray_grid", "hits_from_grid",
                 "get_centroid", "get_illumination", "view_factors",
                 "CollisionResult", "collide_instances",
                 "collide_instances_any"):
        assert getattr(rt, name) is getattr(tk, name, None) or \
            getattr(rt, name) is getattr(tc, name)
