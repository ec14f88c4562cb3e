"""Parity of the port's renderers with the JAX package, on the CPU: the
example scenes' tables bit for bit; the wavefront renderer
(``render_step``, ``render_staged``), the five ``simple.py`` kernels,
``render_step_mts`` and the debug images against JAX's with the same
random draws (``torch_parity.feed_jax_draws``).

Images are held to the image rule (``raycore_tpu_torch/render/parity.py``):
within atol 3e-5 (the JAX package's own jit-against-staged bound,
tests/test_analysis.py), and a pixel past it only on a path whose hit
first differed at a t tie or within 1e-4 of a triangle edge, at most 1%
of the pixels; every query of both renders is recorded through the
dispatch modules and compared under the engine contract. The JAX
package's jitted entry points are recorded through its staged twins.

The JAX renderers run with per-row norms where their code passes -1 as
``jnp.linalg.norm``'s ``ord`` (ROADMAP Q9, decided in the port's favour;
``test_reference_norm_quirk`` pins the difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import dispatch as j_disp
from raycore_tpu.render import mts_renderer as jM
from raycore_tpu.render import scenes as j_scenes
from raycore_tpu.render import simple as jS
from raycore_tpu.render import wavefront as jw
from raycore_tpu.scene.tlas import TLAS as JTLAS
from raycore_tpu_torch.accel import dispatch as t_disp
from raycore_tpu_torch.collections import multitypeset as tm
from raycore_tpu_torch.render import mts_renderer as tM
from raycore_tpu_torch.render import simple as tS
from raycore_tpu_torch.render import wavefront as tw
from raycore_tpu_torch.render.parity import (Recorder, check_images,
                                             wavefront_order)
from torch_parity import (CPU, JaxDraws, assert_static_equal,
                          feed_jax_draws, jax_row_norms, np_,
                          render_state_from_jax)

ATOL = 3e-5
W, H = 48, 32


@pytest.fixture(scope="module")
def rooms():
    """(JAX room, port room): example_scene in both packages; the port's
    materials, lights and camera converted from JAX's."""
    j = j_scenes.example_scene()
    t_scene = rt.example_scene(device=CPU)[0]
    return j, (t_scene,) + render_state_from_jax(*j[1:])


def test_example_scene_tables_match_jax(rooms):
    j, t = rooms
    assert_static_equal(j[0], t[0])
    own = rt.example_scene(device=CPU)
    for a, b in zip(own[1:], t[1:]):
        for f in a.__dataclass_fields__:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_particle_scene_matches_jax():
    jm, jh, jpos = j_scenes.particle_scene(64, seed=3)
    tmgr, th, tpos = rt.particle_scene(64, seed=3, device=CPU)
    assert np.array_equal(jpos, tpos) and jh.id == th.id
    assert tmgr.n_instances == 64
    assert_static_equal(jm.sync(), tmgr.sync())


def _wave_render(fn_j, fn_t, rooms, monkeypatch, key, cfg_kw, staged_j):
    """Both packages' frames with JAX's draws, each recorded; the JAX
    recording from its staged driver (its jitted frame's queries are
    traced). The reflection query's rows follow the compaction order,
    handed to the recorders by their order hooks."""
    feed_jax_draws(monkeypatch)
    j, t = rooms
    n_lights = t[2].position.shape[0]
    rj, rt_ = Recorder({"any": n_lights}), Recorder({"any": n_lights})
    jcfg, tcfg = jw.RenderConfig(**cfg_kw), tw.RenderConfig(**cfg_kw)
    want = np.asarray(fn_j(*j, key, jcfg))
    with rj.recording(j_disp, [wavefront_order(jw, "_jit_shade_reflect")]):
        staged = np.asarray(staged_j(*j, key, jcfg))
    with rt_.recording_port():
        got = fn_t(*t, JaxDraws(key, "wave"), tcfg)
    assert len(rj.queries) == len(rt_.queries) == 3
    return want, staged, got, rj, rt_


@pytest.mark.parametrize("entry", ["render_step", "render_staged"])
def test_wavefront_matches_jax(rooms, monkeypatch, entry):
    key = jax.random.PRNGKey(3)
    want, staged, got, rj, rt_ = _wave_render(
        getattr(jw, entry), getattr(tw, entry), rooms, monkeypatch, key,
        dict(width=W, height=H, spp=1, tile_size=1024), jw.render_staged)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    out = check_images(want, got, ATOL, rj.queries, rt_.queries)
    assert out["rows"] > 2 * W * H
    # The JAX package's jitted and staged frames agree as its own test
    # requires, so the staged recording stands for the jitted frame.
    np.testing.assert_allclose(want, staged, atol=ATOL)


def test_wavefront_pipelined_and_renderer_match_per_query(rooms):
    """pipelined=True, render_step and WavefrontRenderer (staged or not)
    give the per-query frame bit for bit; gen None is a generator seeded
    0."""
    _, t = rooms
    cfg = tw.RenderConfig(width=24, height=16, spp=2, tile_size=1024)
    g = lambda: torch.Generator(device=CPU).manual_seed(0)
    a = tw.render_staged(*t, g(), cfg)
    assert torch.equal(a, tw.render_staged(*t, g(), cfg, pipelined=True))
    assert torch.equal(a, tw.render_step(*t, g(), cfg))
    for staged in (True, False):
        r = rt.WavefrontRenderer(*t, config=cfg, staged=staged,
                                 pipelined=staged)
        assert torch.equal(a, r.render())
    assert ((a >= 0) & (a <= 1)).all() and a.std() > 0.02


def test_wavefront_roughness_jitter(rooms):
    """tests/test_analysis.py's roughness twin: roughness moves the
    reflections; roughness 0 mirrors without using the draws."""
    _, (scene, mats, lights, cam) = rooms
    cfg = tw.RenderConfig(width=32, height=24, spp=1, tile_size=1024)

    def render(rf, seed):
        rough = mats.roughness.clone()
        rough[4] = rf
        m = tw.Materials(base_color=mats.base_color, metallic=mats.metallic,
                         roughness=rough, ior=mats.ior,
                         transmission=mats.transmission)
        return tw.render_staged(scene, m, lights, cam, torch.Generator(
            device=CPU).manual_seed(seed), cfg).numpy()
    mirror, rough = render(0.0, 7), render(0.8, 7)
    assert np.abs(mirror - rough).max() > 0.02
    assert np.abs(mirror - render(0.0, 8)).mean() < \
        np.abs(rough - render(0.8, 8)).mean() + 1e-6


SIMPLE = {
    "depth": (lambda m: m.depth_kernel, {}),
    "normal": (lambda m: m.normal_kernel, {}),
    "shadow_hard": (lambda m: m.shadow_kernel, {"light_radius": 0.0}),
    "shadow_soft": (lambda m: m.shadow_kernel, {"light_radius": 0.6,
                                                "n_shadow": 4}),
    "multi_light": (lambda m: m.multi_light_kernel, "lights"),
    "reflective": (lambda m: m.reflective_kernel, "lights"),
}


@pytest.mark.parametrize("name", sorted(SIMPLE))
def test_simple_kernels_match_jax(rooms, monkeypatch, name):
    feed_jax_draws(monkeypatch)
    jax_row_norms(monkeypatch)
    (js, jmats, jlights, jcam), (ts, tmats, tlights, tcam) = rooms
    kernel, kw = SIMPLE[name]
    jkw, tkw = ((dict(lights=jlights, materials=jmats),
                 dict(lights=tlights, materials=tmats)) if kw == "lights"
                else (kw, kw))
    key = jax.random.PRNGKey(3)
    spp = 2 if name == "shadow_soft" else 1
    # A multi-light query's rows are the lights of each path (R, L).
    fanout = {"any": tlights.position.shape[0]} if kw == "lights" else None
    rj, rt_ = Recorder(fanout), Recorder(fanout)
    w, h = 32, 24
    with rj.recording(j_disp):
        want = np.asarray(jS.trace(kernel(jS), js, jcam, width=w, height=h,
                                   spp=spp, key=key, tile_size=512, **jkw))
    with rt_.recording(t_disp):
        got = tS.trace(kernel(tS), ts, tcam, width=w, height=h, spp=spp,
                       gen=JaxDraws(key, "simple"), tile_size=512, **tkw)
    assert got.shape == (h, w, 3)
    if name == "shadow_soft":
        # Its shadow query's rows are the light samples of each path
        # (S, R).
        for rec in (rj, rt_):
            q = rec.queries[1]
            q.paths = np.arange(q.paths.size) % (w * h * spp)
    out = check_images(want, got, ATOL, rj.queries, rt_.queries, spp=spp)
    assert out["rows"] >= w * h
    assert got.std() > 0.02


def _mts_scene(pkg):
    """tests/test_mts_renderer.py:build_scene in "jax" or the port."""
    from raycore_tpu.collections.multitypeset import MultiTypeSet as JMTS
    from raycore_tpu.scene import mesh as jmesh
    from raycore_tpu_torch.scene import mesh as tmesh
    if pkg == "jax":
        mtsm, coll, mgr, mesh, dev_kw = jM, JMTS(), JTLAS(), jmesh, {}
    else:
        mtsm, coll, mgr, mesh, dev_kw = (tM, tm.MultiTypeSet(device=CPU),
                                         rt.TLAS(device=CPU), tmesh,
                                         {"device": CPU})
    keys = {
        "matte": coll.push({"kd_r": 0.8, "kd_g": 0.4, "kd_b": 0.2,
                            "sigma": 0.0}, "matte"),
        "mirror": coll.push({"kr_r": 0.9, "kr_g": 0.9, "kr_b": 0.95},
                            "mirror"),
        "plastic": coll.push({"kd_r": 0.2, "kd_g": 0.4, "kd_b": 0.8,
                              "ks_r": 0.4, "ks_g": 0.4, "ks_b": 0.4,
                              "rough": 0.1}, "plastic"),
        "glass": coll.push({"kt_r": 0.9, "kt_g": 0.9, "kt_b": 0.9,
                            "eta": 1.5}, "glass")}

    def with_key(tris, key):
        meta = mtsm.pack_key(int(key[0]), int(key[1]))
        if pkg == "jax":
            return tris.replace(metadata=jnp.full(tris.batch_shape, meta,
                                                  jnp.uint32))
        import dataclasses
        return dataclasses.replace(tris, metadata=torch.full(
            tris.batch_shape, meta, dtype=torch.int64))

    mgr.push(with_key(mesh.plane_mesh(center=(0, 0, 0), u=(4, 0, 0),
                                      v=(0, 4, 0), **dev_kw), keys["matte"]))
    mgr.push(with_key(mesh.sphere_mesh(center=(0, 1, 1), radius=1.0,
                                       n_theta=16, n_phi=32, **dev_kw),
                      keys["mirror"]))
    mgr.push(with_key(mesh.sphere_mesh(center=(1.8, -0.5, 0.6), radius=0.6,
                                       n_theta=16, n_phi=32, **dev_kw),
                      keys["plastic"]))
    mgr.push(with_key(mesh.box_mesh(p_min=(-2.5, -0.5, 0),
                                    p_max=(-1.5, 0.5, 1), **dev_kw),
                      keys["glass"]))
    return mgr.sync(), coll.get_static(), keys


def test_mts_key_packing_and_props_match_jax():
    meta = [tM.pack_key(2, 77), tM.pack_key(0, 0), tM.pack_key(3, 123456)]
    ti, ri = tM.unpack_key(torch.tensor(meta, dtype=torch.int64))
    assert ti.tolist() == [2, 0, 3] and ri.tolist() == [77, 0, 123456]
    js, jset, jkeys = _mts_scene("jax")
    ts, tset, tkeys = _mts_scene("torch")
    assert_static_equal(js, ts)
    names = ("matte", "mirror", "plastic", "glass", "matte")
    ti = np.asarray([0, 1, 2, 3, 9], np.int32)
    ri = np.asarray([int(jkeys[n][1]) for n in names], np.int32)
    want = jM._shade_props(jset, jnp.asarray(ti), jnp.asarray(ri))
    got = tM._shade_props(tset, torch.as_tensor(ti), torch.as_tensor(ri))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np_(g))
    assert np_(got[2]).tolist() == pytest.approx([0.0, 1.0, 0.35, 0.9, 0.9])
    assert len(tM.default_material_set(device=CPU)) == 4


def test_render_step_mts_matches_jax(monkeypatch):
    """test_mts_renderer.py's frame in both packages with JAX's draws. JAX
    runs it as one jit, so no query is recorded: every pixel must lie
    within atol."""
    feed_jax_draws(monkeypatch)
    jax_row_norms(monkeypatch)
    js, jset, _ = _mts_scene("jax")
    ts, tset, _ = _mts_scene("torch")
    jl = jw.PointLights(position=jnp.asarray([[3.0, -3, 5.0]], jnp.float32),
                        intensity=jnp.asarray([[25.0, 25, 24]], jnp.float32))
    jc = jw.Camera.create(position=(1.0, -5.5, 2.2), target=(0, 0.3, 0.8),
                          up=(0, 0, 1), fov_deg=50)
    _, tl, tc = render_state_from_jax(
        jw.Materials.create(np.zeros((1, 3), np.float32)), jl, jc)
    key = jax.random.PRNGKey(0)
    kw = dict(width=W, height=H, spp=1, tile_size=1024)
    want = np.asarray(jM.render_step_mts(js, jset, jl, jc, key,
                                         jw.RenderConfig(**kw)))
    got = tM.render_step_mts(ts, tset, tl, tc, JaxDraws(key, "wave"),
                             tw.RenderConfig(**kw))
    check_images(want, got, ATOL)
    assert got.std() > 0.02


def test_trace_rays_and_ray_plot_match_jax(rooms, tmp_path):
    """trace_rays against JAX's under the engine contract; ray_plot's
    image under the image rule (its geometry pass is one query); the PNG
    and PPM bytes of one image equal."""
    (js, *_), (ts, *_) = rooms
    lo, hi = (np.asarray(v) for v in js.root_aabb)
    c = (lo + hi) / 2
    o = np.tile(c + np.array([0, 0, hi[2] - lo[2] + 1.0]), (3, 1))
    d = np.array([[0, 0, -1.0], [0, 0, 1.0], [0.2, 0.1, -1.0]])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    jr = rc.trace_rays(js, rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d)))
    tr = rt.trace_rays(ts, rt.Ray.create(torch.as_tensor(o),
                                         torch.as_tensor(d)))
    assert np_(tr.hits).tolist() == [True, False, True]
    for f in ("hits", "metadata", "instance_idx"):
        assert np.array_equal(np_(getattr(tr, f)).astype(np.int64),
                              np.asarray(getattr(jr, f)).astype(np.int64)), f
    np.testing.assert_allclose(np_(tr.points), np.asarray(jr.points),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np_(tr.t), np.asarray(jr.t), rtol=2e-5)
    rj, rt_ = Recorder(), Recorder()
    with rj.recording(j_disp):
        want = rc.ray_plot(js, jr, width=80, height=60, show_labels=True)
    with rt_.recording(t_disp):
        got = rt.ray_plot(ts, tr, width=80, height=60, show_labels=True)
    assert got.shape == (60, 80, 3)
    check_images(want, got, ATOL, rj.queries, rt_.queries)
    for writer in ("save_png", "save_ppm"):
        getattr(rc, writer)(want, str(tmp_path / "j.img"))
        getattr(rt, writer)(torch.as_tensor(want), str(tmp_path / "t.img"))
        assert (tmp_path / "j.img").read_bytes() == \
            (tmp_path / "t.img").read_bytes()


def test_scene_preview_matches_jax(rooms, monkeypatch):
    """scene_preview's default camera, light and materials with its own
    seeded-0 draws in each package; both draw only the pixel jitter, so
    the port is fed JAX's PRNGKey(0) jitter."""
    (js, *_), (ts, *_) = rooms
    monkeypatch.setattr(tw, "_pixel_jitter", lambda g, H_, W_, spp, dev:
                        torch.as_tensor(np.array(jax.random.uniform(
                            jax.random.PRNGKey(0), (H_, W_, spp, 2)))))
    monkeypatch.setattr(tw, "_roughness_draws", lambda g, shape, dev:
                        torch.as_tensor(np.array(jax.random.uniform(
                            jax.random.fold_in(jax.random.PRNGKey(0), 1),
                            tuple(shape)))))
    want = np.asarray(rc.scene_preview(js, width=40, height=30))
    got = rt.scene_preview(ts, width=40, height=30)
    check_images(want, got, ATOL)


def test_reference_norm_quirk(rooms, monkeypatch):
    """ROADMAP Q9: the JAX renderers' ``jnp.linalg.norm(v, -1,
    keepdims=True)`` is a matrix norm of the whole batch, shape (1, 1),
    not a norm per row. The reflective kernel's reflected normals are then
    not unit and its image is not the port's; with per-row norms the two
    agree (test_simple_kernels_match_jax)."""
    v = jnp.asarray([[3.0, 4.0, 0.0], [0.0, 0.0, 2.0]])
    assert jnp.linalg.norm(v, -1, keepdims=True).shape == (1, 1)
    assert float(jnp.linalg.norm(v, -1, keepdims=True)[0, 0]) == 2.0
    feed_jax_draws(monkeypatch)
    (js, jmats, jlights, jcam), (ts, tmats, tlights, tcam) = rooms
    key = jax.random.PRNGKey(3)
    kw = dict(width=W, height=H, tile_size=512)
    want = np.asarray(jS.trace(jS.reflective_kernel, js, jcam, key=key,
                               lights=jlights, materials=jmats, **kw))
    got = tS.trace(tS.reflective_kernel, ts, tcam, gen=JaxDraws(key,
                                                                "simple"),
                   lights=tlights, materials=tmats, **kw).numpy()
    assert np.abs(want - got).max() > 0.05


def test_package_exports_renderers():
    """The renderer names the JAX package exports at its top level
    (raycore_tpu/__init__.py) exist at the port's, from the same
    modules."""
    from raycore_tpu_torch.render import debug_viz, scenes
    for mod, names in (
            (tw, ("WavefrontRenderer", "RenderConfig", "Materials",
                  "PointLights", "Camera", "render_step")),
            (scenes, ("example_scene", "particle_scene")),
            (debug_viz, ("RayIntersectionResult", "trace_rays",
                         "scene_preview", "ray_plot", "save_ppm",
                         "save_png"))):
        for name in names:
            assert getattr(rt, name) is getattr(mod, name), name
            assert hasattr(rc, name), name
