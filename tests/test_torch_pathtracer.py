"""Parity of the port's path tracer with the JAX package, on the CPU: the
two glue stages on shared NumPy inputs (atol 1e-6); ``trace_paths`` with
compaction on and off, ``trace_paths_staged`` and the textured albedo
against JAX's on the room, and the staged frame on a DenseScene
(``displaced_grid_mesh(n=24)``, C=64), each with JAX's draws for the same
key; ``trace_paths_staged_batch`` at F=2 against solo frames (atol
1e-6); pipelined against per-query; an empty batch raises.

Images are held to the image rule (``raycore_tpu_torch/render/parity.py``)
at atol 1e-5 with both renders' queries recorded: JAX's staged driver
stands for its jitted ``trace_paths``. The JAX renderers run with per-row
norms (ROADMAP Q9, ``torch_parity.jax_row_norms``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import dispatch as j_disp
from raycore_tpu.accel.dense import build_dense as j_build_dense
from raycore_tpu.collections.multitypeset import MultiTypeSet as JMTS
from raycore_tpu.render import pathtracer as jp
from raycore_tpu.render import scenes as j_scenes
from raycore_tpu.render import wavefront as jw
from raycore_tpu_torch import convert
from raycore_tpu_torch.render import pathtracer as tp
from raycore_tpu_torch.render.parity import (Recorder, check_images,
                                             pathtracer_order)
from torch_parity import (CPU, JaxDraws, feed_jax_draws, jax_row_norms,
                          np_, render_state_from_jax)

ATOL = 1e-5


@pytest.fixture(scope="module")
def rooms():
    j = j_scenes.example_scene()
    return j, (rt.example_scene(device=CPU)[0],) + render_state_from_jax(
        *j[1:])


@pytest.fixture(scope="module")
def grids():
    """tests/test_pathtracer.py:test_staged_dense_scene's frame in both
    packages."""
    jds = j_build_dense(rc.displaced_grid_mesh(n=24), cluster_size=64)
    tds = rt.build_dense(rt.displaced_grid_mesh(n=24, device=CPU),
                         cluster_size=64)
    jm = jw.Materials.create(base_color=np.full((2000, 3), 0.6, np.float32))
    jl = jw.PointLights(position=jnp.asarray([[0.0, 0, 5.0]]),
                        intensity=jnp.asarray([[20.0, 20, 20]]))
    jc = jw.Camera.create(position=(0, -3, 2.5), target=(0, 0, 0))
    return (jds, jm, jl, jc), (tds,) + render_state_from_jax(jm, jl, jc)


def _frames(monkeypatch, j, t, key, cfg_kw, jfn="trace_paths_staged",
            tfn="trace_paths_staged", **kw):
    """JAX's frame (``jfn``), JAX's staged frame recorded, and the port's
    frame (``tfn``) recorded, with the same draws."""
    feed_jax_draws(monkeypatch)
    jax_row_norms(monkeypatch)
    rj, rt_ = Recorder(), Recorder()
    jcfg, tcfg = jp.PTConfig(**cfg_kw), tp.PTConfig(**cfg_kw)
    want = np.asarray(getattr(jp, jfn)(*j, key, jcfg, **kw))
    with rj.recording(j_disp, [pathtracer_order(jp)]):
        staged = np.asarray(jp.trace_paths_staged(*j, key, jcfg, **kw))
    with rt_.recording_port():
        got = getattr(tp, tfn)(*t, JaxDraws(key, "path"), tcfg,
                               **{k: _port(v) for k, v in kw.items()})
    assert len(rj.queries) == len(rt_.queries) == 2 * cfg_kw["bounces"]
    return want, staged, got, rj, rt_


def _port(v):
    """A JAX TexturePool or tex_refs array as the port's."""
    if hasattr(v, "records"):
        return convert.texture_pool_from_numpy(np.asarray(v.data),
                                               np.asarray(v.records),
                                               device=CPU)
    return torch.as_tensor(np.array(v))


PT = dict(width=32, height=24, spp=1, bounces=3, tile_size=256)


@pytest.mark.parametrize("compact", [True, False])
def test_trace_paths_matches_jax(rooms, monkeypatch, compact):
    j, t = rooms
    cfg = dict(PT, compact=compact)
    want, staged, got, rj, rt_ = _frames(
        monkeypatch, j, t, jax.random.PRNGKey(5), cfg, jfn="trace_paths",
        tfn="trace_paths")
    assert got.shape == (24, 32, 3)
    out = check_images(want, got, ATOL, rj.queries, rt_.queries)
    assert out["rows"] > 2 * 32 * 24
    np.testing.assert_allclose(want, staged, atol=ATOL)


def test_trace_paths_staged_matches_jax(rooms, monkeypatch):
    j, t = rooms
    want, _, got, rj, rt_ = _frames(monkeypatch, j, t,
                                    jax.random.PRNGKey(7), PT)
    check_images(want, got, ATOL, rj.queries, rt_.queries)
    assert got.std() > 0.02 and got.mean() > 0.01


def test_textured_albedo_matches_jax(rooms, monkeypatch):
    """tests/test_pathtracer.py:test_textured_albedo's twin: a checker on
    the floor through the texture pool."""
    j, t = rooms
    s = JMTS()
    checker = np.indices((8, 8)).sum(0) % 2
    h = s.store_texture(np.stack([checker, 1 - checker,
                                  np.ones_like(checker)], -1)
                        .astype(np.float32))
    pool = s.get_static().textures
    tex_refs = jnp.full((6,), -1, jnp.int32).at[0].set(h)
    cfg = dict(width=48, height=32, spp=1, bounces=1, tile_size=512)
    want, _, got, rj, rt_ = _frames(monkeypatch, j, t, jax.random.PRNGKey(3),
                                    cfg, pool=pool, tex_refs=tex_refs)
    check_images(want, got, ATOL, rj.queries, rt_.queries)
    plain = tp.trace_paths_staged(*t, JaxDraws(jax.random.PRNGKey(3),
                                               "path"), tp.PTConfig(**cfg))
    assert (got - plain).abs().max() > 0.02


def test_staged_dense_scene_matches_jax(grids, monkeypatch):
    """tests/test_pathtracer.py:test_staged_dense_scene's frame: the tile
    worklist (K1, K3, K4 on the card) in both packages."""
    j, t = grids
    cfg = dict(width=32, height=24, spp=1, bounces=2, tile_size=256)
    want, _, got, rj, rt_ = _frames(monkeypatch, j, t, jax.random.PRNGKey(0),
                                    cfg)
    check_images(want, got, ATOL, rj.queries, rt_.queries)
    assert got.mean() > 0.005


def test_staged_batch_matches_solo_frames(rooms):
    """F=2 frames in one batch sample the same paths as their solo frames
    (atol 1e-6, JAX's bound); pipelined gives the per-query batch; an
    empty batch raises."""
    _, t = rooms
    cfg = tp.PTConfig(width=16, height=12, spp=2, bounces=2, tile_size=256)
    g = lambda s: torch.Generator(device=CPU).manual_seed(s)
    solo = torch.stack([tp.trace_paths_staged(*t, g(s), cfg)
                        for s in (5, 11)])
    batch = tp.trace_paths_staged_batch(*t, [g(5), g(11)], cfg)
    assert batch.shape == (2, 12, 16, 3)
    torch.testing.assert_close(batch, solo, atol=1e-6, rtol=0)
    piped = tp.trace_paths_staged_batch(*t, [g(5), g(11)], cfg,
                                        pipelined=True)
    assert torch.equal(piped, batch)
    assert torch.equal(tp.trace_paths_staged(*t, g(5), cfg, pipelined=True),
                       solo[0])
    with pytest.raises(ValueError):
        tp.trace_paths_staged_batch(*t, [], cfg)
    # gen None is a generator seeded 0; trace_paths with compaction on
    # and off gives the same image.
    assert torch.equal(tp.trace_paths_staged(*t, None, cfg),
                       tp.trace_paths_staged(*t, g(0), cfg))
    on = tp.trace_paths(*t, g(3), cfg)
    off = tp.trace_paths(*t, g(3), tp.PTConfig(**{
        **cfg.__dict__, "compact": False}))
    torch.testing.assert_close(on, off, atol=1e-6, rtol=0)


def _stage_inputs(rng, R=301, M=3, L=2):
    """Shared NumPy inputs of the two stages (a third of the lanes dead,
    some rays missing, metadata past the table)."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    bary = rng.dirichlet([1, 1, 1], R).astype(np.float32)
    n = f(R, 3, 3)
    n[:5] = 0.0                                       # vanishing normals
    return dict(
        res_hit=rng.uniform(size=R) < 0.8, res_bary=bary,
        res_verts=f(R, 3, 3), res_norms=n,
        res_uv=rng.uniform(size=(R, 3, 2)).astype(np.float32),
        res_meta=rng.integers(0, M + 2, R).astype(np.uint32),
        d=f(R, 3), alive=rng.uniform(size=R) < 0.67,
        base_color=rng.uniform(size=(M, 3)).astype(np.float32),
        metallic=np.array([0.0, 0.9, 0.5], np.float32),
        roughness=np.array([0.8, 0.1, 0.3], np.float32),
        position=f(L, 3) * 3, intensity=np.abs(f(L, 3)) * 10,
        u_l=rng.integers(0, L, R), u_b=rng.uniform(size=(R, 3))
        .astype(np.float32), u_r=f(R, 3),
        o=f(R, 3), throughput=rng.uniform(size=(R, 3)).astype(np.float32),
        radiance=rng.uniform(size=(R, 3)).astype(np.float32),
        order_acc=rng.permutation(R), occ=rng.uniform(size=R) < 0.3,
        root=np.array([[-2, -2, -1], [2, 2, 1]], np.float32))


@pytest.mark.parametrize("last", [False, True])
def test_stages_match_jax(monkeypatch, last):
    """_pt_prep_nee and _pt_shade_and_sample on the same inputs, atol
    1e-6; the compaction order equal (ties among dead lanes keep their
    order: the sort is stable in both)."""
    jax_row_norms(monkeypatch)
    x = _stage_inputs(np.random.default_rng(1))
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.as_tensor(v) for k, v in x.items()}
    jm = jw.Materials.create(J["base_color"], J["metallic"], J["roughness"])
    tm, tl, _ = render_state_from_jax(
        jm, jw.PointLights(J["position"], J["intensity"]),
        jw.Camera.create((0, 0, 0), (0, 0, 1)))
    jl = jw.PointLights(J["position"], J["intensity"])
    args = ("res_hit", "res_bary", "res_verts", "res_norms", "res_uv",
            "res_meta", "d", "alive")
    jo = jp._pt_prep_nee(*(J[k] for k in args), jm, jl, J["u_l"], 1e-3,
                         None, None)
    to = tp._pt_prep_nee(*(T[k] for k in args), tm, tl, T["u_l"], 1e-3,
                         None, None)
    for w, g in zip(jo, to):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=1e-6,
                                   rtol=0)
    bg = (0.03, 0.04, 0.07)
    rest = ("o", "d", "throughput", "radiance", "alive", "order_acc")
    jo2 = jp._pt_shade_and_sample(
        jo[0], J["res_hit"], *jo[1:7], J["occ"], *(J[k] for k in rest), jm,
        jl, J["u_l"], J["u_b"], J["u_r"], J["root"], jnp.asarray(bg), 1e-3,
        n_lights=2, last=last)
    to2 = tp._pt_shade_and_sample(
        to[0], T["res_hit"], *to[1:7], T["occ"], *(T[k] for k in rest), tm,
        tl, T["u_l"], T["u_b"], T["u_r"], T["root"], torch.tensor(bg), 1e-3,
        n_lights=2, last=last)
    for w, g in zip(jo2, to2):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=1e-6,
                                   rtol=0)
    assert np.array_equal(np_(to2[5]), np.asarray(jo2[5]))


def test_package_exports_pathtracer():
    assert rt.PTConfig is tp.PTConfig and rt.trace_paths is tp.trace_paths
