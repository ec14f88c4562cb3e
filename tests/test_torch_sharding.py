"""Ray sharding on ``torch.distributed`` (``parallel/sharding.py``) against
the JAX package's ``raycore_tpu.parallel.sharding`` on the conftest's
8-device CPU mesh and against the port's single-process queries: twins of
``tests/test_sharding_io.py:34-128``.

The port's ranks are 4 gloo processes on the CPU, spawned once for the
module (``parallel/dryrun.py:run_cases``, joined through a file under
pytest's tmp_path, so no port is taken); each test asserts on what they
returned. Every rank must return the same full result. Sharded results
must equal the single-process query (the rays and the scene are the
same, each row is queried alone), and match JAX's under the engine
contract.
"""
import jax
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel.dense import build_dense as j_build
from raycore_tpu.parallel import sharding as j_sh
from raycore_tpu.scene.tlas import TLAS as JTLAS
from raycore_tpu_torch.parallel import dryrun
from raycore_tpu_torch.parallel import sharding as t_sh
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import CPU, check_hits, jax_rays, np_, torch_rays

RANKS = 4
DENSE = dict(dense="displaced_grid_mesh", kw=dict(n=24, extent=2.0,
                                                  amplitude=0.3),
             cluster_size=64)
ROUNDS = dict(dense="displaced_grid_mesh", kw=dict(n=16, extent=2.0,
                                                   amplitude=0.3),
              cluster_size=32)


def _grid_rays(n):
    """tests/test_sharding_io.py:grid_rays as NumPy."""
    xs = np.linspace(-1.5, 4.5, n, dtype=np.float32)
    X, Y = np.meshgrid(xs, np.linspace(-1.5, 1.5, n, dtype=np.float32),
                       indexing="ij")
    o = np.stack([X, Y, np.full_like(X, -4.0)], -1).reshape(-1, 3)
    return o, np.broadcast_to(np.float32([0, 0, 1]), o.shape).copy()


def _down_grid(n, z=2.0):
    xs = np.linspace(-0.9, 0.9, n, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    o = np.stack([X, Y, np.full_like(X, z)], -1).reshape(-1, 3)
    return o, np.broadcast_to(np.float32([0, 0, -1]), o.shape).copy()


RAYS = {"grid32": _grid_rays(32), "grid9": _grid_rays(9),
        "down40": _down_grid(40), "down16": _down_grid(16)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's outputs, {case: arrays}, from one spawn of RANKS gloo
    ranks."""
    work = tmp_path_factory.mktemp("ranks")
    for name, (o, d) in RAYS.items():
        np.savez(work / f"{name}.npz", o=o, d=d)
    tlas = {"small_tlas": True}
    n_bins = int(dryrun.small_scene(CPU).prims.metadata.shape[0])
    cases = [
        dict(name="closest_hit", fn="closest_hit", scene=tlas,
             rays=str(work / "grid32.npz"), kwargs=dict(tile_size=128)),
        dict(name="padding", fn="closest_hit", scene=tlas,
             rays=str(work / "grid9.npz"), kwargs=dict(tile_size=64)),
        dict(name="illumination", fn="illumination", scene=tlas,
             rays=str(work / "grid32.npz"),
             kwargs=dict(n_bins=n_bins, tile_size=128)),
        dict(name="dense", fn="closest_hit_dense", scene=DENSE,
             rays=str(work / "down40.npz"),
             kwargs=dict(tile=128, subgroup=8, spb=16), reps=2),
        dict(name="rounds", fn="rounds", scene=ROUNDS,
             rays=str(work / "down16.npz"), kwargs=dict(tile=32))]
    outs = dryrun.run_cases(cases, RANKS, "cpu", str(work))
    for case in cases:       # every rank holds the same full result
        first = outs[0][case["name"]]
        for out in outs[1:]:
            for k, v in first.items():
                if isinstance(v, np.ndarray):
                    assert np.array_equal(v, out[case["name"]][k]), k
    return outs[0]


@pytest.fixture(scope="module")
def jax_mesh():
    return j_sh.make_mesh(jax.devices()[:8])


def _jax_tlas():
    mgr = JTLAS()
    mgr.push(rc.sphere_mesh(radius=1.0, n_theta=12, n_phi=24), None)
    tr = np.eye(3, 4, dtype=np.float32)
    tr[0, 3] = 3.0
    mgr.push(rc.box_mesh(), tr)
    return mgr.sync()


def test_mesh_has_8_devices():
    assert len(jax.devices()) >= 8


def test_distributed_matches_single_and_jax(ranks, jax_mesh):
    out = ranks["closest_hit"]
    o, d = RAYS["grid32"]
    n = len(o)
    single = rt.closest_hit(dryrun.small_scene(CPU), torch_rays(o, d),
                            tile_size=128)
    for k in ("hit", "t", "prim_idx", "instance_idx"):
        assert np.array_equal(out[k][:n], np_(getattr(single, k))), k
    ref = j_sh.distributed_closest_hit(_jax_tlas(), jax_rays(o, d), jax_mesh,
                                       tile_size=128)
    h = np.asarray(ref.hit)[:n]
    assert np.array_equal(out["hit"][:n], h)
    np.testing.assert_allclose(out["t"][:n][h], np.asarray(ref.t)[:n][h],
                               rtol=1e-5)


def test_distributed_dense_regroup_matches_brute_and_jax(ranks, jax_mesh):
    """The JAX test's oracle is the JAX package's eager brute force, which
    hits every ray here."""
    out = ranks["dense"]
    o, d = RAYS["down40"]
    tris = t_mesh.displaced_grid_mesh(**DENSE["kw"], device=CPU)
    ds = rt.build_dense(tris, cluster_size=64)
    jscene = j_build(rc.displaced_grid_mesh(**DENSE["kw"]), cluster_size=64)
    rb = rc.closest_hit_brute(jscene.prims, jax_rays(o, d))
    m = np.asarray(rb.hit)
    assert m.all() and np.array_equal(out["hit"], m)
    np.testing.assert_allclose(out["t"][m], np.asarray(rb.t)[m], rtol=1e-4,
                               atol=1e-4)
    single = rt.closest_hit_regrouped(ds, torch_rays(o, d), tile=128,
                                      subgroup=8, spb=16, passes=1)
    for k in ("hit", "t", "prim_idx", "barycentric"):
        assert np.array_equal(out[k], np_(getattr(single, k))), k
    ref = j_sh.distributed_closest_hit_dense(jscene, jax_rays(o, d),
                                             jax_mesh, tile=128, subgroup=8,
                                             spb=16)
    check_hits(ref, single)
    assert len(out["ms"]) == 2       # the second call runs as the first


def test_distributed_rounds_engine_matches_brute(ranks):
    """The replicated scene and sharded rays through the rounds engine
    (tests/test_sharding_io.py:test_distributed_dense_rounds_under_jit)."""
    out = ranks["rounds"]
    o, d = RAYS["down16"]
    ds = rt.build_dense(t_mesh.displaced_grid_mesh(**ROUNDS["kw"],
                                                   device=CPU),
                        cluster_size=32)
    rb = rt.closest_hit_brute(ds.prims, torch_rays(o, d))
    m = np_(rb.hit)
    np.testing.assert_allclose(out["t"][:len(o)][m], np_(rb.t)[m],
                               rtol=1e-4, atol=1e-4)
    single = rt.closest_hit_dense(ds, torch_rays(o, d), tile=32)
    assert np.array_equal(out["t"][:len(o)], np_(single.t))


def test_distributed_illumination_allreduce(ranks, jax_mesh):
    out = ranks["illumination"]
    o, d = RAYS["grid32"]
    scene = dryrun.small_scene(CPU)
    res = rt.closest_hit(scene, torch_rays(o, d), tile_size=128)
    n_bins = out["hist"].shape[0]
    idx = res.triangle.metadata.to(torch.int32).clamp(0, n_bins - 1).long()
    single = torch.zeros(n_bins).index_add_(0, idx, res.hit.float())
    assert np.array_equal(out["hist"], np_(single))
    assert float(out["hist"].sum()) == float(res.hit.sum())
    _, jhist = j_sh.distributed_illumination(_jax_tlas(), jax_rays(o, d),
                                             jax_mesh, n_bins=n_bins,
                                             tile_size=128)
    assert np.array_equal(np.asarray(jhist), out["hist"])


def test_ray_padding_to_mesh(ranks):
    out = ranks["padding"]
    assert out["hit"].shape[0] % RANKS == 0 and out["hit"].shape[0] >= 81
    assert not out["hit"][81:].any()
    o, d = RAYS["grid9"]
    single = rt.closest_hit(dryrun.small_scene(CPU), torch_rays(o, d),
                            tile_size=64)
    assert np.array_equal(out["t"][:81], np_(single.t))


def test_pad_rays_to_matches_jax():
    o, d = RAYS["grid9"]
    ref = j_sh.pad_rays_to(jax_rays(o, d, time=0.5), 8)
    got = t_sh.pad_rays_to(torch_rays(o, d, time=0.5), 8)
    for k in ("o", "d", "t_min", "t_max", "time"):
        assert np.array_equal(np.asarray(getattr(ref, k)),
                              np_(getattr(got, k))), k


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="not initialized"):
        t_sh.make_mesh(device=CPU)


def test_dense_sharding_rejects_sub_chunks():
    ds = rt.build_dense(t_mesh.displaced_grid_mesh(n=8, device=CPU),
                        cluster_size=32, sub_chunks=4)
    o, d = RAYS["down16"]
    with pytest.raises(ValueError, match="sub_chunks=1"):
        t_sh.distributed_closest_hit_dense(ds, torch_rays(o, d), None)


def test_dryrun_multichip(tmp_path):
    """The torch twin of __graft_entry__.py:dryrun_multichip in 4 gloo
    ranks."""
    dryrun.dryrun_multichip(RANKS, "cpu", str(tmp_path))
