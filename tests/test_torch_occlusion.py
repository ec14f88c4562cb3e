"""Parity of the occlusion query (kernel K4's plain version, the worklist
and regrouped any_hit drivers and their dispatch) with the JAX package, on
the CPU.

Sizes are those of tests/test_pallas_dense.py: ``displaced_grid_mesh(n=32)``
at C=64 and ``blobby_mesh(64, 64)`` at C=128, 1024 rays at tile 128. The
JAX side runs its Pallas kernels in interpret mode. Occlusion's contract is
hit, the occluder's prim_idx and its instance_idx: all three must be equal.

On scenes with sub_chunks > 1 the JAX occlusion kernel reads its feature
table as if there were one sub-chunk (``pallas_dense.py:_occl_kernel``
takes columns k * C + j of a sub-chunk-major table), so its occluders are
not intersections and its hit mask differs from the oracle's (ROADMAP
queue 3, F2). There the port is held to the oracle instead, and the test
pins the reference's fault.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.accel.brute import closest_hit_brute as j_brute
from raycore_tpu.ops import pallas_dense as j_pd
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch.accel import dispatch as t_dispatch
from raycore_tpu_torch.ops import dense as t_pd
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import (CPU, jax_rays, jax_tile_padded, np_,
                          pallas_dense_scenes as _scenes, ray_arrays, spy,
                          torch_rays)

TILE = 128


def _shadow_rays(blobby, seed=3, R=1024):
    """Rays of both kinds with some short t_max, so that the result mixes
    free and occluded rays; the blobby rays carry zero direction
    components (the widen path of phase A)."""
    o, d = ray_arrays(R=R, seed=seed, coherent=not blobby, zero_dirs=blobby)
    t_max = np.full(R, np.inf, np.float32)
    t_max[::5] = 1.6
    return o, d, t_max


def _same_occlusion(ref, got):
    for f in ("hit", "prim_idx", "instance_idx"):
        assert np.array_equal(np_(getattr(ref, f)), np_(getattr(got, f))), f
    assert not np_(got.t).any() and not np_(got.barycentric).any()


def _genuine(prims, o, d, t_max, res):
    """Every reported occluder is an intersection within [0, t_max]: scalar
    Möller–Trumbore on the reported prim with slack 1e-4, as
    tests/test_pallas_dense.py:145-163 checks it."""
    m = np_(res.hit)
    prim = np_(res.prim_idx)[m]
    assert (prim >= 0).all()
    v = np_(prims.vertices)[prim].astype(np.float64)
    oo, dd = o[m].astype(np.float64), d[m].astype(np.float64)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    s1 = np.cross(dd, e2)
    r = 1.0 / np.einsum("ij,ij->i", s1, e1)
    dv = oo - v[:, 0]
    u = np.einsum("ij,ij->i", dv, s1) * r
    s2 = np.cross(dv, e1)
    vv = np.einsum("ij,ij->i", dd, s2) * r
    t = np.einsum("ij,ij->i", e2, s2) * r
    eps = 1e-4
    return ((u >= -eps) & (vv >= -eps) & (u + vv <= 1 + eps)
            & (t >= -eps) & (t <= t_max[m] * (1 + eps)))


@pytest.mark.parametrize("blobby", [False, True], ids=["grid", "blobby"])
def test_run_occlusion_plain_matches_jax(blobby):
    """The same worklist through both occlusion sweeps: equal occluders."""
    js, ts = _scenes(blobby)
    o, d, t_max = _shadow_rays(blobby)
    tr = torch_rays(o, d, t_max=torch.as_tensor(t_max))
    tids, cids, phi, tmin, tmax = t_pd._occl_phase_a(
        ts, *t_pd.flat_rays(tr), TILE=TILE)
    got = t_pd.run_occlusion(tids, cids, phi, ts.tri_feats, tmin, tmax,
                             TILE=TILE, C=ts.cluster_size)
    ref = j_pd._run_occlusion(
        jnp.asarray(np_(tids)), jnp.asarray(np_(cids)),
        jax_tile_padded(phi, 0.0, TILE), js.tri_feats,
        jax_tile_padded(tmin, 0.0, TILE, column=True),
        jax_tile_padded(tmax, -np.inf, TILE, column=True),
        TILE=TILE, C=ts.cluster_size, n_blocks=int(tids.shape[0]),
        interpret=True)
    ref = np_(ref)[:phi.shape[0]]
    assert 0 < (ref >= 0).sum() < ref.size
    assert np.array_equal(ref, np_(got))


@pytest.mark.parametrize("blobby", [False, True], ids=["grid", "blobby"])
@pytest.mark.parametrize("engine", ["worklist", "regrouped"])
def test_any_hit_drivers_match_jax_and_oracle(blobby, engine):
    """any_hit_dense_pallas_auto and any_hit_regrouped against their JAX
    counterparts (equal hit, prim_idx and instance_idx, with instances)
    and against the oracle's hit mask with t_min = 0."""
    js, ts = _scenes(blobby, instances=3)
    o, d, t_max = _shadow_rays(blobby)
    # A t_min past the surface on some rays: any_hit forces it to 0.
    t_min = np.where(np.arange(1024) % 7 == 0, 5.0, 0.0).astype(np.float32)
    jr = jax_rays(o, d, t_min=jnp.asarray(t_min), t_max=jnp.asarray(t_max))
    tr = torch_rays(o, d, t_min=torch.as_tensor(t_min),
                    t_max=torch.as_tensor(t_max))
    if engine == "worklist":
        ref = j_pd.any_hit_dense_pallas_auto(js, jr, tile=TILE)
        got = t_pd.any_hit_dense_pallas_auto(ts, tr, tile=TILE)
    else:
        ref = j_pr.any_hit_regrouped(js, jr, tile=TILE)
        got = t_pr.any_hit_regrouped(ts, tr, tile=TILE)
    _same_occlusion(ref, got)
    oracle = j_brute(js.prims, jax_rays(o, d, t_max=jnp.asarray(t_max)))
    assert np.array_equal(np_(oracle.hit), np_(got.hit))
    assert 0 < np_(got.hit).sum() < 1024
    assert (np_(got.instance_idx)[np_(got.hit)] ==
            np_(got.prim_idx)[np_(got.hit)] % 3).all()
    assert _genuine(ts.prims, o, d, t_max, got).all()


def test_sub_chunk_occluders_are_genuine_where_jax_fails():
    """any_hit on a sub_chunks=4 scene: the port's hit mask equals the
    oracle's and every occluder is an intersection. The JAX kernel reads
    the sub-chunk-major table with one sub-chunk's columns (ROADMAP queue
    3, F2): on the same rays its hit mask differs from the oracle's and
    its occluders are not intersections."""
    js, ts = _scenes(blobby=True, SUB=4)
    o, d, t_max = _shadow_rays(True)
    jr = jax_rays(o, d, t_max=jnp.asarray(t_max))
    got = rt.any_hit(ts, torch_rays(o, d, t_max=torch.as_tensor(t_max)))
    oracle = j_brute(js.prims, jr)
    assert np.array_equal(np_(oracle.hit), np_(got.hit))
    assert _genuine(ts.prims, o, d, t_max, got).all()
    ref = rc.any_hit(js, jr)
    assert not np.array_equal(np_(oracle.hit), np_(ref.hit))
    assert not _genuine(js.prims, o, d, t_max, ref).all()


def test_occlusion_t_range():
    """tests/test_pallas_dense.py:166-176 through the port's any_hit: a ray
    whose t_max stops short of the surface is free, and a t_min past the
    surface still reports the occluder (t_min is forced to 0); one-ray
    batches run at TILE 8."""
    _, ts = _scenes()
    o = torch.tensor([[0.1, 0.1, 2.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    for any_hit in (rt.any_hit, t_pr.any_hit_regrouped):
        short = any_hit(ts, rt.Ray.create(o, d, t_max=1.0))
        assert short.hit.shape == (1,) and not bool(short.hit[0])
        assert int(short.prim_idx[0]) == -1
        late = any_hit(ts, rt.Ray.create(o, d, t_min=5.0))
        assert bool(late.hit[0]) and int(late.prim_idx[0]) >= 0


def test_occlusion_instance_idx():
    """tests/test_pallas_dense.py:179-194 with build_dense(instance_of=...)
    in place of bake_dense: a sphere (instance 0) and a second sphere moved
    to x = 3 (instance 1); a third ray misses both."""
    def scene(mesh, build, **kw):
        v, f, _ = mesh.uv_sphere((0.0, 0.0, 0.0), 1.0, 10, 20)
        verts = np.concatenate([v, v + np.float32([3.0, 0.0, 0.0])])
        faces = np.concatenate([f, f + v.shape[0]])
        tris = mesh.build_triangles(verts, faces, **kw)
        n = tris.vertices.shape[0]
        inst = (np.arange(n) >= n // 2).astype(np.int32)
        return build(tris, cluster_size=64, instance_of=inst)

    js = scene(j_mesh, j_dense.build_dense)
    ts = scene(t_mesh, rt.build_dense, device=CPU)
    o = np.float32([[0.0, 0.0, -4.0], [3.0, 0.0, -4.0], [10.0, 0.0, -4.0]])
    d = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), o.shape).copy()
    ref = j_pd.any_hit_dense_pallas_auto(js, jax_rays(o, d), tile=8)
    for any_hit in (rt.any_hit, t_pr.any_hit_regrouped):
        got = any_hit(ts, torch_rays(o, d))
        assert np_(got.hit).tolist() == [True, True, False]
        assert np_(got.instance_idx).tolist() == [0, 1, -1]
    _same_occlusion(ref, rt.any_hit(ts, torch_rays(o, d)))


def test_any_hit_dispatch_routes_on_batch_size(monkeypatch):
    """Batches below REGROUP_MIN_RAYS, and every batch on a sub_chunks > 1
    scene, go to the worklist occlusion (tile 512); others to the
    regrouped occlusion (tile 2048). The threshold is lowered to reach
    both at test size."""
    calls = []
    spy(monkeypatch, t_pd, "any_hit_dense_pallas_auto", calls)
    spy(monkeypatch, t_pr, "any_hit_regrouped", calls)
    _, ts = _scenes()
    _, ts4 = _scenes(SUB=4)
    o, d, t_max = _shadow_rays(False)
    tr = torch_rays(o, d, t_max=torch.as_tensor(t_max))
    worklist = rt.any_hit(ts, tr)
    assert calls == [("any_hit_dense_pallas_auto", dict(tile=512))]
    monkeypatch.setattr(t_dispatch, "REGROUP_MIN_RAYS", 1024)
    calls.clear()
    regrouped = rt.any_hit(ts, tr)
    assert calls == [("any_hit_regrouped", dict(tile=2048))]
    calls.clear()
    rt.any_hit(ts4, tr)
    assert [c[0] for c in calls] == ["any_hit_dense_pallas_auto"]
    # Both engines agree on the occlusion mask; the occluders may differ
    # (first in worklist order against nearest).
    assert torch.equal(worklist.hit, regrouped.hit)
