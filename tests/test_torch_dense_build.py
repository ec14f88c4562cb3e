"""Parity of the port's dense build and exact finalize with the JAX package,
on the CPU.

Every table of the build (feature blocks, cluster and sub-chunk bounds,
hot rows, root AABB) must be bit-for-bit equal, for both layouts: the
build evaluates cross products and dots as the same fused multiply-add
chains the reference's compiler emits, so even row 9 of ``tri_feats``
(``-dot(v0, n)``) matches exactly. The one allowance: the reference's
compiled CPU code flushes denormal results to zero, so denormals compare
as signed zeros. The per-query code (ray features, the finalize) runs in
plain float32 and is held to the tolerances stated in its tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.accel import lbvh as j_lbvh
from raycore_tpu.ops.pallas_regroup import closest_hit_regrouped as j_regroup
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch import convert
from raycore_tpu_torch.accel import dense as t_dense
from raycore_tpu_torch.accel import lbvh as t_lbvh
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import (CPU, assert_ray_features_close, jax_rays,
                          jax_scene_arrays, np_, ray_arrays, torch_rays)

TABLES = ("tri_feats", "cluster_min", "cluster_max", "sub_bounds",
          "prims_hot", "root_aabb")


def _meshes(kind):
    if kind == "grid":
        return (j_mesh.displaced_grid_mesh(n=40),
                t_mesh.displaced_grid_mesh(n=40, device=CPU))
    return (j_mesh.blobby_mesh(n_theta=64, n_phi=64),
            t_mesh.blobby_mesh(n_theta=64, n_phi=64, device=CPU))


def _flush(a):
    """Denormals to signed zero: the reference's compiled CPU code flushes
    denormal results to zero, the port keeps IEEE denormals."""
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, a * 0, a)


def _same(a, b, what):
    """Bit-for-bit equality (float32 compared as bits after _flush)."""
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, what
    if a.dtype == np.float32:
        a, b = _flush(a).view(np.int32), _flush(b).view(np.int32)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("kind,C,layout,sub", [
    ("grid", 128, "tiles", 1), ("grid", 64, "morton", 1),
    ("grid", 128, "tiles", 4), ("blobby", 128, "tiles", 1),
    ("blobby", 64, "morton", 2)])
def test_build_tables_match(kind, C, layout, sub):
    jm, tm = _meshes(kind)
    js = j_dense.build_dense(jm, cluster_size=C, layout=layout,
                             sub_chunks=sub)
    ts = rt.build_dense(tm, cluster_size=C, layout=layout, sub_chunks=sub)
    for f in TABLES:
        _same(getattr(js, f), getattr(ts, f), f)
    assert ts.payload_mask == js.payload_mask
    assert (ts.n_prims, ts.cluster_size, ts.sub_chunks, ts.n_clusters) == \
        (js.n_prims, js.cluster_size, js.sub_chunks, js.n_clusters)
    # Padding stays out of the root box but inside the tail cluster bounds.
    assert float(ts.root_aabb.abs().max()) < 10.0


def test_payload_mask_with_cold_fields_matches():
    """Smooth normals and uvs: not flat-shaded, cold fields gathered."""
    v, f, n = j_mesh.uv_sphere((0, 0, 0), 1.0, 12, 16)
    uvs = np.stack([v[:, 0], v[:, 2]], -1).astype(np.float32)
    jm = j_mesh.build_triangles(v, f, normals=n, uvs=uvs)
    tm = t_mesh.build_triangles(v, f, normals=n, uvs=uvs, device=CPU)
    js = j_dense.build_dense(jm, cluster_size=64)
    ts = rt.build_dense(tm, cluster_size=64)
    assert ts.payload_mask == js.payload_mask == 0b101
    idx = np.array([0, 5, 17, 200, 511, 3], np.int32)
    hit = np.array([True, True, False, True, True, False])
    jt, jo = j_dense.gather_hit_payload(js, jnp.asarray(idx),
                                        jnp.asarray(hit))
    tt, to = t_dense.gather_hit_payload(ts, torch.as_tensor(idx),
                                        torch.as_tensor(hit))
    _same(jo, to, "orig")
    for f in ("vertices", "normals", "tangents", "uv"):
        _same(getattr(jt, f), getattr(tt, f), f)
    assert np.array_equal(np_(jt.metadata).astype(np.int64), np_(tt.metadata))


def test_pack_prims_hot_matches():
    jm, tm = _meshes("grid")
    _same(j_dense.pack_prims_hot(jm), t_dense.pack_prims_hot(tm), "hot")
    orig = np.arange(jm.vertices.shape[0], dtype=np.int32)[::-1].copy()
    _same(j_dense.pack_prims_hot(jm, jnp.asarray(orig)),
          t_dense.pack_prims_hot(tm, torch.as_tensor(orig)), "hot, orig")


@pytest.mark.parametrize("layout", ["tiles", "morton"])
def test_sort_permutations_match(layout):
    jm, tm = _meshes("blobby")
    cap, C = 8192, 128
    hot_j = j_dense._pack_hot_padded(jm.vertices, jm.metadata, cap)
    hot_t = t_dense._pack_hot_padded(tm.vertices, tm.metadata, cap)
    _same(hot_j, hot_t, "hot0")
    vj = np.array(hot_j[:, :9]).view(np.float32).reshape(cap, 3, 3)
    vt = torch.as_tensor(vj)
    if layout == "tiles":
        axes = t_lbvh.tile_sort_axes(vt[:jm.vertices.shape[0]], cap, C)
        assert axes == j_lbvh.tile_sort_axes(jnp.asarray(
            vj[:jm.vertices.shape[0]]), cap, C)
        pj = j_lbvh.tile_perm_padded(jnp.asarray(vj), axes=axes[0],
                                     s0=axes[1], s1=axes[2])
        pt = t_lbvh.tile_perm_padded(vt, axes=axes[0], s0=axes[1],
                                     s1=axes[2])
    else:
        pj = j_lbvh.morton_perm_padded(jnp.asarray(vj))
        pt = t_lbvh.morton_perm_padded(vt)
    assert np.array_equal(np_(pj).astype(np.int64), np_(pt))


def test_ray_features_match():
    o, d = ray_arrays(R=512, seed=1, zero_dirs=True)
    assert_ray_features_close(
        j_dense.ray_features(jnp.asarray(o), jnp.asarray(d)),
        t_dense.ray_features(torch.as_tensor(o), torch.as_tensor(d)), o, d)


def test_finalize_hits_exact_matches():
    """Same winners in, the same HitResult out (against the compiled JAX
    function, as the JAX engine runs it). Hits, indices and the gathered
    triangle are bitwise equal. The port recomputes (t, u, v) in plain
    float32 where the reference fuses products into FMAs, so t agrees
    within rtol 1e-6 (a few ulp) and the barycentrics within the 2e-5 of
    the end-to-end tests."""
    jm, tm = _meshes("grid")
    js = j_dense.build_dense(jm, cluster_size=128)
    ts = rt.build_dense(tm, cluster_size=128)
    o, d = ray_arrays(R=1024, seed=2)
    win = j_regroup(js, jax_rays(o, d), passes=1)
    # Winning table rows from the original indices, plus misses.
    inv = np.empty(js.n_prims, np.int64)
    inv[np.asarray(js.prims_hot[:, 10])] = np.arange(js.n_prims)
    hit = np.asarray(win.hit)
    pair = np.where(hit, inv[np.maximum(np.asarray(win.prim_idx), 0)], -1)
    pair = pair.astype(np.int32)
    t_approx = np.where(hit, np.asarray(win.t), np.nan).astype(np.float32)
    ref = jax.jit(j_dense.finalize_hits_exact)(js, jnp.asarray(pair),
                                      jnp.asarray(t_approx), jnp.asarray(o),
                                      jnp.asarray(d))
    got = t_dense.finalize_hits_exact(ts, torch.as_tensor(pair),
                                      torch.as_tensor(t_approx),
                                      torch.as_tensor(o), torch.as_tensor(d))
    assert hit.sum() > 100
    for f in ("hit", "prim_idx", "instance_idx"):
        _same(getattr(ref, f), getattr(got, f), f)
    np.testing.assert_allclose(np_(got.t), np_(ref.t), rtol=1e-6, atol=0)
    np.testing.assert_allclose(np_(got.barycentric), np_(ref.barycentric),
                               rtol=0, atol=2e-5)
    for f in ("vertices", "tangents", "uv"):
        _same(getattr(ref.triangle, f), getattr(got.triangle, f), f)
    # Flat-shaded: normals are recomputed as n / sqrt(n . n), which the
    # reference's compiler evaluates with FMAs and as n * rsqrt(n . n);
    # unit vectors agree within 2 ulp.
    np.testing.assert_allclose(np_(got.triangle.normals),
                               np_(ref.triangle.normals), rtol=0,
                               atol=2.4e-7)


def test_dense_scene_from_numpy_equals_port_build():
    jm, tm = _meshes("grid")
    js = j_dense.build_dense(jm, cluster_size=64)
    conv = convert.dense_scene_from_numpy(jax_scene_arrays(js), device=CPU)
    ts = rt.build_dense(tm, cluster_size=64)
    for f in TABLES:
        _same(getattr(conv, f), getattr(ts, f), f)
        assert getattr(conv, f).dtype == getattr(ts, f).dtype, f
    for f in ("vertices", "normals", "tangents", "uv"):
        _same(getattr(conv.prims, f), getattr(ts.prims, f), f)
    assert torch.equal(conv.prims.metadata, ts.prims.metadata)
    assert (conv.n_prims, conv.cluster_size, conv.sub_chunks,
            conv.payload_mask) == (ts.n_prims, ts.cluster_size,
                                   ts.sub_chunks, ts.payload_mask)
    o, d = ray_arrays(R=256, seed=4)
    r = convert.ray_from_numpy(o, d, np.zeros(256), np.full(256, np.inf),
                               device=CPU)
    assert torch.equal(r.o, torch_rays(o, d).o)


def test_instance_side_array_and_layout_check():
    tm = t_mesh.displaced_grid_mesh(n=8, device=CPU)
    inst = np.arange(tm.vertices.shape[0]) % 3
    ts = rt.build_dense(tm, cluster_size=32, instance_of=inst)
    o, d = ray_arrays(R=64, seed=5, coherent=True)
    res = rt.closest_hit(ts, torch_rays(o, d))
    h = res.hit
    assert bool(h.any())
    assert torch.equal(res.instance_idx[h],
                       torch.as_tensor(inst, dtype=torch.int32)[
                           res.prim_idx[h].long()])
    with pytest.raises(ValueError):
        rt.build_dense(tm, layout="hilbert")
