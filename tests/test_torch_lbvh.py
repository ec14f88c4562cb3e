"""Parity of the LBVH build with the JAX package, on the CPU: clz32, the
Karras radix tree, the refit and the BLAS build, bit for bit (node
matrix, Morton prim order, root AABB), at 1, 2 and random triangle counts
as tests/test_bvh.py builds them, and on the mesh generators' meshes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import lbvh as j_lbvh
from raycore_tpu.accel import morton as j_morton
from raycore_tpu_torch import convert
from raycore_tpu_torch.accel import lbvh as t_lbvh
from raycore_tpu_torch.accel import morton as t_morton
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import CPU, bits, jax_blas_arrays, np_


def _tris(rng, n, extent=2.0, size=0.1):
    """tests/test_bvh.py:rand_tris as NumPy vertices."""
    base = rng.uniform(-extent, extent, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    return base + offs


def _pair(v):
    return (rc.Triangle.create(jnp.asarray(v)),
            rt.Triangle.create(torch.as_tensor(v)))


def assert_blas_equal(jb, tb):
    assert (tb.n_prims, tb.capacity) == (jb.n_prims, jb.capacity)
    assert np.array_equal(np_(jb.nodes), np_(tb.nodes))
    for f in ("vertices", "normals", "tangents", "uv"):
        assert np.array_equal(bits(getattr(jb.prims, f)),
                              bits(getattr(tb.prims, f))), f
    assert np.array_equal(np_(jb.prims.metadata).astype(np.int64),
                          np_(tb.prims.metadata))
    assert np.array_equal(bits(jb.root_aabb), bits(tb.root_aabb))


def test_clz32_matches_jax():
    vals = [0, 1, 2, 3, 0x7FFFFFFF, -1, -2, -0x80000000, 12345, -777]
    vals += [1 << k for k in range(31)]
    rng = np.random.default_rng(0)
    x = np.concatenate([np.asarray(vals, np.int64).astype(np.int32),
                        rng.integers(-2 ** 31, 2 ** 31, 200, dtype=np.int64)
                        .astype(np.int32)])
    want = np.asarray(j_morton.clz32(jnp.asarray(x.view(np.uint32))))
    got = t_morton.clz32(torch.as_tensor(x))
    assert got.dtype == torch.int32
    assert np.array_equal(want, np_(got))
    assert int(t_morton.clz32(torch.tensor([0]))[0]) == 32
    # int64 holding uint32 values (the port's Morton codes) read the same.
    assert np.array_equal(
        want, np_(t_morton.clz32(torch.as_tensor(x.view(np.uint32)
                                                  .astype(np.int64)))))


@pytest.mark.parametrize("n", [2, 3, 8, 33, 128, 1000])
@pytest.mark.parametrize("dup", [False, True])
def test_karras_topology_matches_jax(n, dup):
    """Random sorted codes, and codes with long duplicate runs (the index
    tiebreak): child0, child1 and parent equal JAX's."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 8 if dup else 2 ** 30, n).astype(np.uint32)
    codes.sort()
    want = j_lbvh.karras_topology(jnp.asarray(codes))
    got = t_lbvh.karras_topology(torch.as_tensor(codes.astype(np.int64)))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(np_(w), np_(g))
    # Every node but the root has one parent, and parents invert children.
    c0, c1, parent = (np_(g) for g in got)
    count = np.bincount(np.concatenate([c0, c1]), minlength=2 * n - 1)
    assert count[0] == 0 and (count[1:] == 1).all()
    assert parent[0] == -1
    assert (parent[c0] == np.arange(n - 1)).all()


def test_karras_topology_all_equal_codes():
    n = 16
    want = j_lbvh.karras_topology(jnp.asarray(np.full(n, 12345, np.uint32)))
    got = t_lbvh.karras_topology(torch.full((n,), 12345, dtype=torch.int64))
    for w, g in zip(want, got):
        assert np.array_equal(np_(w), np_(g))


@pytest.mark.parametrize("n_passes", [None, 3])
def test_refit_aabbs_matches_jax(n_passes):
    rng = np.random.default_rng(5)
    n = 64
    codes = np.sort(rng.integers(0, 2 ** 30, n).astype(np.uint32))
    c0, c1, _ = j_lbvh.karras_topology(jnp.asarray(codes))
    lo = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.2, (n, 3)).astype(np.float32)
    want = j_lbvh.refit_aabbs(c0, c1, jnp.asarray(lo), jnp.asarray(hi),
                              n_passes=n_passes)
    got = t_lbvh.refit_aabbs(torch.tensor(np_(c0)),
                             torch.tensor(np_(c1)), torch.as_tensor(lo),
                             torch.as_tensor(hi), n_passes=n_passes)
    for w, g in zip(want, got):
        assert np.array_equal(bits(w), bits(g))
    if n_passes is None:
        assert np.array_equal(np_(got[0])[0], lo.min(0))
        assert np.array_equal(np_(got[1])[0], hi.max(0))


@pytest.mark.parametrize("n", [1, 2, 5, 100, 777])
def test_build_blas_matches_jax(n):
    """One and two triangles (capacity 2, no special case) and random
    counts: nodes, Morton prim order and root AABB bit for bit."""
    jt, tt = _pair(_tris(np.random.default_rng(n), n))
    jb, tb = j_lbvh.build_blas(jt), t_lbvh.build_blas(tt)
    assert tb.capacity == max(2, 1 << (n - 1).bit_length())
    assert tuple(tb.nodes.shape) == (2 * tb.capacity - 1, 16)
    assert_blas_equal(jb, tb)
    leaf = np_(tb.nodes)[:, 12] == -1
    assert leaf.sum() == tb.capacity and leaf[tb.capacity - 1:].all()


def test_build_blas_explicit_capacity_matches_jax():
    jt, tt = _pair(_tris(np.random.default_rng(9), 20))
    assert_blas_equal(j_lbvh.build_blas(jt, capacity=64),
                      t_lbvh.build_blas(tt, capacity=64))


@pytest.mark.parametrize("mesh", ["sphere", "box", "plane"])
def test_build_blas_on_meshes_matches_jax(mesh):
    """The generators' meshes, with their normals, uv and metadata riding
    the Morton permutation."""
    from raycore_tpu.scene import mesh as j_mesh
    make = {"sphere": lambda m, **k: m.sphere_mesh(radius=1.0, n_theta=8,
                                                   n_phi=16, **k),
            "box": lambda m, **k: m.box_mesh(**k),
            "plane": lambda m, **k: m.plane_mesh(center=(0, 0, 0),
                                                 u=(4, 0, 0), v=(0, 4, 0),
                                                 **k)}[mesh]
    assert_blas_equal(j_lbvh.build_blas(make(j_mesh)),
                      t_lbvh.build_blas(make(t_mesh, device=CPU)))


def test_blas_from_jax_tables_round_trips():
    """convert.blas_from_numpy takes the JAX build's tables as they are."""
    jt, _ = _pair(_tris(np.random.default_rng(3), 50))
    jb = j_lbvh.build_blas(jt)
    assert_blas_equal(jb, convert.blas_from_numpy(jax_blas_arrays(jb),
                                                  device=CPU))


def test_build_blas_traces_like_the_reference():
    """A built BLAS answers a ray as tests/test_bvh.py's single-triangle
    case does: a hit at t = 5 from below, a miss from above."""
    tri = rt.Triangle.create(torch.tensor([[[0., 0., 0.], [1., 0., 0.],
                                            [0., 1., 0.]]]))
    scene = rt.blas_to_static_tlas(t_lbvh.build_blas(tri))
    up = torch.tensor([[0.0, 0.0, 1.0]])
    hit = rt.closest_hit(scene, rt.Ray.create(torch.tensor([[0.2, 0.2, -5.]]),
                                              up))
    assert bool(hit.hit[0]) and float(hit.t[0]) == pytest.approx(5.0, 1e-6)
    miss = rt.closest_hit(scene, rt.Ray.create(
        torch.tensor([[0.2, 0.2, 5.]]), up))
    assert not bool(miss.hit[0])
