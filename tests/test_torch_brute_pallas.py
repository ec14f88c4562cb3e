"""Parity of the dense brute-force sweep (kernel K6's plain version) and
``closest_hit_brute_pallas`` with the JAX package, on the CPU.

Sizes are the JAX package's own tests (tests/test_pallas.py). The
contract is the one that file holds JAX's kernel to against its XLA
brute force (:13-29): equal hit masks and prims, t within rtol 1e-5 /
atol 1e-6 (the two evaluate the test with other roundings). The table
is bitwise equal, and the plain version equals the port's oracle
``closest_hit_brute`` bit for bit (both evaluate the reference's fused
multiply-add chains).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
from raycore_tpu.ops import pallas_brute as j_pb
from raycore_tpu_torch import Ray
from raycore_tpu_torch.accel.brute import closest_hit_brute as t_brute
from raycore_tpu_torch.ops import brute as t_pb
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import CPU, bits, np_


def _meshes(kind):
    if kind == "box":
        return rc.box_mesh(), t_mesh.box_mesh(device=CPU)
    if kind == "plane":
        kw = dict(center=(0, 0, 0), u=(1, 0, 0), v=(0, 1, 0))
        return rc.plane_mesh(**kw), t_mesh.plane_mesh(**kw, device=CPU)
    kw = dict(radius=1.0, n_theta=12, n_phi=24)
    return rc.sphere_mesh(**kw), t_mesh.sphere_mesh(**kw, device=CPU)


def _rays(shape, seed=1234):
    """tests/test_pallas.py's rays: origins at z = -4 over [-2, 2]^2,
    looking up +z (the shared ``rng`` fixture's seed)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, shape + (3,)).astype(np.float32)
    o[..., 2] = -4.0
    d = np.zeros(shape + (3,), np.float32)
    d[..., 2] = 1.0
    return o, d


def _check(ref, got, min_hits=1):
    """tests/test_pallas.py:22-29's contract."""
    h = np_(ref.hit)
    assert np.array_equal(h, np_(got.hit))
    assert h.sum() >= min_hits
    np.testing.assert_allclose(np_(got.t)[h], np_(ref.t)[h], rtol=1e-5,
                               atol=1e-6)
    assert np.array_equal(np_(ref.prim_idx), np_(got.prim_idx))


@pytest.mark.parametrize("kind", ["box", "sphere"])
def test_make_tri_table_matches_jax(kind):
    jm, tm = _meshes(kind)
    jt, tt = j_pb.make_tri_table(jm), t_pb.make_tri_table(tm)
    assert np.array_equal(bits(jt), bits(tt))
    T = tm.vertices.shape[0]
    assert tt.shape == (9, -(-T // t_pb.TRI_BLOCK) * t_pb.TRI_BLOCK)
    assert not tt[:, T:].any()                     # zero padding


def test_t_range_and_sentinel_match_jax():
    """tests/test_pallas.py:32-43: a ray stopped short by t_max and one
    that starts past the plane miss with a zero triangle; the free ray
    hits at t = 5. JAX's kernel runs in interpret mode."""
    jm, tm = _meshes("plane")
    for kw in (dict(t_max=4.0), dict(t_min=6.0), {}):
        jr = rc.Ray.create(o=[0.1, 0.1, -5.0], d=[0.0, 0, 1.0], **kw)
        tr = Ray.create([0.1, 0.1, -5.0], [0.0, 0, 1.0], device=CPU, **kw)
        ref = j_pb.closest_hit_brute_pallas(jm, jr, interpret=True)
        got = t_pb.closest_hit_brute_pallas(tm, tr)
        assert got.hit.shape == () and bool(got.hit) == bool(ref.hit)
        assert bits(ref.t) == bits(got.t)
        assert int(ref.prim_idx) == int(got.prim_idx)
        if not kw:
            assert bool(got.hit) and float(got.t) == pytest.approx(5.0)
        else:
            assert not got.triangle.vertices.any()
            assert not got.barycentric.any()
            assert int(got.instance_idx) == -1


@pytest.mark.parametrize("kind,shape", [("sphere", (300,)),
                                        ("box", (7, 5))])
def test_closest_hit_brute_pallas_matches_jax(kind, shape):
    """The sphere's 300 rays and the (7, 5) box batch
    (tests/test_pallas.py:13-29, :52-63) against JAX's XLA brute force,
    the reference JAX's own test holds its kernel to, and against JAX's
    kernel in interpret mode."""
    jm, tm = _meshes(kind)
    o, d = _rays(shape)
    jr = rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))
    got = t_pb.closest_hit_brute_pallas(tm, Ray.create(torch.as_tensor(o),
                                                       torch.as_tensor(d)))
    assert got.hit.shape == shape and got.triangle.vertices.shape == \
        shape + (3, 3)
    min_hits = 20 if kind == "sphere" else 1
    _check(rc.closest_hit_brute(jm, jr), got, min_hits)
    ref = j_pb.closest_hit_brute_pallas(jm, jr, interpret=True)
    _check(ref, got, min_hits)
    h = np_(got.hit)
    np.testing.assert_allclose(np_(got.barycentric)[h],
                               np_(ref.barycentric)[h], atol=1e-5)
    assert np.array_equal(np_(ref.instance_idx), np_(got.instance_idx))
    assert np.array_equal(bits(ref.triangle.vertices),
                          bits(got.triangle.vertices))


def test_plain_sweep_equals_the_oracle_bitwise():
    """run_brute_plain is the oracle's sweep: t, u, v and the index are the
    oracle's bits, on a table that is not a whole TRI_BLOCK (any T is
    taken)."""
    _, tm = _meshes("sphere")
    o, d = _rays((300,), seed=3)
    d[:, 0] = np.float32(0.05)
    rays = Ray.create(torch.as_tensor(o), torch.as_tensor(d), t_max=4.6)
    ref = t_brute(tm, rays)
    T = tm.vertices.shape[0]
    table = t_pb.make_tri_table(tm)[:, :T].contiguous()
    t, idx, u, v = t_pb.run_brute(table, rays.o, rays.d, rays.t_min,
                                  rays.t_max)
    assert 0 < int((idx >= 0).sum()) < 300
    assert np.array_equal(np_(idx), np_(ref.prim_idx))
    assert np.array_equal(bits(t), bits(ref.t))
    bary = torch.where((idx >= 0)[:, None], torch.stack([1 - u - v, u, v], -1),
                       0.0)
    assert np.array_equal(bits(bary), bits(ref.barycentric))
