"""Parity of the accel protocol (``accel/protocol.py``) and the transport
records (``accel/transport.py``) with the JAX package, on the CPU: twins
of ``tests/test_contract.py`` for both accels.

The same meshes and mutations go to each package's accel. The brute
accel's world vertices are NumPy float32 on the host in both, so they
are equal bit for bit; queries are held to JAX's under the engine
contract (``torch_parity.check_hits``) and to each other.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.accel import protocol as j_protocol
from raycore_tpu.accel import transport as j_transport
from raycore_tpu.accel.brute import HitResult as JHitResult
from raycore_tpu.core.triangle import Triangle as JTriangle
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu.scene.tlas import TLAS as JTLAS
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import CPU, bits, check_hits, jax_rays, np_, torch_rays

ACCELS = ("TLASAccel", "BruteAccel")


def _fill(accel, mesh, box_kw):
    accel.push(mesh.sphere_mesh(radius=1.0, n_theta=12, n_phi=24,
                                **box_kw), None)
    tr = np.eye(3, 4, dtype=np.float32)
    tr[0, 3] = 3.0
    accel.push(mesh.box_mesh(p_min=(-0.5, -0.5, -0.5), p_max=(0.5, 0.5, 0.5),
                             **box_kw), tr, instance_id=7)
    return accel


@pytest.fixture(params=ACCELS)
def accels(request):
    """(JAX accel, port accel) of one kind, filled alike."""
    j = _fill(getattr(j_protocol, request.param)(), j_mesh, {})
    t = _fill(getattr(rt, request.param)(device=CPU), t_mesh,
              {"device": CPU})
    return j, t


def test_contract_counts_and_bounds(accels):
    j, t = accels
    assert (t.n_instances, t.n_geometries) == (2, 2)
    assert (j.n_instances, j.n_geometries) == (t.n_instances, t.n_geometries)
    wb = np.asarray(t.world_bound())
    assert np.array_equal(wb.view(np.int32),
                          np.asarray(j.world_bound()).view(np.int32))
    np.testing.assert_allclose(wb[0], [-1, -1, -1], atol=0.01)
    np.testing.assert_allclose(wb[1], [3.5, 1, 1], atol=0.01)
    assert t.wait_for_gpu() is t


_O = np.float32([[0.05, 0.02, -4.0], [3.05, 0.02, -4.0], [9.0, 0, -4.0]])
_D = np.broadcast_to(np.float32([0, 0, 1]), (3, 3)).copy()


def test_contract_queries(accels):
    j, t = accels
    res = t.closest_hit(torch_rays(_O, _D))
    assert list(np_(res.hit)) == [True, True, False]
    np.testing.assert_allclose(np_(res.t)[0], 3.0, atol=0.05)
    np.testing.assert_allclose(np_(res.t)[1], 3.5, atol=1e-4)
    assert list(np_(res.instance_idx)) == [0, 1, -1]
    check_hits(j.closest_hit(jax_rays(_O, _D)), res)
    a = t.any_hit(torch_rays(_O, _D))
    assert np.array_equal(np_(a.hit), np_(res.hit))
    ja = j.any_hit(jax_rays(_O, _D))
    assert np.array_equal(np.asarray(ja.hit), np_(a.hit))
    assert np.array_equal(np.asarray(ja.instance_idx), np_(a.instance_idx))


def test_contract_mutation(accels):
    j, t = accels
    far = np.eye(3, 4, dtype=np.float32)
    far[1, 3] = 50.0
    ray = ([0.0, 50.0, -4.0], [0.0, 0, 1.0])
    for acc, mesh, kw, rays in ((j, j_mesh, {}, jax_rays),
                                (t, t_mesh, {"device": CPU}, torch_rays)):
        small = lambda: mesh.sphere_mesh(radius=0.3, n_theta=8, n_phi=12,
                                         **kw)
        h = acc.push(small(), far)
        assert acc.n_instances == 3
        acc.delete(h)
        assert acc.n_instances == 2
        h2 = acc.push(small(), None)
        acc.update_transform(h2, far)
    got = t.closest_hit(torch_rays(*(np.float32(r) for r in ray)))
    ref = j.closest_hit(jax_rays(*(np.float32(r) for r in ray)))
    assert bool(got.hit) and bool(ref.hit)
    assert float(got.t) == pytest.approx(float(ref.t), rel=2e-5, abs=2e-6)
    assert int(got.instance_idx) == int(ref.instance_idx)


def test_brute_accel_world_soup_is_jax_bitwise():
    j = _fill(j_protocol.BruteAccel(), j_mesh, {})
    t = _fill(rt.BruteAccel(device=CPU), t_mesh, {"device": CPU})
    (jt, jinst), (tt, tinst) = j.sync(), t.sync()
    for k in ("vertices", "normals", "uv"):
        assert np.array_equal(bits(getattr(jt, k)), bits(getattr(tt, k))), k
    assert np.array_equal(np.asarray(jt.metadata).astype(np.int64),
                          np_(tt.metadata))
    assert np.array_equal(np.asarray(jinst), np_(tinst))


def test_accels_agree_on_many_rays():
    """The two port accels on the contract scene: equal hit masks and
    instances, t within the engine contract."""
    rng = np.random.default_rng(4)
    o = rng.uniform(-1.5, 4.0, (512, 3)).astype(np.float32)
    o[:, 2] = -4.0
    d = np.broadcast_to(np.float32([0, 0, 1]), o.shape).copy()
    tl = _fill(rt.TLASAccel(device=CPU), t_mesh, {"device": CPU})
    br = _fill(rt.BruteAccel(device=CPU), t_mesh, {"device": CPU})
    a, b = tl.closest_hit(torch_rays(o, d)), br.closest_hit(torch_rays(o, d))
    m = np_(a.hit)
    assert np.array_equal(m, np_(b.hit)) and 0 < m.sum() < len(m)
    np.testing.assert_allclose(np_(a.t)[m], np_(b.t)[m], rtol=2e-5,
                               atol=2e-6)
    assert np.array_equal(np_(a.instance_idx), np_(b.instance_idx))


def _transport_scenes():
    jm = JTLAS()
    jm.push(j_mesh.sphere_mesh(radius=1.0, n_theta=12, n_phi=24), None,
            instance_id=99)
    tm = rt.TLAS(device=CPU)
    tm.push(t_mesh.sphere_mesh(radius=1.0, n_theta=12, n_phi=24,
                               device=CPU), None, instance_id=99)
    return jm.sync(), tm.sync()


def test_rt_transport_roundtrip():
    js, ts = _transport_scenes()
    o = np.float32([[0.05, 0.02, -4.0], [5.0, 5, 5]])
    d = np.float32([[0.0, 0, 1.0], [0.0, 0, 1.0]])
    t_min, t_max = np.zeros(2, np.float32), np.full(2, np.inf, np.float32)
    trr = rt.RTRay(origin=torch.as_tensor(o), t_min=torch.as_tensor(t_min),
                   direction=torch.as_tensor(d),
                   t_max=torch.as_tensor(t_max))
    jrr = j_transport.RTRay(origin=jnp.asarray(o), t_min=jnp.asarray(t_min),
                            direction=jnp.asarray(d),
                            t_max=jnp.asarray(t_max))
    assert np.array_equal(np_(trr.pack()), np.asarray(jrr.pack()))
    assert trr.pack().shape == (2, 8)
    res = rt.trace_closest_hits(ts, trr, tile_size=64)
    ref = j_transport.trace_closest_hits(js, jrr, tile_size=64)
    assert bool(res.hit[0]) and not bool(res.hit[1])
    assert float(res.t[0]) == pytest.approx(3.0, abs=0.05)
    assert int(res.instance_custom_index[0]) == 99     # the override wins
    assert int(res.instance_custom_index[1]) == 0
    for k in ("hit", "primitive_id", "instance_custom_index", "instance_id"):
        assert np.array_equal(np.asarray(getattr(ref, k)).astype(np.int64),
                              np_(getattr(res, k)).astype(np.int64)), k
    np.testing.assert_allclose(np_(res.t), np.asarray(ref.t), rtol=2e-5,
                               atol=2e-6)
    u, v = float(res.bary_u[0]), float(res.bary_v[0])
    assert 0 <= u <= 1 and 0 <= v <= 1
    anyres = rt.trace_any_hits(ts, trr, tile_size=64)
    assert bool(anyres.hit[0]) and not bool(anyres.hit[1])
    back = rt.RTRay.from_rays(trr.to_rays())
    for k in ("origin", "t_min", "direction", "t_max"):
        assert torch.equal(getattr(back, k), getattr(trr, k)), k


@pytest.mark.parametrize("with_instances", [False, True])
def test_rt_hit_result_matches_jax(with_instances):
    """from_hit_result on one HitResult in both packages: an instance_id
    of 0 inherits the triangle's metadata (here up to 2^32 - 1), any
    other value is forwarded; misses carry 0."""
    rng = np.random.default_rng(8)
    n = 64
    hit = rng.random(n) < 0.7
    meta = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    inst = np.where(hit, rng.integers(0, 4, n), -1).astype(np.int32)
    bary = rng.random((n, 3)).astype(np.float32)
    t = rng.random(n).astype(np.float32)
    prim = rng.integers(0, 100, n).astype(np.int32)
    z3 = np.zeros((n, 3, 3), np.float32)
    ids = np.uint32([0, 5, 0, 2 ** 32 - 1])
    jres = JHitResult(hit=jnp.asarray(hit), t=jnp.asarray(t),
                      barycentric=jnp.asarray(bary),
                      prim_idx=jnp.asarray(prim),
                      instance_idx=jnp.asarray(inst),
                      triangle=JTriangle(
                          vertices=jnp.asarray(z3), normals=jnp.asarray(z3),
                          tangents=jnp.asarray(z3),
                          uv=jnp.zeros((n, 3, 2)), metadata=jnp.asarray(meta)))
    tres = rt.HitResult(hit=torch.as_tensor(hit), t=torch.as_tensor(t),
                        barycentric=torch.as_tensor(bary),
                        prim_idx=torch.as_tensor(prim),
                        instance_idx=torch.as_tensor(inst),
                        triangle=rt.Triangle(
                            vertices=torch.as_tensor(z3),
                            normals=torch.as_tensor(z3),
                            tangents=torch.as_tensor(z3),
                            uv=torch.zeros((n, 3, 2)),
                            metadata=torch.as_tensor(meta.astype(np.int64))))
    jinst = tinst = None
    if with_instances:
        from types import SimpleNamespace
        jinst = SimpleNamespace(instance_id=jnp.asarray(ids))
        tinst = SimpleNamespace(
            instance_id=torch.as_tensor(ids.astype(np.int64)))
    ref = j_transport.RTHitResult.from_hit_result(jres, jinst)
    got = rt.RTHitResult.from_hit_result(tres, tinst)
    assert np.array_equal(
        np.asarray(ref.instance_custom_index).astype(np.int64),
        np_(got.instance_custom_index))
    for k in ("hit", "t", "primitive_id", "bary_u", "bary_v",
              "instance_id"):
        assert np.array_equal(np.asarray(getattr(ref, k)),
                              np_(getattr(got, k))), k
