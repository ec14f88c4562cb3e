"""Parity of the port's core math, meshes and brute-force oracle with the
JAX package, on the CPU.

Both packages get the same NumPy inputs. Mesh generators, safe_invdir,
fast_intersect_triangle (against the compiled JAX function, whose dots
and cross products are fused multiply-adds), Morton codes and padding
must agree bit for bit. The port's fused multiply-add rounds once, as
exact rational arithmetic says.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.accel import morton as j_morton
from raycore_tpu.accel import types as j_types
from raycore_tpu.accel.brute import closest_hit_brute as j_brute
from raycore_tpu.core import triangle as j_tri
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch.accel import morton as t_morton
from raycore_tpu_torch.accel import types as t_types
from raycore_tpu_torch.core import triangle as t_tri
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import CPU, bits, jax_rays, np_, ray_arrays, torch_rays


def _same_triangles(a, b):
    for f in ("vertices", "normals", "tangents", "uv"):
        assert np.array_equal(bits(getattr(a, f)), bits(getattr(b, f))), f
    assert np.array_equal(np_(a.metadata).astype(np.int64),
                          np_(b.metadata))


@pytest.mark.parametrize("make", [
    lambda m, **kw: m.displaced_grid_mesh(n=40, **kw),
    lambda m, **kw: m.displaced_grid_mesh(n=17, extent=3.0, amplitude=0.2,
                                          seed=5, **kw),
    lambda m, **kw: m.blobby_mesh(n_theta=32, n_phi=24, seed=2, **kw),
    lambda m, **kw: m.build_triangles(
        *m.uv_sphere((0.5, 0, -1), 2.0, 6, 9)[:2],
        normals=m.uv_sphere((0.5, 0, -1), 2.0, 6, 9)[2], **kw),
    lambda m, **kw: m.sphere_mesh((0.5, 0, -1), 2.0, 12, 24, **kw),
    lambda m, **kw: m.box_mesh((-1, -2, -3), (0.5, 1.5, 2.5), **kw),
    lambda m, **kw: m.plane_mesh((0, 0, 1), (1, 0, 0.2), (0, 2, 0), **kw),
], ids=["grid40", "grid17", "blobby", "sphere", "sphere_mesh", "box_mesh",
        "plane_mesh"])
def test_mesh_generators_match(make):
    _same_triangles(make(j_mesh), make(t_mesh, device=CPU))


def test_uv_sphere_and_build_triangles_options_match():
    jv, jf, jn = j_mesh.uv_sphere((1, 2, 3), 0.5, 5, 7)
    tv, tf, tn = t_mesh.uv_sphere((1, 2, 3), 0.5, 5, 7)
    for a, b in ((jv, tv), (jf, tf), (jn, tn)):
        assert np.array_equal(a, b)
    # A degenerate face is dropped; metadata from a callable; per-vertex uv.
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [2, 0, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 3], [1, 3, 2]])
    uvs = np.arange(8, dtype=np.float32).reshape(4, 2)
    kw = dict(uvs=uvs, metadata=lambda i: 100 + i)
    a = j_mesh.build_triangles(verts, faces, **kw)
    b = t_mesh.build_triangles(verts, faces, device=CPU, **kw)
    assert b.vertices.shape[0] == 2
    _same_triangles(a, b)


def test_safe_invdir_and_clamp_match():
    d = np.array([0.0, -0.0, 1e-6, -1e-6, 1e-5, -1e-5, 1.00001e-5, 1e-4,
                  -0.3, 2.0, 1e-30, -1e-38, 7.5], np.float32)
    d = np.concatenate([d, np.random.default_rng(0).normal(
        size=1000).astype(np.float32) * 1e-4])
    ref = np.asarray(jax.jit(j_tri.safe_invdir)(d))
    got = t_tri.safe_invdir(torch.as_tensor(d)).numpy()
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))
    assert t_tri.INV_DIR_CLAMP == j_tri.INV_DIR_CLAMP


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_intersect_triangle_matches_compiled_jax(seed):
    rng = np.random.default_rng(seed)
    N = 50_000
    o = rng.normal(size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    v0, v1, v2 = (rng.normal(size=(N, 3)).astype(np.float32) * 0.3
                  for _ in range(3))
    t_min = rng.uniform(-1, 0.5, N).astype(np.float32)
    t_max = rng.uniform(1, 10, N).astype(np.float32)
    args = (o, d, v0, v1, v2, t_min, t_max)
    ref = jax.jit(j_tri.fast_intersect_triangle)(*args)
    got = t_tri.fast_intersect_triangle(*(torch.as_tensor(a) for a in args))
    assert np.array_equal(np_(ref[0]), np_(got[0]))
    assert np_(got[0]).sum() > 100
    for r, g in zip(ref[1:], got[1:]):
        assert np.array_equal(bits(r), bits(g))


def _round_f32(exact):
    """The float32 nearest to a Fraction, ties to even."""
    lo = np.float32(float(exact))
    near = [np.nextafter(lo, np.float32(-np.inf)), lo,
            np.nextafter(lo, np.float32(np.inf))]
    err = [abs(Fraction(float(f)) - exact) for f in near]
    best = [f for f, e in zip(near, err) if e == min(err)]
    if len(best) == 2:
        best = [f for f in best if not f.view(np.int32) & 1]
    return best[0]


def test_fma_rounds_once():
    """``fma`` against exact rational arithmetic. The smallest input that
    a float64 sum rounded to nearest gets wrong: x * y = 2^-24 + 2^-60,
    so 1 + x * y lies just past the halfway point 1 + 2^-24 and rounds up
    to 1 + 2^-23 (rounding to float64 first lands on the halfway point,
    which goes to even, 1). Then 3,000 sums on a float32 halfway point or
    near it (most within 2^-27 of half an ulp, on either side), at random
    exponents and signs, where rounding twice fails more than 100 times,
    and 1,000 random triples."""
    x = torch.tensor([1 + 2.0 ** -12])
    y = torch.tensor([(1 - 2.0 ** -12 + 2.0 ** -24) * 2.0 ** -24])
    one = torch.ones(1)
    assert t_tri.fma(x, y, one).item() == 1 + 2.0 ** -23
    assert (x.double() * y.double() + 1).float().item() == 1.0
    rng = np.random.default_rng(7)
    n = 3000
    # c has exponent e; a * b = ulp(c) / 2 * (1 + (y - x^2) 2^-24
    # + x y 2^-36) with 0 <= x <= 8 and y = x^2 (+-1 on a fifth): a sum
    # a few 2^-36 half ulps, or one 2^-24, from a float32 halfway point;
    # x = 0, y = 0 is the tie itself.
    e = rng.integers(-40, 40, n)
    c = (rng.integers(2 ** 23, 2 ** 24, n) * 2.0 ** (e - 23)
         * rng.choice([-1, 1], n)).astype(np.float32)
    xi = rng.integers(0, 9, n)
    yi = xi ** 2 + rng.choice([-1, 0, 0, 0, 0, 0, 0, 0, 0, 1], n)
    a = (1 + xi * 2.0 ** -12).astype(np.float32)
    half_ulp = 2.0 ** (e - 24) * np.sign(c) * rng.choice([-1, 1], n)
    b = ((1 - xi * 2.0 ** -12 + yi * 2.0 ** -24) * half_ulp) \
        .astype(np.float32)
    m = 1000
    a = np.concatenate([a, (rng.normal(size=m) * 2.0 ** rng.integers(
        -30, 30, m)).astype(np.float32)])
    b = np.concatenate([b, (rng.normal(size=m) * 2.0 ** rng.integers(
        -30, 30, m)).astype(np.float32)])
    c = np.concatenate([c, (rng.normal(size=m) * 2.0 ** rng.integers(
        -60, 60, m)).astype(np.float32)])
    got = t_tri.fma(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    wrong_twice = 0
    for xa, xb, xc, g, w in zip(a, b, c, got, twice):
        want = _round_f32(Fraction(float(xa)) * Fraction(float(xb))
                          + Fraction(float(xc)))
        assert want.view(np.int32) == g.view(np.int32)
        wrong_twice += int(want.view(np.int32) != w.view(np.int32))
    # The set reaches the double-rounding cases.
    assert wrong_twice > 100


def test_cross_and_dot3_match_compiled_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(20_000, 3)).astype(np.float32)
    b = rng.normal(size=(20_000, 3)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert np.array_equal(bits(jax.jit(jnp.cross)(a, b)),
                          bits(t_tri.cross(ta, tb)))
    jdot = jax.jit(lambda x, y: jnp.sum(x * y, axis=-1))
    assert np.array_equal(bits(jdot(a, b)), bits(t_tri.dot3(ta, tb)))


def test_morton_codes_match():
    rng = np.random.default_rng(5)
    p = rng.uniform(-0.1, 1.1, (10_000, 3)).astype(np.float32)
    ref = np.asarray(j_morton.morton_code_30bit(p)).astype(np.int64)
    got = t_morton.morton_code_30bit(torch.as_tensor(p)).numpy()
    assert np.array_equal(ref, got)
    x = np.arange(1024, dtype=np.uint32)
    assert np.array_equal(
        np.asarray(j_morton.expand_bits(x)).astype(np.int64),
        t_morton.expand_bits(torch.as_tensor(x.astype(np.int64))).numpy())


def test_types_pad_and_bitcasts_match():
    tris = j_mesh.displaced_grid_mesh(n=5)
    ttris = t_mesh.displaced_grid_mesh(n=5, device=CPU)
    _same_triangles(j_types.pad_triangles(tris, 64),
                    t_types.pad_triangles(ttris, 64))
    assert t_types.pad_triangles(ttris, 50) is ttris      # already full
    assert t_types.PAD_COORD == j_types.PAD_COORD
    for n in (0, 1, 2, 3, 64, 65, 1000):
        assert t_types.next_pow2(n) == j_types.next_pow2(n)
    x = np.array([1.5, -0.0, np.inf, 3e-39], np.float32)
    i = t_types.f32_as_i32(torch.as_tensor(x))
    assert np.array_equal(i.numpy(), np.asarray(j_types.f32_as_i32(x)))
    assert np.array_equal(bits(t_types.i32_as_f32(i)), x.view(np.int32))


def test_ray_and_triangle_create_broadcast():
    r = rt.Ray.create(torch.zeros(4, 5, 3), torch.tensor([0.0, 0.0, -1.0]),
                      t_max=7.0)
    assert r.batch_shape == (4, 5)
    assert r.d.shape == (4, 5, 3) and r.t_max.shape == (4, 5)
    assert float(r.t_max[2, 3]) == 7.0 and float(r.t_min.sum()) == 0.0
    tri = rt.Triangle.create(np.zeros((6, 3, 3), np.float32), device=CPU)
    assert tri.batch_shape == (6,) and len(tri) == 6
    assert tri.uv.shape == (6, 3, 2) and tri.metadata.dtype == torch.int64


@pytest.mark.parametrize("seed,chunk", [(3, 8192), (4, 1000)])
def test_brute_oracle_matches_jax(seed, chunk):
    """Same hits and winners; t within rtol 2e-6, because the JAX oracle
    runs op by op and rounds each product of its dots separately. (Rays
    exactly on a shared edge can flip with that rounding, so the rays are
    random rather than lattice-aligned.)"""
    o, d = ray_arrays(R=1024, seed=seed)
    jm = j_mesh.displaced_grid_mesh(n=24)
    tm = t_mesh.displaced_grid_mesh(n=24, device=CPU)
    ref = j_brute(jm, jax_rays(o, d))
    got = rt.closest_hit_brute(tm, torch_rays(o, d), tri_chunk=chunk)
    h = np_(ref.hit)
    assert np.array_equal(h, np_(got.hit)) and h.mean() > 0.1
    assert np.array_equal(np_(ref.prim_idx), np_(got.prim_idx))
    assert np.array_equal(np_(ref.instance_idx), np_(got.instance_idx))
    np.testing.assert_allclose(np_(got.t), np_(ref.t), rtol=2e-6, atol=0)
    np.testing.assert_allclose(np_(got.barycentric), np_(ref.barycentric),
                               rtol=0, atol=2e-5)
    _same_triangles(ref.triangle, got.triangle)


def test_brute_oracle_edge_cracks_match_compiled_jax():
    """Downward rays along x == y run exactly on the grid cells' diagonal
    edges. With its dots fused into multiply-add chains, u on such an edge
    is the rounding error of one product, so about half the rays miss both
    triangles. The port's oracle misses the same rays as the compiled JAX
    oracle; the op-by-op JAX oracle, whose products cancel exactly, hits
    them all."""
    tris = j_mesh.displaced_grid_mesh(n=40)
    s = np.linspace(-0.9, 0.9, 1024, dtype=np.float32)
    o = np.stack([s, s, np.full_like(s, 3.0)], -1)
    d = np.ascontiguousarray(np.broadcast_to(
        np.array([0, 0, -1], np.float32), o.shape))
    jr = jax_rays(o, d)
    ref = np_(jax.jit(j_brute)(tris, jr).hit)
    got = np_(rt.closest_hit_brute(t_mesh.displaced_grid_mesh(n=40,
                                                              device=CPU),
                                   torch_rays(o, d)).hit)
    assert np_(j_brute(tris, jr).hit).all()
    assert 300 < (~got).sum() < 700
    assert np.array_equal(ref, got)
