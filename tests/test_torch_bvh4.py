"""Parity of the BVH4 layer (``accel/wide.py``) with the JAX package, on
the CPU: twins of ``tests/test_bvh4.py``.

The packed (n-1, 32) rows must equal JAX's bit for bit (the collapse is
gathers and min/max only). The 4-wide traversal is held to JAX's: equal
hit masks, prims and t bits (both run the reference's compiled arithmetic,
the slab products fused), and to the brute-force oracle as the JAX tests
hold it (t within rtol 1e-4, atol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import wide as j_wide
from raycore_tpu.accel.lbvh import build_blas as j_build_blas
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch import convert
from raycore_tpu_torch.accel import wide as t_wide
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import CPU, bits, jax_rays, np_, torch_rays

LEAF = 1 << 30


def _rand_v(rng, n, extent=2.0, size=0.1):
    base = rng.uniform(-extent, extent, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    return base + offs


def _both_blas4(v):
    j = j_wide.build_blas4(rc.Triangle.create(jnp.asarray(v)))
    t = t_wide.build_blas4(rt.Triangle.create(torch.as_tensor(v)))
    assert np.array_equal(np.asarray(j.nodes4), np_(t.nodes4))
    assert np.array_equal(bits(j.root_aabb), bits(t.root_aabb))
    assert (j.n_prims, j.capacity) == (t.n_prims, t.capacity)
    return j, t


def _aimed(rng, v, n):
    c = v.mean(1)
    tgt = c[rng.integers(0, len(c), n)] \
        + rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _same_hits(ref, got):
    assert np.array_equal(np.asarray(ref.hit), np_(got.hit))
    assert np.array_equal(np.asarray(ref.prim_idx), np_(got.prim_idx))
    assert np.array_equal(bits(ref.t), bits(got.t))
    assert np.array_equal(bits(ref.barycentric), bits(got.barycentric))
    assert np.array_equal(np.asarray(ref.triangle.metadata).astype(np.int64),
                          np_(got.triangle.metadata))


def test_collapse_structure():
    rng = np.random.default_rng(1234)
    v = _rand_v(rng, 64)
    _, b4 = _both_blas4(v)
    assert b4.nodes4.shape == (63, 32) and b4.nodes4.dtype == torch.int32
    nodes4 = np_(b4.nodes4)
    refs = nodes4[:, 24:28]
    boxes = nodes4[:, :24].view(np.float32)
    seen, frontier, visited = set(), [0], set()
    while frontier:
        r = frontier.pop()
        if r in visited:
            continue
        visited.add(r)
        for ref in refs[r]:
            if ref == -1:
                continue
            if ref & LEAF:
                seen.add(ref & (LEAF - 1))
            else:
                frontier.append(ref)
    assert seen == set(range(64))
    verts = np_(b4.prims.vertices)
    for r in visited:
        for k in range(4):
            ref = refs[r, k]
            if ref != -1 and ref & LEAF:
                p = ref & (LEAF - 1)
                assert np.all(verts[p].min(0) >= boxes[r, 6 * k:6 * k + 3]
                              - 1e-5)
                assert np.all(verts[p].max(0) <= boxes[r, 6 * k + 3:6 * k + 6]
                              + 1e-5)


@pytest.mark.parametrize("n_tris", [7, 128, 501])
def test_closest_hit4_matches_jax_and_brute(n_tris):
    rng = np.random.default_rng(n_tris)
    v = _rand_v(rng, n_tris)
    j4, t4 = _both_blas4(v)
    o, d = _aimed(rng, v, 256)
    ref = j_wide.closest_hit4(j4, jax_rays(o, d), tile_size=256)
    got = rt.closest_hit4(t4, torch_rays(o, d), tile_size=256)
    _same_hits(ref, got)
    rb = rt.closest_hit_brute(rt.Triangle.create(torch.as_tensor(v)),
                              torch_rays(o, d))
    h = np_(got.hit)
    assert np.array_equal(h, np_(rb.hit)) and h.sum() > 30
    np.testing.assert_allclose(np_(got.t)[h], np_(rb.t)[h], rtol=1e-4,
                               atol=1e-5)
    assert (np_(got.triangle.metadata)[h]
            == np_(rb.triangle.metadata)[h]).mean() > 0.98


def test_any_hit4_matches_jax():
    rng = np.random.default_rng(200)
    v = _rand_v(rng, 200)
    j4, t4 = _both_blas4(v)
    o, d = _aimed(rng, v, 128)
    ref = j_wide.any_hit4(j4, jax_rays(o, d, t_min=0.5), tile_size=128)
    got = rt.any_hit4(t4, torch_rays(o, d, t_min=0.5), tile_size=128)
    _same_hits(ref, got)
    c = rt.closest_hit4(t4, torch_rays(o, d), tile_size=128)
    assert np.array_equal(np_(got.hit), np_(c.hit))
    m = np_(got.hit)
    assert np.all(np_(got.t)[m] >= np_(c.t)[m] - 1e-5)


def _depth(nodes4):
    refs = np_(nodes4)[:, 24:28]
    depth, frontier, best = {0: 1}, [0], 1
    while frontier:
        r = frontier.pop()
        for ref in refs[r]:
            if ref == -1 or ref & LEAF:
                continue
            if ref not in depth or depth[ref] < depth[r] + 1:
                depth[ref] = depth[r] + 1
                best = max(best, depth[ref])
                frontier.append(ref)
    return best


def test_collapse_interior_preference_on_skewed_tree():
    """A caterpillar Karras tree: the third expansion fills all 4 slots,
    so the BVH4 is far shallower than half the BVH2's depth; the rows and
    the hits equal JAX's."""
    rng = np.random.default_rng(1234)
    n = 128
    x = (2.0 ** -np.arange(n, dtype=np.float64)).astype(np.float32)
    base = np.stack([x, np.zeros_like(x), np.zeros_like(x)], -1)[:, None]
    offs = np.array([[0, 0, 0], [0, 0.01, 0], [0, 0, 0.01]],
                    np.float32)[None] * np.maximum(x, 1e-6)[:, None, None]
    v = (base + offs).astype(np.float32)
    j4, t4 = _both_blas4(v)
    assert _depth(t4.nodes4) < n // 2 - 8
    o, d = _aimed(rng, v, 128)
    ref = j_wide.closest_hit4(j4, jax_rays(o, d), tile_size=128)
    got = rt.closest_hit4(t4, torch_rays(o, d), tile_size=128)
    _same_hits(ref, got)
    rb = rt.closest_hit_brute(rt.Triangle.create(torch.as_tensor(v)),
                              torch_rays(o, d))
    assert np.array_equal(np_(got.hit), np_(rb.hit))


def test_bvh4_sphere_and_jax_blas4_carried_across():
    kw = dict(radius=1.0, n_theta=16, n_phi=32)
    j4 = j_wide.build_blas4(j_mesh.sphere_mesh(**kw))
    t4 = rt.build_blas4(t_mesh.sphere_mesh(**kw, device=CPU))
    assert np.array_equal(np.asarray(j4.nodes4), np_(t4.nodes4))
    o, d = np.float32([0.05, 0.02, -4.0]), np.float32([0.0, 0, 1.0])
    got = rt.closest_hit4(t4, torch_rays(o, d), tile_size=8)
    assert bool(got.hit) and float(got.t) == pytest.approx(3.0, abs=0.05)
    # A JAX BLAS4 queried by the port.
    carried = convert.blas4_from_numpy(dict(
        nodes4=np.asarray(j4.nodes4), root_aabb=np.asarray(j4.root_aabb),
        n_prims=j4.n_prims, capacity=j4.capacity,
        **{k: np.asarray(getattr(j4.prims, k)) for k in
           ("vertices", "normals", "tangents", "uv", "metadata")}),
        device=CPU)
    again = rt.closest_hit4(carried, torch_rays(o, d), tile_size=8)
    assert np.array_equal(bits(got.t), bits(again.t))


def test_collapse_blas_of_a_jax_blas_matches():
    """collapse_blas on a BLAS carried from JAX gives JAX's rows."""
    rng = np.random.default_rng(5)
    v = _rand_v(rng, 300)
    jb = j_build_blas(rc.Triangle.create(jnp.asarray(v)))
    tb = convert.blas_from_numpy(dict(
        nodes=np.asarray(jb.nodes), root_aabb=np.asarray(jb.root_aabb),
        n_prims=jb.n_prims, capacity=jb.capacity,
        **{k: np.asarray(getattr(jb.prims, k)) for k in
           ("vertices", "normals", "tangents", "uv", "metadata")}),
        device=CPU)
    assert np.array_equal(np.asarray(j_wide.collapse_blas(jb).nodes4),
                          np_(rt.collapse_blas(tb).nodes4))


def test_sort4_network_keeps_its_order_on_ties():
    """The 5-comparator network swaps only on a strict >, so equal keys
    keep the network's order, which a sort need not."""
    keys = [torch.tensor([1.0, 2.0, 2.0, 0.5]), torch.tensor([1.0, 2.0, 1.0,
                                                               0.5]),
            torch.tensor([1.0, 0.0, 1.0, 0.5]), torch.tensor([1.0, 2.0, 1.0,
                                                               0.5])]
    vals = [torch.tensor([10, 20, 30, 40]) + k for k in range(4)]
    k, v = t_wide._sort4(keys, vals)
    jk, jv = j_wide._sort4([jnp.asarray(np_(x)) for x in keys],
                           [jnp.asarray(np_(x)) for x in vals])
    for a, b in zip(k, jk):
        assert np.array_equal(np_(a), np.asarray(b))
    for a, b in zip(v, jv):
        assert np.array_equal(np_(a), np.asarray(b))


def test_blas_bounds_flush_denormals_as_jax():
    """The LBVH's AABBs over coordinates below 2^-126: the reference's
    min/max reductions flush them to zero (T9), and so does the port, so
    the node rows are JAX's bit for bit (ROADMAP F6)."""
    x = (2.0 ** -np.arange(120, 136, dtype=np.float64)).astype(np.float32)
    base = np.stack([x, -x, np.zeros_like(x)], -1)[:, None]
    offs = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]])[None]
    v = (base + offs).astype(np.float32)
    jb = j_build_blas(rc.Triangle.create(jnp.asarray(v)))
    tb = rt.build_blas(rt.Triangle.create(torch.as_tensor(v)))
    assert np.array_equal(np.asarray(jb.nodes), np_(tb.nodes))
    assert np.array_equal(bits(jb.root_aabb), bits(tb.root_aabb))
