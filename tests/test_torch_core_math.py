"""Parity of the port's core math with the JAX package, on the CPU: boxes
(core/bounds.py), transforms and quaternions (core/transforms.py), ray
helpers (core/ray.py), the triangle helpers and the watertight test
(core/triangle.py), ``build_triangle``/``is_degenerate_face`` and
``any_hit_brute``.

The first tests are twins of tests/test_bounds.py and
tests/test_intersection.py: each runs the same case in both packages,
holds the port to the JAX package's result and keeps the original's
assertions. Inputs are NumPy arrays, drawn from a seed where they are
random. Tolerances:
- boxes and ray helpers: exactly equal;
- transforms: rtol 1e-5, atol 1e-6 (a matrix inverse or a cosine may
  round differently);
- the watertight test: equal hit masks on rays kept 1e-4 in barycentric
  from every edge, t and barycentrics within rtol 1e-5;
- ``any_hit_brute``: equal hit and prim.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.core import bounds as JB
from raycore_tpu.core import ray as JR
from raycore_tpu.core import transforms as JT
from raycore_tpu.core import triangle as JTri
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch import convert
from raycore_tpu_torch.core import bounds as TB
from raycore_tpu_torch.core import ray as TR
from raycore_tpu_torch.core import transforms as TT
from raycore_tpu_torch.core import triangle as TTri
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_parity import CPU, np_

INF = float("inf")


def T(x, dtype=torch.float32):
    """A NumPy array, list or JAX array as a CPU tensor."""
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def same(j, t):
    """Exactly equal values (+0 and -0 alike, NaN where NaN)."""
    a, b = np.asarray(j), np_(t)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(b, a)


def close(j, t, rtol=1e-5, atol=1e-6):
    a, b = np.asarray(j), np_(t)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def tb3(jb):
    """The port's twin of a JAX box."""
    return convert.bounds_from_numpy(np.asarray(jb.p_min),
                                     np.asarray(jb.p_max), device=CPU)


def same_box(jb, tb):
    same(jb.p_min, tb.p_min)
    same(jb.p_max, tb.p_max)


# --- twins of tests/test_bounds.py -------------------------------------------

def test_empty_default_invalid():
    jb, tb = rc.Bounds3.empty(), TB.Bounds3.empty(device=CPU)
    same_box(jb, tb)
    assert not bool(TB.is_valid(tb)) and not bool(JB.is_valid(jb))
    same_box(rc.Bounds3.empty((2, 4)), TB.Bounds3.empty((2, 4), device=CPU))


def test_from_points_sorts():
    jb = rc.Bounds3.from_points([1, 5, 3], [4, 2, 6])
    tb = TB.Bounds3.from_points([1, 5, 3], [4, 2, 6], device=CPU)
    same_box(jb, tb)
    np.testing.assert_allclose(np_(tb.p_min), [1, 2, 3])
    np.testing.assert_allclose(np_(tb.p_max), [4, 5, 6])
    same_box(rc.Bounds3.from_point([1, -2, 3]),
             TB.Bounds3.from_point(T([1, -2, 3])))


def test_union_box_box_and_point():
    pts = ([0, 0, 0], [1, 1, 1], [2, -1, 0.5], [3, 0.5, 2])
    ja, jb = (rc.Bounds3.from_points(*pts[:2]),
              rc.Bounds3.from_points(*pts[2:]))
    ta, tb = (TB.Bounds3.from_points(*pts[:2], device=CPU),
              TB.Bounds3.from_points(*pts[2:], device=CPU))
    same_box(JB.union(ja, jb), TB.union(ta, tb))
    np.testing.assert_allclose(np_(TB.union(ta, tb).p_min), [0, -1, 0])
    p = [5.0, 0.5, -2.0]
    same_box(JB.union(ja, jnp.array(p)), TB.union(ta, T(p)))
    np.testing.assert_allclose(np_(TB.union(ta, T(p)).p_max), [5, 1, 1])
    e = TB.union(TB.Bounds3.empty(device=CPU), ta)      # the identity
    same_box(JB.union(rc.Bounds3.empty(), ja), e)
    same_box(ja, e)


def test_intersect_overlaps_inside():
    ja = rc.Bounds3.from_points([0, 0, 0], [2, 2, 2])
    jb = rc.Bounds3.from_points([1, 1, 1], [3, 3, 3])
    jc = rc.Bounds3.from_points([5, 5, 5], [6, 6, 6])
    ta, tb, tc = tb3(ja), tb3(jb), tb3(jc)
    same_box(JB.intersect_bounds(ja, jb), TB.intersect_bounds(ta, tb))
    assert bool(TB.overlaps(ta, tb)) and not bool(TB.overlaps(ta, tc))
    same(JB.overlaps(ja, jc), TB.overlaps(ta, tc))
    for p in ([1, 1, 1], [2, 2, 2], [3, 0, 0]):
        same(JB.inside(ja, p), TB.inside(ta, p))
        same(JB.inside_exclusive(ja, p), TB.inside_exclusive(ta, p))
    assert bool(TB.inside(ta, [2, 2, 2]))                # inclusive upper
    assert not bool(TB.inside_exclusive(ta, [2, 2, 2]))


def test_geometry_queries():
    jb = rc.Bounds3.from_points([0, 0, 0], [2, 3, 4])
    tb = tb3(jb)
    same(JB.diagonal(jb), TB.diagonal(tb))
    same(JB.surface_area(jb), TB.surface_area(tb))
    assert float(TB.surface_area(tb)) == pytest.approx(2 * (6 + 8 + 12))
    same(JB.volume(jb), TB.volume(tb))
    assert int(TB.maximum_extent(tb)) == int(JB.maximum_extent(jb)) == 2
    h = [0.5, 0.5, 0.5]
    same(JB.lerp(jb, jnp.array(h)), TB.lerp(tb, T(h)))
    same(JB.offset(jb, [1, 1.5, 2]), TB.offset(tb, [1, 1.5, 2]))
    np.testing.assert_allclose(np_(TB.offset(tb, [1, 1.5, 2])), h)
    same_box(JB.expand(jb, 1.0), TB.expand(tb, 1.0))


def test_corners():
    jb = rc.Bounds3.from_points([0, 0, 0], [1, 2, 3])
    tb = tb3(jb)
    same(JB.corners(jb), TB.corners(tb))
    assert TB.corners(tb).shape == (8, 3)
    for c in range(8):
        same(JB.corner(jb, c), TB.corner(tb, c))
    np.testing.assert_allclose(np_(TB.corner(tb, 6)), [0, 2, 3])


def test_bounding_sphere():
    jb = rc.Bounds3.from_points([-1, -1, -1], [1, 1, 1])
    (jc, jr), (tc, tr) = JB.bounding_sphere(jb), TB.bounding_sphere(tb3(jb))
    same(jc, tc)
    same(jr, tr)
    assert float(tr) == pytest.approx(np.sqrt(3), rel=1e-6)
    _, r0 = TB.bounding_sphere(TB.Bounds3.empty(device=CPU))
    assert float(r0) == 0.0


def test_ray_slab_hit_miss():
    jb = rc.Bounds3.from_points([-1, -1, -1], [1, 1, 1])
    tb = tb3(jb)
    cases = (([0, 0, -5.0], [0, 0, 1.0], INF, True),
             ([0, 0, -5.0], [0, 0, -1.0], INF, False),
             ([0, 0, 0.0], [0, 0, 1.0], INF, True),      # origin inside
             ([0, 0, -5.0], [0, 0, 1.0], 3.0, False))    # t_max clips
    for o, d, t_max, want in cases:
        jr = JB.intersect_ray(jb, jnp.array(o), jnp.array(d), t_max)
        tr = TB.intersect_ray(tb, T(o), T(d), t_max)
        for a, b in zip(jr, tr):
            same(a, b)
        assert bool(tr[0]) == want
    _, t0, t1 = TB.intersect_ray(tb, T([0, 0, -5.0]), T([0, 0, 1.0]), INF)
    assert float(t0) == pytest.approx(4.0) and float(t1) == pytest.approx(6)


def test_intersect_p_precomputed():
    jb = rc.Bounds3.from_points([-1, -1, -1], [1, 1, 1])
    tb = tb3(jb)
    inv_z = 1.0 / np.array([0.0, 0, 1.0], np.float32)
    inv_tiny = 1.0 / np.array([1e-20, 1e-20, -1.0], np.float32)
    cases = (([0.0, 0, -5], INF, inv_z, True),
             ([0.0, 0, -5], 3.0, inv_z, False),
             ([0.0, 0, 5], INF, inv_tiny, True))
    for o, t_max, inv, want in cases:
        got = TB.intersect_p(tb, T(o), t_max, T(inv))
        same(JB.intersect_p(jb, jnp.array(o), t_max, jnp.asarray(inv)), got)
        assert bool(got) == want


def _bbox_pair(o, d, p_min, p_max, t_min, t_max):
    jinv = rc.safe_invdir(jnp.array(d, jnp.float32))
    tinv = TTri.safe_invdir(T(d))
    same(jinv, tinv)
    j = JB.fast_intersect_bbox(jnp.array(o, jnp.float32), jinv,
                               jnp.array(p_min, jnp.float32),
                               jnp.array(p_max, jnp.float32), t_min, t_max)
    t = TB.fast_intersect_bbox(T(o), tinv, T(p_min), T(p_max), t_min, t_max)
    same(j[0], t[0])
    same(j[1], t[1])
    return float(t[0]), float(t[1])


def test_fast_intersect_bbox_matches_reference_form():
    lo, hi = _bbox_pair([0, 0, -5.0], [0, 0, 1.0], [-1, -1, -1], [1, 1, 1],
                        0.0, INF)
    assert lo == pytest.approx(4.0) and hi == pytest.approx(6.0)
    lo2, hi2 = _bbox_pair([0, 0, -5.0], [0, 0, 1.0], [-1, -1, 10],
                          [1, 1, 12], 0.0, 5.0)
    assert lo2 > hi2                                  # t_max clips


def test_fast_intersect_bbox_clamped_axis_outside_keeps_far_hit():
    lo, hi = _bbox_pair([0, 0, 0.0], [1e-6, 1.0, 0.0], [1.0, 0.0, -1.0],
                        [2.0, 3e6, 1.0], 0.0, INF)
    assert lo <= hi


def test_fast_intersect_bbox_genuine_near_parallel_not_misflagged():
    assert float(TTri.safe_invdir(T([1.005e-5]))[0].abs()) < 1.0 / 1e-5
    lo, hi = _bbox_pair([0, 0, 0.0], [1.005e-5, 1.0, 0.0], [1.0, 0.0, -1.0],
                        [2.0, 3e6, 1.0], 0.0, INF)
    assert lo <= hi and lo == pytest.approx(1.0 / 1.005e-5, rel=1e-3)


def test_bounds2():
    jb = rc.Bounds2.from_points([0, 0], [2, 4])
    tb = TB.Bounds2.from_points([0, 0], [2, 4], device=CPU)
    same_box(jb, tb)
    same(JB.diagonal(jb), TB.diagonal(tb))
    same(JB.area(jb), TB.area(tb))
    assert float(TB.area(tb)) == pytest.approx(8.0)
    e = TB.Bounds2.empty(device=CPU)
    same_box(rc.Bounds2.empty(), e)
    assert not bool(TB.is_valid(e))
    assert isinstance(convert.bounds_from_numpy([0, 0], [1, 1], device=CPU),
                      TB.Bounds2)


def test_batched_ops():
    pmin = np.zeros((5, 3), np.float32)
    pmax = np.ones((5, 3), np.float32) * np.arange(1, 6, dtype=np.float32)[
        :, None]
    jb, tb = rc.Bounds3(p_min=jnp.asarray(pmin), p_max=jnp.asarray(pmax)), \
        convert.bounds_from_numpy(pmin, pmax, device=CPU)
    sa = TB.surface_area(tb)
    assert sa.shape == (5,)
    same(JB.surface_area(jb), sa)
    np.testing.assert_allclose(np_(sa), 6 * np.arange(1, 6.0) ** 2,
                               rtol=1e-6)


def test_box_ops_on_random_boxes():
    """Every box operation on seeded random boxes, points and rays,
    batched: exactly the JAX package's values."""
    rng = np.random.default_rng(11)
    n = 257
    a, b = rng.normal(size=(2, n, 3)).astype(np.float32)
    c, e = rng.normal(size=(2, n, 3)).astype(np.float32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    o = (3 * rng.normal(size=(n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::5, 0] = 0.0
    d[1::5, 1] = -0.0
    d[2::5, 2] = 3e-6
    tmax = rng.uniform(0.5, 8, n).astype(np.float32)
    ja, jc = rc.Bounds3.from_points(a, b), rc.Bounds3.from_points(c, e)
    ta = TB.Bounds3.from_points(T(a), T(b))
    tc = TB.Bounds3.from_points(T(c), T(e))
    same_box(ja, ta)
    same_box(JB.union(ja, jc), TB.union(ta, tc))
    same_box(JB.union(ja, p), TB.union(ta, T(p)))
    same_box(JB.intersect_bounds(ja, jc), TB.intersect_bounds(ta, tc))
    same_box(JB.expand(ja, 0.25), TB.expand(ta, 0.25))
    for jf, tf in ((JB.overlaps, TB.overlaps),):
        same(jf(ja, jc), tf(ta, tc))
    for jf, tf in ((JB.inside, TB.inside),
                   (JB.inside_exclusive, TB.inside_exclusive),
                   (JB.offset, TB.offset), (JB.lerp, TB.lerp)):
        same(jf(ja, p), tf(ta, T(p)))
    for jf, tf in ((JB.diagonal, TB.diagonal),
                   (JB.surface_area, TB.surface_area),
                   (JB.volume, TB.volume), (JB.corners, TB.corners),
                   (JB.is_valid, TB.is_valid)):
        same(jf(ja), tf(ta))
    same(JB.maximum_extent(ja).astype(np.int64), TB.maximum_extent(ta))
    cs = rng.integers(0, 8, n)
    same(JB.corner(ja, cs), TB.corner(ta, T(cs, torch.int32)))
    for x, y in zip(JB.bounding_sphere(ja), TB.bounding_sphere(ta)):
        same(x, y)
    for x, y in zip(JB.intersect_ray(ja, o, d, tmax),
                    TB.intersect_ray(ta, T(o), T(d), T(tmax))):
        same(x, y)
    inv = np.asarray(rc.safe_invdir(jnp.asarray(d)))
    same(JB.intersect_p(ja, o, tmax, inv),
         TB.intersect_p(ta, T(o), T(tmax), T(inv)))
    for x, y in zip(JB.fast_intersect_bbox(o, inv, ja.p_min, ja.p_max, 0.1,
                                           tmax),
                    TB.fast_intersect_bbox(T(o), T(inv), ta.p_min, ta.p_max,
                                           0.1, T(tmax))):
        same(x, y)


# --- ray helpers -------------------------------------------------------------

def test_ray_helpers_and_differentials():
    rng = np.random.default_rng(12)
    o, d, rx, ry, dx, dy = rng.normal(size=(6, 64, 3)).astype(np.float32)
    d[::3, 1] = -0.0
    t = rng.uniform(0, 4, 64).astype(np.float32)
    s = rng.uniform(0.1, 2, 64).astype(np.float32)
    jr, tr = rc.Ray.create(o=o, d=d), rt.Ray.create(T(o), T(d))
    jc, tc = JR.check_direction(jr), TR.check_direction(tr)
    same(jc.d, tc.d)
    assert not np.signbit(np_(tc.d)[::3, 1]).any()
    same(JR.set_direction(jr, -d).d, TR.set_direction(tr, T(-d)).d)
    same(JR.apply(jr, t), TR.apply(tr, T(t)))
    same(JR.increase_hit(jr, t).t_max, TR.increase_hit(tr, T(t)).t_max)
    jd = JR.RayDifferentials.create(o, d, t_max=5.0, has_differentials=True,
                                    rx_origin=rx, ry_origin=ry,
                                    rx_direction=dx, ry_direction=dy)
    td = TR.RayDifferentials.create(T(o), T(d), t_max=5.0,
                                    has_differentials=True, rx_origin=T(rx),
                                    ry_origin=T(ry), rx_direction=T(dx),
                                    ry_direction=T(dy))
    js, ts = JR.scale_differentials(jd, s), TR.scale_differentials(td, T(s))
    for f in ("o", "d", "t_max", "time", "has_differentials", "rx_origin",
              "ry_origin", "rx_direction", "ry_direction"):
        same(getattr(jd, f), getattr(td, f))
        same(getattr(js, f), getattr(ts, f))
    jf, tf = JR.RayDifferentials.from_ray(jr), TR.RayDifferentials.from_ray(
        tr)
    same(jf.rx_origin, tf.rx_origin)
    same(jf.as_ray().t_max, tf.as_ray().t_max)
    # A differential ray made from lists goes to the device it is given.
    lst = TR.RayDifferentials.create([0.0, 0, 1], [0.0, 0, -1], device=CPU)
    assert lst.o.device.type == "cpu" and lst.rx_origin.shape == (3,)


# --- transforms --------------------------------------------------------------

def _transform_cases():
    """Seeded (name, JAX transform, port transform) triples covering every
    constructor."""
    rng = np.random.default_rng(13)
    delta = rng.normal(size=(5, 3)).astype(np.float32)
    sc = rng.uniform(0.5, 2, (5, 3)).astype(np.float32)
    ang = rng.uniform(-180, 180, 5).astype(np.float32)
    axis = rng.normal(size=(5, 3)).astype(np.float32)
    pos, tgt = rng.normal(size=(2, 3)).astype(np.float32)
    up = np.array([0, 1, 0], np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32) + 3 * np.eye(
        4, dtype=np.float32)
    return [
        ("identity", rc.Transformation.identity((2,)),
         TT.Transformation.identity((2,), device=CPU)),
        ("translate", JT.translate(delta), TT.translate(T(delta))),
        ("scale", JT.scale(sc), TT.scale(T(sc))),
        ("scale_scalar", JT.scale(2.5), TT.scale(2.5, device=CPU)),
        ("rotate_x", JT.rotate_x(ang), TT.rotate_x(T(ang))),
        ("rotate_y", JT.rotate_y(ang), TT.rotate_y(T(ang))),
        ("rotate_z", JT.rotate_z(ang), TT.rotate_z(T(ang))),
        ("rotate", JT.rotate(ang, axis), TT.rotate(T(ang), T(axis))),
        ("look_at", JT.look_at(pos, tgt, up),
         TT.look_at(T(pos), T(tgt), T(up))),
        ("perspective", JT.perspective(60.0, 0.1, 100.0),
         TT.perspective(60.0, 0.1, 100.0, device=CPU)),
        ("from_matrix", JT.Transformation.from_matrix(m),
         TT.Transformation.from_matrix(T(m))),
        ("compose", JT.translate(delta[0]).compose(JT.rotate(ang[0],
                                                             axis[0])),
         TT.translate(T(delta[0])) @ TT.rotate(T(ang[0]), T(axis[0]))),
    ]


@pytest.mark.parametrize("case", range(12))
def test_transforms_match_jax(case):
    name, jt, tt = _transform_cases()[case]
    close(jt.m, tt.m)
    close(jt.m_inv, tt.m_inv)
    for jx, tx in ((jt.inverse(), tt.inverse()),
                   (jt.transpose(), tt.transpose())):
        close(jx.m, tx.m)
        close(jx.m_inv, tx.m_inv)
    rng = np.random.default_rng(14 + case)
    batch = tuple(np.asarray(jt.m).shape[:-2])
    p, v, n = rng.normal(size=(3,) + batch + (3,)).astype(np.float32)
    close(jt.apply_point(p), tt.apply_point(T(p)))
    close(jt.apply_vector(v), tt.apply_vector(T(v)))
    close(jt.apply_normal(n), tt.apply_normal(T(n)))
    # Boxes go through one transform (a batched transform's first).
    first = (lambda x: x.reshape(-1, 4, 4)[0]) if batch else (lambda x: x)
    jt0 = JT.Transformation(m=first(jt.m), m_inv=first(jt.m_inv))
    tt0 = TT.Transformation(m=first(tt.m), m_inv=first(tt.m_inv))
    jb = rc.Bounds3.from_points(p.reshape(-1, 3), (p + np.abs(v)).reshape(
        -1, 3))
    close(jt0(jb).p_min, tt0(tb3(jb)).p_min, atol=1e-5)
    close(jt0(jb).p_max, tt0(tb3(jb)).p_max, atol=1e-5)
    jr = jt(rc.Ray.create(o=p, d=v))
    trr = tt(rt.Ray.create(T(p), T(v)))
    close(jr.o, trr.o)
    close(jr.d, trr.d)
    same(JT.has_scale(jt), TT.has_scale(tt))
    same(JT.is_identity(jt), TT.is_identity(tt))
    if name != "perspective":
        same(JT.swaps_handedness(jt), TT.swaps_handedness(tt))
    # The port's twin of the JAX transform carries over as NumPy.
    conv = convert.transformation_from_numpy(np.asarray(jt.m),
                                             np.asarray(jt.m_inv),
                                             device=CPU)
    same(jt.m, conv.m)


def test_ray_differentials_transform_and_handedness():
    rng = np.random.default_rng(15)
    o, d, rx, dx = rng.normal(size=(4, 8, 3)).astype(np.float32)
    jt = JT.rotate(33.0, [1.0, 2.0, 3.0]).compose(JT.scale([1.0, -2.0, 1]))
    tt = TT.rotate(33.0, [1.0, 2.0, 3.0], device=CPU).compose(
        TT.scale([1.0, -2.0, 1], device=CPU))
    jd = jt(JR.RayDifferentials.create(o, d, rx_origin=rx, rx_direction=dx))
    td = tt(TR.RayDifferentials.create(T(o), T(d), rx_origin=T(rx),
                                       rx_direction=T(dx)))
    for f in ("o", "d", "rx_origin", "ry_origin", "rx_direction",
              "ry_direction"):
        close(getattr(jd, f), getattr(td, f))
    assert bool(TT.swaps_handedness(tt)) and bool(JT.swaps_handedness(jt))
    assert bool(TT.has_scale(tt))


def test_quaternions_and_slerp_match_jax():
    rng = np.random.default_rng(16)
    ang = rng.uniform(-179, 179, 16).astype(np.float32)
    axis = rng.normal(size=(16, 3)).astype(np.float32)
    # Rotations about each axis reach every branch of the extraction.
    jts = [JT.rotate(ang, axis), JT.rotate_x(ang), JT.rotate_y(ang),
           JT.rotate_z(ang)]
    tts = [TT.rotate(T(ang), T(axis)), TT.rotate_x(T(ang)),
           TT.rotate_y(T(ang)), TT.rotate_z(T(ang))]
    for jt, tt in zip(jts, tts):
        jq = JT.Quaternion.from_transformation(jt)
        tq = TT.Quaternion.from_transformation(tt)
        close(jq.v, tq.v, atol=1e-5)
        close(jq.w, tq.w, atol=1e-5)
        close(jq.to_transformation().m, tq.to_transformation().m, atol=1e-5)
        close(jq.normalize().v, tq.normalize().v, atol=1e-5)
    jq = [JT.Quaternion.from_transformation(x) for x in jts[:2]]
    tq = [TT.Quaternion.from_transformation(x) for x in tts[:2]]
    t = rng.uniform(0, 1, 16).astype(np.float32)
    close(JT.dot(*jq), TT.dot(*tq), atol=1e-5)
    js, ts = JT.slerp(t, *jq), TT.slerp(T(t), *tq)
    close(js.v, ts.v, atol=1e-5)
    close(js.w, ts.w, atol=1e-5)
    # The lerp branch: nearly equal rotations.
    jn = JT.Quaternion.from_transformation(JT.rotate(ang + 0.5, axis))
    tn = TT.Quaternion.from_transformation(TT.rotate(T(ang + 0.5), T(axis)))
    js2, ts2 = JT.slerp(t, jq[0], jn), TT.slerp(T(t), tq[0], tn)
    close(js2.v, ts2.v, atol=1e-5)
    close(js2.w, ts2.w, atol=1e-5)
    ident = TT.Quaternion.identity((3,), device=CPU)
    same(JT.Quaternion.identity((3,)).w, ident.w)
    same(JT.Quaternion.identity((3,)).v, ident.v)


def test_mat3x4_helpers_match_jax():
    rng = np.random.default_rng(17)
    m4 = np.asarray(JT.rotate(rng.uniform(-90, 90, 6).astype(np.float32),
                              rng.normal(size=(6, 3)).astype(np.float32)).m)
    m4 = m4.copy()
    m4[:, :3, 3] = rng.normal(size=(6, 3))
    m4[:, :3, :3] *= rng.uniform(0.5, 2, (6, 1, 1)).astype(np.float32)
    p, v = rng.normal(size=(2, 6, 3)).astype(np.float32)
    j34, t34 = JT.mat4_to_mat3x4(m4), TT.mat4_to_mat3x4(T(m4))
    same(j34, t34)
    close(JT.mat3x4_inverse(j34), TT.mat3x4_inverse(t34))
    close(JT.transform_point_3x4(j34, p), TT.transform_point_3x4(t34, T(p)))
    close(JT.transform_direction_3x4(j34, v),
          TT.transform_direction_3x4(t34, T(v)))
    same(JT.mat3x4_identity((2,)), TT.mat3x4_identity((2,), device=CPU))


# --- twins of tests/test_intersection.py -------------------------------------

def test_watertight_hit_t_bary():
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    o, d = [0.25, 0.25, -3.0], [0, 0, 1.0]
    jh, jt, jb = JTri.intersect_triangle(tri, jnp.array(o), jnp.array(d),
                                         jnp.inf)
    th, tt, tb = TTri.intersect_triangle(T(tri), T(o), T(d), INF)
    same(jh, th)
    close(jt, tt)
    close(jb, tb)
    assert bool(th) and float(tt) == pytest.approx(3.0, rel=1e-6)
    np.testing.assert_allclose(np_(tb) @ tri, [0.25, 0.25, 0.0], atol=1e-6)


def test_watertight_miss_outside_and_behind():
    tri = T([[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    for o, d, t_max in (([2.0, 2, -1], [0, 0, 1.0], INF),
                        ([0.25, 0.25, -1], [0, 0, -1.0], INF),
                        ([0.25, 0.25, -10], [0, 0, 1.0], 5.0)):
        th, tt, tb = TTri.intersect_triangle(tri, T(o), T(d), t_max)
        jh = JTri.intersect_triangle(np_(tri), jnp.array(o), jnp.array(d),
                                     t_max)[0]
        same(jh, th)
        assert not bool(th) and float(tt) == 0.0 and not bool(tb.any())


def test_watertight_degenerate_rejected():
    tri = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    assert bool(TTri.is_degenerate(T(tri)))
    same(JTri.is_degenerate(tri), TTri.is_degenerate(T(tri)))
    th, _, _ = TTri.intersect_triangle(T(tri), T([0.5, 0.0, -1.0]),
                                       T([0.0, 0, 1.0]), INF)
    assert not bool(th)


def _random_tris(rng, n):
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(0.1, 1, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, -0.1, (n, 3)).astype(np.float32)
    return v0, v1, v2


def test_moller_trumbore_matches_watertight_on_clean_hits(rng):
    v0, v1, v2 = _random_tris(rng, 256)
    o, d = T([0, 0, -5]), T([0.01, 0.02, 1.0])
    hw, tw, _ = TTri.intersect_triangle(T(np.stack([v0, v1, v2], 1)), o, d,
                                        INF)
    hm, tm, _, _ = TTri.fast_intersect_triangle(o, d, T(v0), T(v1), T(v2),
                                                0.0, INF)
    assert torch.equal(hw, hm)
    np.testing.assert_allclose(np_(tw)[np_(hw)], np_(tm)[np_(hm)],
                               rtol=1e-4, atol=1e-5)
    jw = JTri.intersect_triangle(np.stack([v0, v1, v2], 1), np_(o), np_(d),
                                 jnp.inf)
    same(jw[0], hw)
    close(jw[1], tw)


def test_watertight_random_rays_match_jax():
    """Seeded rays against seeded triangles: equal hit masks where the
    ray passes at least 1e-4 in barycentric from every edge; t and
    barycentrics within rtol 1e-5."""
    rng = np.random.default_rng(18)
    n = 4096
    v0, v1, v2 = _random_tris(rng, n)
    verts = np.stack([v0, v1, v2], 1)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::4] = verts[::4].mean(1) - o[::4]          # a quarter aimed inside
    d[::7, 1] = 0.0
    t_max = rng.uniform(0.5, 10, n).astype(np.float32)
    jh, jt, jb = (np.asarray(x) for x in JTri.intersect_triangle(
        verts, o, d, t_max))
    th, tt, tb = TTri.intersect_triangle(T(verts), T(o), T(d), T(t_max))
    # Exact barycentrics of each ray's plane crossing, in float64.
    e1, e2 = (verts[:, 1] - verts[:, 0]).astype(np.float64), \
        (verts[:, 2] - verts[:, 0]).astype(np.float64)
    s1 = np.cross(d.astype(np.float64), e2)
    det = (s1 * e1).sum(1)
    dv = o - verts[:, 0].astype(np.float64)
    u = (dv * s1).sum(1) / det
    v = (d * np.cross(dv, e1)).sum(1) / det
    away = np.minimum(np.minimum(np.abs(u), np.abs(v)),
                      np.abs(1 - u - v)) > 1e-4
    assert jh[away].sum() > 200
    assert np.array_equal(np_(th)[away], jh[away])
    both = np_(th) & jh
    np.testing.assert_allclose(np_(tt)[both], jt[both], rtol=1e-5)
    np.testing.assert_allclose(np_(tb)[both], jb[both], rtol=1e-5,
                               atol=1e-6)
    jray = rc.Ray.create(o=o, d=d, t_max=t_max)
    tray = rt.Ray.create(T(o), T(d), t_max=T(t_max))
    jtri, ttri = rc.Triangle.create(verts), rt.Triangle.create(T(verts))
    same(JTri.intersect(jtri, jray)[0][away], np_(
        TTri.intersect(ttri, tray)[0])[away])
    same(JTri.intersect_p(jtri, jray)[away], np_(
        TTri.intersect_p(ttri, tray))[away])


def test_mt_t_range_semantics():
    z3 = lambda *x: T(list(x))
    v0, v1, v2 = z3(0.0, 0, 0), z3(1.0, 0, 0), z3(0.0, 1, 0)
    o, d = z3(0.2, 0.2, -2.0), z3(0.0, 0, 1.0)
    hit, t, u, v = TTri.fast_intersect_triangle(o, d, v0, v1, v2, 0.0, INF)
    assert bool(hit) and float(t) == pytest.approx(2.0)
    assert float(u) == pytest.approx(0.2) and float(v) == pytest.approx(0.2)
    for t_min, t_max, want in ((2.5, INF, False), (2.0, INF, True),
                               (0.0, 1.9, False)):
        got = TTri.fast_intersect_triangle(o, d, v0, v1, v2, t_min, t_max)
        ref = JTri.fast_intersect_triangle(*(jnp.asarray(np_(x)) for x in
                                             (o, d, v0, v1, v2)),
                                           t_min, t_max)
        for a, b in zip(ref, got):
            same(a, b)
        assert bool(got[0]) == want


def test_mt_zero_triangle_sentinel_misses():
    z = torch.zeros(3)
    hit, t, u, v = TTri.fast_intersect_triangle(T([0.3, 0.3, -5.0]),
                                                T([0.0, 0, 1.0]), z, z, z,
                                                0.0, INF)
    assert not bool(hit)
    assert float(t) == 0.0 and float(u) == 0.0 and float(v) == 0.0


def test_safe_invdir():
    """Bit for bit with JAX at the clamp: +-float32(1e-5) and both
    neighbours of each, +-0, subnormals of both signs."""
    eps = np.float32(1e-5)
    near = [np.nextafter(eps, np.float32(0)), eps,
            np.nextafter(eps, np.float32(1))]
    edge = np.array(near + [-x for x in near]
                    + [np.float32(1e-40), np.float32(-1e-40),
                       np.float32(2.0 ** -149), np.float32(-(2.0 ** -149))],
                    np.float32)
    assert (np.abs(edge[-4:]) < np.finfo(np.float32).tiny).all()
    for x in ([0.0, -0.0, 2.0], [1e-6, -1e-6, -3.0], edge):
        x = np.asarray(x, np.float32)
        j = np.asarray(rc.safe_invdir(jnp.asarray(x)))
        t = np_(TTri.safe_invdir(torch.as_tensor(x)))
        assert np.array_equal(j.view(np.int32), t.view(np.int32)), (x, j, t)
    inv = np_(TTri.safe_invdir(T([0.0, -0.0, 2.0])))
    assert inv[0] == pytest.approx(1e5) and inv[1] == pytest.approx(-1e5)
    assert inv[2] == pytest.approx(0.5)


def test_empty_triangle_sentinel():
    je, te = rc.empty_triangle(), TTri.empty_triangle(device=CPU)
    for f in ("vertices", "normals", "tangents", "uv", "metadata"):
        same(getattr(je, f), getattr(te, f))
    assert int(te.metadata) == 0
    tb = TTri.empty_triangle((4, 2), metadata=torch.arange(8).reshape(4, 2))
    assert tb.vertices.shape == (4, 2, 3, 3) and int(tb.metadata[3, 1]) == 7


def test_brute_force_closest_hit_sphere():
    kw = dict(center=(0, 0, 0), radius=1.0, n_theta=24, n_phi=48)
    jtris, ttris = rc.sphere_mesh(**kw), t_mesh.sphere_mesh(**kw, device=CPU)
    for o in ([0.05, 0.02, -4.0], [0.05, 5, -4.0]):
        ref = rc.closest_hit_brute(jtris, rc.Ray.create(o=o, d=[0, 0, 1.0]))
        got = rt.closest_hit_brute(ttris, rt.Ray.create(o, [0, 0, 1.0],
                                                        device=CPU))
        same(ref.hit, got.hit)
        same(ref.prim_idx, got.prim_idx)
        close(ref.t, got.t)
        close(ref.barycentric, got.barycentric)
    assert not bool(got.hit) and int(got.prim_idx) == -1


def test_brute_force_grid_batch():
    """closest_hit_brute and any_hit_brute on a grid of rays, with a
    t_min that any_hit must ignore: equal hit and prim against the
    compiled JAX function, whose dots are fused multiply-add chains as
    the port's are (tests/test_torch_core.py); the grid puts rays exactly
    on the sphere's shared edges."""
    kw = dict(radius=1.0, n_theta=16, n_phi=32)
    jtris, ttris = rc.sphere_mesh(**kw), t_mesh.sphere_mesh(**kw, device=CPU)
    xs = np.linspace(-2, 2, 32, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    o = np.stack([X, Y, np.full_like(X, -4.0)], -1)
    d = np.broadcast_to(np.array([0.0, 0, 1.0], np.float32), o.shape)
    jr = rc.Ray.create(o=o, d=d, t_min=3.5)
    tr = rt.Ray.create(T(o), T(np.ascontiguousarray(d)), t_min=3.5)
    res = rt.closest_hit_brute(ttris, tr)
    occ = rt.any_hit_brute(ttris, tr)
    jocc = jax.jit(rc.any_hit_brute)(jtris, jr)
    same(jocc.hit, occ.hit)
    same(jocc.prim_idx, occ.prim_idx)
    assert occ.hit.shape == (32, 32)
    assert 0.1 < float(occ.hit.float().mean()) < 0.3
    # t_min = 3.5 hides the near side from closest_hit, not from any_hit.
    assert bool((occ.hit >= res.hit).all()) and bool((occ.hit
                                                      != res.hit).any())


def test_area_and_normals():
    rng = np.random.default_rng(19)
    verts = np.concatenate([
        np.array([[[0, 0, 0], [2, 0, 0], [0, 2, 0]],
                  [[0, 0, 0], [1, 0, 0], [2, 0, 0]]], np.float32),
        rng.normal(size=(62, 3, 3)).astype(np.float32)])
    jt, tt = rc.Triangle.create(verts), rt.Triangle.create(T(verts))
    same(JTri.area(jt), TTri.area(tt))
    same(JTri.normal(jt), TTri.normal(tt))
    same(JTri.is_degenerate(verts), TTri.is_degenerate(T(verts)))
    assert float(TTri.area(tt)[0]) == pytest.approx(2.0)
    np.testing.assert_allclose(np_(TTri.normal(tt))[0], [0, 0, 1], atol=1e-6)
    for jf, tf in ((JTri.object_bound, TTri.object_bound),
                   (JTri.world_bound, TTri.world_bound)):
        same_box(jf(jt), tf(tt))


def test_partial_derivatives_fallback():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    for u in (uv, np.zeros((3, 2), np.float32)):
        for a, b in zip(JTri.partial_derivatives(verts, u),
                        TTri.partial_derivatives(T(verts), T(u))):
            same(a, b)
    du, dv, _, _ = TTri.partial_derivatives(T(verts), T(uv))
    np.testing.assert_allclose(np_(du), [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(np_(dv), [0, 1, 0], atol=1e-6)
    du, dv, _, _ = TTri.partial_derivatives(T(verts), torch.zeros(3, 2))
    assert abs(float(du[2])) < 1e-6 and abs(float(dv[2])) < 1e-6


def test_shading_helpers_on_random_triangles():
    """partial_derivatives, normal_derivatives and bary_interp on seeded
    triangles (some with degenerate uv and NaN normals)."""
    rng = np.random.default_rng(20)
    n = 128
    verts, normals = rng.normal(size=(2, n, 3, 3)).astype(np.float32)
    uv = rng.uniform(size=(n, 3, 2)).astype(np.float32)
    uv[::5] = 0.0
    normals[::7] = np.nan
    bary = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    for a, b in zip(JTri.partial_derivatives(verts, uv),
                    TTri.partial_derivatives(T(verts), T(uv))):
        close(a, b)
    jt = rc.Triangle.create(verts, normals=normals, uv=uv)
    tt = rt.Triangle.create(T(verts), normals=T(normals), uv=T(uv))
    for a, b in zip(JTri.normal_derivatives(jt),
                    TTri.normal_derivatives(tt)):
        close(a, b)
    same(JTri.bary_interp(bary, verts), TTri.bary_interp(T(bary), T(verts)))


# --- meshes, conversion and devices ------------------------------------------

def test_build_triangle_and_degenerate_face():
    jt = j_mesh.build_triangle([0, 0, 0], [1, 0, 0], [0, 1, 0], metadata=7)
    tt = t_mesh.build_triangle([0, 0, 0], [1, 0, 0], [0, 1, 0], metadata=7,
                               device=CPU)
    for f in ("vertices", "normals", "tangents", "uv"):
        same(getattr(jt, f), getattr(tt, f))
    same(np.asarray(jt.metadata).astype(np.int64), tt.metadata)
    verts = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, 1, 0]],
                     np.float32)
    for face in ([0, 1, 2], [0, 1, 3], [3, 3, 1]):
        assert t_mesh.is_degenerate_face(verts, face) == \
            j_mesh.is_degenerate_face(verts, face)
    assert t_mesh.is_degenerate_face(verts, [0, 1, 2])


@pytest.mark.parametrize("make", [
    lambda: TB.Bounds3.empty(),
    lambda: TB.Bounds2.empty(),
    lambda: TB.Bounds3.from_points([0, 0, 0], [1, 1, 1]),
    lambda: TT.Transformation.identity(),
    lambda: TT.translate([1.0, 2.0, 3.0]),
    lambda: TT.look_at([0, 0, -3.0], [0, 0, 0.0], [0, 1.0, 0]),
    lambda: TT.Quaternion.identity(),
    lambda: TT.mat3x4_identity(),
    lambda: TR.RayDifferentials.create([0.0, 0, 1], [0.0, 0, -1]),
    lambda: TTri.empty_triangle(),
    lambda: t_mesh.build_triangle([0, 0, 0], [1, 0, 0], [0, 1, 0]),
], ids=["bounds3_empty", "bounds2_empty", "from_points", "identity",
        "translate", "look_at", "quaternion", "mat3x4", "ray_diff",
        "empty_triangle", "build_triangle"])
def test_constructors_default_to_the_card(make, monkeypatch):
    """Constructors that take no tensor make their tensors on the CUDA
    card by default and raise without one; nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_functions_keep_their_inputs_device():
    b = TB.Bounds3.from_points(torch.zeros(3), torch.ones(3))
    assert b.p_min.device.type == "cpu"
    assert TB.union(b, [2.0, 2, 2]).p_max.device.type == "cpu"
    t = TT.translate(torch.ones(3))
    assert t.apply_point([1.0, 2, 3]).device.type == "cpu"
    assert TTri.intersect_triangle(torch.zeros(3, 3), [0, 0, 1.0],
                                   [0, 0, -1.0], INF)[0].device.type == "cpu"
