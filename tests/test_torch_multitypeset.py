"""Parity of the port's MultiTypeSet and SoA utilities with the JAX
package, on the CPU: twins of tests/test_analysis.py's MultiTypeSet tests
(push and dispatch, update and the invalid no-op, textures, batched keys,
inline vector fields), the static form equal array for array, the texture
samplers bit for bit on random textures and uvs (out-of-range uvs and
handles included), and ``utils/soa.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.collections import multitypeset as jm
from raycore_tpu.utils import soa as jsoa
from raycore_tpu_torch import convert
from raycore_tpu_torch.collections import multitypeset as tm
from raycore_tpu_torch.utils import soa as tsoa
from torch_parity import CPU, np_


class Twin:
    """The same mutations on a JAX MultiTypeSet and on the port's."""

    def __init__(self):
        self.j, self.t = jm.MultiTypeSet(), tm.MultiTypeSet(device=CPU)

    def __getattr__(self, name):
        def both(*a, **kw):
            rj = getattr(self.j, name)(*a, **kw)
            rt_ = getattr(self.t, name)(*a, **kw)
            if isinstance(rj, jnp.ndarray):
                assert np.array_equal(np.asarray(rj), np_(rt_))
            return rt_
        return both


def assert_static_equal(js, ts):
    assert len(js.tables) == len(ts.tables)
    for jt, tt in zip(js.tables, ts.tables):
        assert set(jt) == set(tt)
        for k in jt:
            assert np.asarray(jt[k]).dtype == np_(tt[k]).dtype, k
            assert np.array_equal(np.asarray(jt[k]), np_(tt[k])), k
    assert np.array_equal(np.asarray(js.counts), np_(ts.counts))
    assert np.array_equal(np.asarray(js.textures.data),
                          np_(ts.textures.data))
    assert np.array_equal(np.asarray(js.textures.records),
                          np_(ts.textures.records))


def test_multitypeset_push_dispatch():
    s = Twin()
    k1 = s.push({"albedo": 0.8, "sigma": 1.0}, "matte")
    k2 = s.push({"eta": 1.5, "k": 2.0}, "metal")
    k3 = s.push({"albedo": 0.3, "sigma": 0.5}, "matte")
    assert s.t.n_slots == 2 and len(s.t) == 3
    js, ts = s.j.get_static(), s.t.get_static()
    assert_static_equal(js, ts)
    fns = [lambda row: row["albedo"] * 2.0, lambda row: row["eta"] + row["k"]]
    for k in (k1, k2, k3):
        want = float(jm.with_index(fns, js, jnp.asarray(np_(k))))
        assert float(tm.with_index(fns, ts, k)) == want
    assert [float(tm.with_index(fns, ts, k)) for k in (k1, k2, k3)] == \
        pytest.approx([1.6, 3.5, 0.6])


def test_multitypeset_update_and_invalid_noop():
    s = Twin()
    k = s.push({"v": 1.0}, "a")
    s.update(k, {"v": 5.0})
    st = s.t.get_static()
    assert float(tm.with_index([lambda r: r["v"]], st, k)) == 5.0
    s.update(tm.SetKey(*tm.INVALID_KEY, device=CPU), {"v": 9.0})
    js, st2 = s.j.get_static(), s.t.get_static()
    assert_static_equal(js, st2)
    assert float(tm.with_index([lambda r: r["v"]], st2, k)) == 5.0
    assert bool(tm.is_invalid(tm.SetKey(-1, -1, device=CPU)))
    assert not bool(tm.is_invalid(k)) and bool(tm.is_valid_key(k))
    # delete frees the row for the next push (stable keys); free clears.
    s.delete(k)
    assert len(s.t) == 0
    k2 = s.push({"v": 2.0}, "a")
    assert np.array_equal(np_(k2), np_(k))
    assert_static_equal(s.j.get_static(), s.t.get_static())
    s.t.free()
    assert len(s.t) == 0 and s.t.n_slots == 0


def test_multitypeset_textures():
    s = Twin()
    tex = np.linspace(0, 1, 16, dtype=np.float32).reshape(4, 4)
    k = s.push({"scale": 2.0, "tex": tex}, "textured")
    js, st = s.j.get_static(), s.t.get_static()
    assert_static_equal(js, st)

    def make_sampler(pool, pkg):
        def sample_mat(row):
            uv = torch.tensor([0.9, 0.9]) if pkg is tm else \
                jnp.array([0.9, 0.9], jnp.float32)
            return pkg.sample_nearest(pool, row["tex"], uv)[0] * row["scale"]
        return sample_mat

    val = float(tm.with_index([make_sampler(st.textures, tm)], st, k))
    assert val == float(jm.with_index([make_sampler(js.textures, jm)], js,
                                      jnp.asarray(np_(k))))
    assert val == pytest.approx(2.0 * tex[3, 3], rel=1e-5)
    # update reuses the texture slot for same-shape data.
    s.update(k, {"scale": 2.0, "tex": tex * 0.5})
    st2 = s.t.get_static()
    assert_static_equal(s.j.get_static(), st2)
    val2 = float(tm.with_index([make_sampler(st2.textures, tm)], st2, k))
    assert val2 == pytest.approx(tex[3, 3], rel=1e-5)
    assert st2.textures.records.shape == st.textures.records.shape
    # A new shape takes a new slot.
    s.update(k, {"scale": 1.0, "tex": np.ones((2, 3, 3), np.float32)})
    st3 = s.t.get_static()
    assert_static_equal(s.j.get_static(), st3)
    assert st3.textures.records.shape[0] == 3
    h = int(st3.tables[0]["tex"][0])
    assert np.array_equal(tm.texture_to_numpy(st3.textures, h),
                          jm.texture_to_numpy(s.j.get_static().textures, h))
    assert np.array_equal(np_(tm.deref(st3.textures, h)),
                          np.asarray(jm.deref(s.j.get_static().textures, h)))
    assert tm.maybe_convert_field(s.t, np.zeros((2, 2), np.float32)) == 3
    assert tm.maybe_convert_field(s.t, 0.5) == 0.5


def test_multitypeset_batched_keys():
    s = Twin()
    for v in (1.0, 2.0, 3.0):
        s.push({"v": v}, "a")
    for w in (10.0, 20.0):
        s.push({"w": w}, "b")
    js, st = s.j.get_static(), s.t.get_static()
    keys = np.asarray([[0, 0], [1, 1], [0, 2], [1, 3], [5, -1]], np.int32)
    fns = [lambda r: r["v"], lambda r: r["w"]]
    want = jax.vmap(lambda k: jm.with_index(fns, js, k))(jnp.asarray(keys))
    got = tm.with_index(fns, st, torch.as_tensor(keys))
    assert np.array_equal(np_(got), np.asarray(want))
    np.testing.assert_allclose(np_(got)[:3], [1.0, 20.0, 3.0])
    # Tuple outputs of differing widths select leaf by leaf.
    fns2 = [lambda r: (r["v"], torch.stack([r["v"], r["v"]], -1)),
            lambda r: (-r["w"], torch.zeros(r["w"].shape + (2,)))]
    a, b = tm.with_index(fns2, st, torch.as_tensor(keys))
    np.testing.assert_allclose(np_(a)[:3], [1.0, -20.0, 3.0])
    np.testing.assert_allclose(np_(b)[:3], [[1, 1], [0, 0], [3, 3]])


def test_multitypeset_inline_vector_fields():
    s = Twin()
    k1 = s.push({"albedo": np.array([0.8, 0.2, 0.1], np.float32),
                 "sigma": 1.0}, "matte")
    k2 = s.push({"tint": [0.9, 0.8, 0.7]}, "mirror")
    k3 = s.push({"albedo": np.array([0.1, 0.2, 0.3], np.float32),
                 "sigma": 0.0}, "matte")
    s.push({"n": 3, "flag": True}, "ints")
    st = s.t.get_static()
    assert_static_equal(s.j.get_static(), st)
    fns = [lambda r: r["albedo"] * 2.0, lambda r: r["tint"],
           lambda r: r["n"]]
    np.testing.assert_allclose(np_(tm.with_index(fns, st, k1)),
                               [1.6, 0.4, 0.2], rtol=1e-6)
    np.testing.assert_allclose(np_(tm.with_index(fns, st, k2)),
                               [0.9, 0.8, 0.7], rtol=1e-6)
    s.update(k3, {"albedo": np.array([1.0, 1.0, 1.0], np.float32),
                  "sigma": 2.0})
    st2 = s.t.get_static()
    assert_static_equal(s.j.get_static(), st2)
    np.testing.assert_allclose(np_(tm.with_index(fns, st2, k3)),
                               [2.0, 2.0, 2.0], rtol=1e-6)
    assert st2.tables[2]["n"].dtype == torch.int32


def _random_pool(rng):
    s = jm.MultiTypeSet()
    for shape in ((5, 7), (3, 4, 3), (6, 2, 4), (1, 1, 2)):
        s.store_texture(rng.uniform(-1, 1, shape).astype(np.float32))
    pool = s.get_static().textures
    return pool, convert.texture_pool_from_numpy(
        np.asarray(pool.data), np.asarray(pool.records), device=CPU)


@pytest.mark.parametrize("sampler", ["sample_nearest", "sample_bilinear"])
def test_samplers_bitwise(sampler):
    """Both samplers bit for bit with JAX's, every handle (and handles
    past the records) at uvs inside, on and past [0, 1]."""
    rng = np.random.default_rng(4)
    jpool, tpool = _random_pool(rng)
    n = 999
    refs = rng.integers(-2, 7, n).astype(np.int32)
    uv = rng.uniform(-0.3, 1.3, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [0.5, 0.5], [1, 0], [0, 1], [0.999, 0.001],
              [0.25, 0.75], [1e-8, 1 - 1e-7]]
    want = getattr(jm, sampler)(jpool, jnp.asarray(refs), jnp.asarray(uv))
    got = getattr(tm, sampler)(tpool, torch.as_tensor(refs),
                               torch.as_tensor(uv))
    assert got.dtype == torch.float32 and got.shape == (n, 4)
    assert np.array_equal(np_(got).view(np.int32),
                          np.asarray(want).view(np.int32))
    # Scalar handle and uv.
    w1 = getattr(jm, sampler)(jpool, 2, jnp.asarray(uv[6]))
    g1 = getattr(tm, sampler)(tpool, 2, torch.as_tensor(uv[6]))
    assert np.array_equal(np_(g1), np.asarray(w1))


def test_static_form_converts_and_helpers():
    """convert.static_multitypeset_from_numpy gives the port's own static
    form; foreach_type, mapreduce_set, n_slots and to_tuple."""
    s = Twin()
    s.push({"a": 1.0, "tex": np.ones((2, 2), np.float32)}, "x")
    s.push({"a": 4.0, "tex": np.zeros((3, 1), np.float32)}, "x")
    s.push({"b": 7}, "y")
    js, ts = s.j.get_static(), s.t.get_static()
    cv = convert.static_multitypeset_from_numpy(
        [{k: np.asarray(v) for k, v in t.items()} for t in js.tables],
        np.asarray(js.counts), np.asarray(js.textures.data),
        np.asarray(js.textures.records), device=CPU)
    assert_static_equal(js, cv)
    assert_static_equal(js, ts)
    assert tm.n_slots(ts) == 2 and tm.to_tuple(ts) is ts.tables
    seen = tm.foreach_type(lambda i, t, c: (i, sorted(t), int(c)), ts)
    assert seen == [(0, ["a", "tex"], 2), (1, ["b"], 1)]
    total = tm.mapreduce_set(
        [lambda t: t["a"], lambda t: t["b"].float()],
        lambda acc, v, live: acc + float((v * live).sum()), 0.0, ts)
    want = jm.mapreduce_set(
        [lambda r: r["a"], lambda r: r["b"].astype(jnp.float32)],
        lambda acc, v, live: acc + float((v * live).sum()), 0.0, js)
    assert total == want == 12.0
    assert tm.TexturePool.empty(device=CPU).records.shape == (1, 4)


def test_soa_utilities_match_jax():
    rng = np.random.default_rng(9)
    arrs = {"p": rng.normal(size=(6, 3)).astype(np.float32),
            "i": np.arange(6, dtype=np.int32)}
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    for idx in (2, slice(1, 4)):
        for f in (("p",), ("p", "i")):
            want, got = jsoa.soa_get(j, idx, *f), tsoa.soa_get(t, idx, *f)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for w, g in zip(want, got):
                assert np.array_equal(np.asarray(w), np_(g))
    jw = jsoa.soa_set(j, 3, p=jnp.ones(3), i=9)
    tw = tsoa.soa_set(t, 3, p=torch.ones(3), i=9)
    for k in arrs:
        assert np.array_equal(np.asarray(jw[k]), np_(tw[k]))
        assert np.array_equal(np_(t[k]), arrs[k])   # input untouched
    sim = tsoa.similar_soa(t, 4, {"i": torch.int64})
    assert sim["p"].shape == (4, 3) and sim["i"].dtype == torch.int64
    assert not sim["p"].any()
    seen = []
    tsoa.for_unrolled(lambda i, x: seen.append((i, x)), "ab")
    assert seen == [(0, "a"), (1, "b")]
    assert tsoa.map_unrolled(lambda x: x * 2, (1, 2)) == (2, 4)
    assert tsoa.reduce_unrolled(lambda a, x: a * x, (2, 3, 4), 1) == 24
    assert tsoa.sum_unrolled(lambda x: x / 2, (1, 2, 3)) == \
        jsoa.sum_unrolled(lambda x: x / 2, (1, 2, 3))
    fns = [lambda x: x + 1, lambda x: x * 10, lambda x: -x]
    for idx in (-3, 0, 1, 2, 7):
        want = jsoa.switch_apply(idx, fns, jnp.float32(2.0))
        assert float(tsoa.switch_apply(idx, fns, torch.tensor(2.0))) == \
            float(want)
        assert float(tsoa.switch_apply(idx, [5.0, 6.0, 7.0])) == float(
            jsoa.switch_apply(idx, [5.0, 6.0, 7.0]))
    # A batched index selects per lane (lax.switch under vmap).
    idx = np.array([0, 2, 1, 9], np.int32)
    want = jax.vmap(lambda i: jsoa.switch_apply(i, fns, jnp.float32(2.0)))(
        jnp.asarray(idx))
    got = tsoa.switch_apply(torch.as_tensor(idx), fns,
                            torch.full((4,), 2.0))
    assert np.array_equal(np_(got), np.asarray(want))


def test_package_exports_collections():
    for name in ("MultiTypeSet", "StaticMultiTypeSet", "SetKey",
                 "TexturePool", "with_index", "is_invalid", "is_valid_key",
                 "sample_nearest", "sample_bilinear", "deref", "to_tuple",
                 "maybe_convert_field", "texture_to_numpy", "soa_get",
                 "soa_set", "similar_soa", "for_unrolled", "map_unrolled",
                 "reduce_unrolled", "sum_unrolled", "switch_apply"):
        assert hasattr(rt, name), name
