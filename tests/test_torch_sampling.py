"""Parity of the port's sampling and shading-frame math with the JAX
package, on the CPU: every function of ``core/sampling.py`` on the same
NumPy inputs (made from a seed, with the degenerate cases each function
guards: zero offsets, sin(theta) = 0, ties in the smallest component),
within rtol 2e-6 and atol 1e-6. The two functions that draw are fed the
JAX package's draws for the same key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.core import sampling as js
from raycore_tpu_torch.core import sampling as ts
from torch_parity import JaxDraws, feed_jax_draws, np_

RTOL, ATOL = 2e-6, 1e-6


def _u(rng, n=257):
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u[:4] = [[0.5, 0.5], [0.5, 0.2], [0.1, 0.5], [0.0, 1.0]]
    return u


def _unit(rng, n=257):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
    return w


def _frame(rng, n=257):
    x, y, z = (np.ascontiguousarray(a) for a in np.asarray(js.coordinate_system(
        jnp.asarray(_unit(rng, n)))))
    return z, x, y


CASES = {
    "concentric_sample_disk": lambda r: (_u(r),),
    "cosine_sample_hemisphere": lambda r: (_u(r),),
    "uniform_sample_sphere": lambda r: (_u(r),),
    "uniform_sample_cone": lambda r: (_u(r), np.float32(0.8)),
    "uniform_sample_cone_frame": lambda r: (_u(r), np.float32(0.3),
                                            *_frame(r)),
    "sum_mul": lambda r: (r.uniform(0, 1, (65, 3)).astype(np.float32),
                          r.normal(size=(65, 3, 3)).astype(np.float32)),
    "cos_theta": lambda r: (_unit(r),),
    "sin_theta2": lambda r: (_unit(r),),
    "sin_theta": lambda r: (_unit(r),),
    "tan_theta": lambda r: (_unit(r)[3:],),
    "cos_phi": lambda r: (_unit(r),),
    "sin_phi": lambda r: (_unit(r),),
    "reflect": lambda r: (_unit(r), _unit(r)),
    "coordinate_system": lambda r: (_unit(r),),
    "spherical_direction": lambda r: tuple(
        r.uniform(0, 1, (3, 65)).astype(np.float32)),
    "spherical_direction_frame": lambda r: (
        *r.uniform(0, 1, (3, 257)).astype(np.float32), *_frame(r)),
    "spherical_theta": lambda r: (_unit(r),),
    "spherical_phi": lambda r: (_unit(r),),
    "face_forward": lambda r: (_unit(r), _unit(r)),
    "get_orthogonal_basis": lambda r: (np.concatenate(
        [_unit(r), np.array([[1, 1, 2], [0.5, -0.5, 3]], np.float32)]),),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampling_function_matches_jax(name):
    args = CASES[name](np.random.default_rng(sorted(CASES).index(name)))
    fn = name.replace("_frame", "")
    want = getattr(js, fn)(*(jnp.asarray(a) for a in args))
    got = getattr(ts, fn)(*(torch.as_tensor(a) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_pdfs_match_jax():
    assert ts.uniform_sphere_pdf() == pytest.approx(
        float(js.uniform_sphere_pdf()), rel=1e-7)
    for c in (0.0, 0.5, 0.99):
        assert ts.uniform_cone_pdf(c) == pytest.approx(
            float(js.uniform_cone_pdf(c)), rel=1e-6)


@pytest.mark.parametrize("name", ["random_hemisphere_uniform",
                                  "random_triangle_point"])
def test_random_functions_match_jax_on_its_draws(monkeypatch, name):
    """The functions that take a key, fed the JAX package's draws for the
    same key (``sampling._uniform``)."""
    feed_jax_draws(monkeypatch)
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(11)
    if name == "random_hemisphere_uniform":
        n, u, v = _frame(rng)
        args = (n, u, v)
    else:
        args = (rng.normal(size=(129, 3, 3)).astype(np.float32),)
    want = getattr(js, name)(key, *(jnp.asarray(a) for a in args))
    got = getattr(ts, name)(JaxDraws(key, "plain"),
                            *(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_random_functions_draw_from_the_generator():
    """Without the JAX draws: a generator seeded alike draws alike, the
    results lie where they should (unit hemisphere about n; inside the
    triangle), and None is a generator seeded 0."""
    cpu = torch.device("cpu")
    n = torch.tensor([[0.0, 0.0, 1.0]]).expand(512, 3)
    u, v = torch.tensor([1.0, 0, 0]).expand(512, 3), \
        torch.tensor([0, 1.0, 0]).expand(512, 3)
    g = lambda: torch.Generator(device=cpu).manual_seed(5)
    a = ts.random_hemisphere_uniform(g(), n, u, v)
    assert torch.equal(a, ts.random_hemisphere_uniform(g(), n, u, v))
    assert (a[:, 2] >= 0).all()
    torch.testing.assert_close(a.norm(dim=1), torch.ones(512))
    assert torch.equal(
        ts.random_hemisphere_uniform(None, n, u, v),
        ts.random_hemisphere_uniform(
            torch.Generator(device=cpu).manual_seed(0), n, u, v))
    tri = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]).expand(512, 3, 3)
    p = ts.random_triangle_point(g(), tri)
    assert (p[:, :2] >= -1e-7).all() and (p[:, :2].sum(1) <= 1 + 1e-6).all()


def test_package_exports_sampling():
    """``sampling`` and ``reflect`` at the package level, as the JAX
    package exports them."""
    assert rt.sampling is ts and rt.reflect is ts.reflect
    assert rc.sampling is js
