"""The kernel-order model of the tile-worklist sweeps K3 and K4
(``ops/dense.py:kernel_order_hits``), on the CPU.

The redesigned kernels chain only the 19 nonzero terms of the featurized
test and reject most tests before the division. The model evaluates the
test in their order with a single-rounding fused multiply-add, so it must
give what the 10-deep chain gives, in (accept, key), bit for bit, on
adversarial inputs: random rays aimed at random triangles, rays along
shared edges and through shared vertices, det of +-0, subnormal and
near the reject's range, and rays whose features are not finite. The
reject must never refuse a test that the exact epilogue accepts. Then the
model drives the worklist and occlusion sweeps, which must meet the same
contract against the JAX package's kernels in interpret mode as
``tests/test_torch_worklist.py`` and ``tests/test_torch_occlusion.py``
hold the ``torch.bmm`` plain versions to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raycore_tpu.ops import pallas_dense as j_pd
from raycore_tpu_torch.accel.dense import _featurize_tris, ray_features
from raycore_tpu_torch.ops import dense as t_pd
from torch_parity import (jax_tile_padded, jax_worklist_args, np_,
                          pallas_dense_scenes as _scenes, ray_arrays,
                          torch_rays)

TILE = 128
CASES = ("random", "shared_edges", "degenerate_det", "non_finite")


def _feats(v):
    """(1, 16, 4C) featurized table of triangles v (C, 3, 3), quantity
    blocks [det | u*det | v*det | t*det]."""
    psi = _featurize_tris(*(torch.as_tensor(v[:, i], dtype=torch.float32)
                            for i in range(3)))                 # (C, 16, 4)
    return psi.permute(1, 2, 0).reshape(1, 16, -1).contiguous()


def _grid_tris(n=8, z=0.0):
    """A flat n x n grid over [0, 1]^2 at height z, two triangles a cell
    split along its x == y diagonal: 2 n^2 triangles whose vertices are
    exact binary fractions."""
    tris = []
    for i in range(n):
        for j in range(n):
            p = [np.array([(i + a) / n, (j + b) / n, z])
                 for a, b in ((0, 0), (1, 0), (1, 1), (0, 1))]
            tris += [[p[0], p[1], p[2]], [p[0], p[2], p[3]]]
    return np.array(tris, np.float32)


def _case(name, R=512, seed=0):
    """(phi (1, R, 16), feats (1, 16, 4C), tmin (1, R), tmax (1, R)) of one
    adversarial set."""
    rng = np.random.default_rng(seed)
    tmin = np.zeros(R, np.float32)
    tmin[1::9] = -0.5              # a negative t_min turns off its reject
    tmax = np.full(R, np.inf, np.float32)
    tmax[2::5] = rng.uniform(0.5, 3, R)[2::5]
    if name == "random":
        v = (rng.normal(size=(128, 3, 3)) * 0.3).astype(np.float32)
        o = rng.normal(size=(R, 3)).astype(np.float32) * 2
        # Aim each ray at a random point of a random triangle.
        w = rng.dirichlet([1, 1, 1], R).astype(np.float32)
        target = np.einsum("rk,rkx->rx", w, v[rng.integers(0, 128, R)])
        d = target - o
    elif name == "shared_edges":
        v = _grid_tris()
        # Downward and slanted rays through grid lines, cell diagonals and
        # vertices.
        k = rng.integers(0, 9, (R, 2)) / 8.0
        along = rng.integers(0, 3, R)
        p = np.where(along[:, None] == 0, k, rng.uniform(0, 1, (R, 2)))
        p[along == 1, 1] = k[along == 1, 0]
        p[along == 2] = np.stack([k[along == 2, 0]] * 2, 1) \
            + rng.uniform(0, 0.125, (R, 1))[along == 2]
        # A third of them moved off the line by 1-3e-5 of a cell: u or v
        # around the edge slack (1e-5) and the reject's margin (2e-5).
        p[::3] += rng.choice([-3, -2, -1.5, -1, 1, 1.5, 2, 3],
                             (len(p[::3]), 2)) * 1e-5 / 8
        target = np.concatenate([p, np.zeros((R, 1))], 1).astype(np.float32)
        d = np.concatenate([rng.normal(size=(R, 2)) * 0.2,
                            -np.ones((R, 1))], 1).astype(np.float32)
        d[::2, :2] = 0.0
        o = (target - 2.0 * d).astype(np.float32)
    elif name == "degenerate_det":
        # Triangles flat in z, degenerate ones (repeated or collinear
        # vertices) and tiny ones (|det| subnormal, and around the
        # reject's 2^-60 and 2^60 edges).
        v = _grid_tris(n=4)                                   # 32 flat
        deg = v.copy()
        deg[::2, 2] = deg[::2, 1]                             # repeated
        deg[1::2, 2] = 2 * deg[1::2, 1] - deg[1::2, 0]        # collinear
        scales = np.float32([2.0 ** -70, 2.0 ** -40, 2.0 ** -31,
                             2.0 ** -29, 2.0 ** 29, 2.0 ** 31, 2.0 ** 34])
        tiny = np.concatenate([_grid_tris(n=2) * s for s in scales])[:64]
        v = np.concatenate([v, deg, tiny]).astype(np.float32)
        o = np.concatenate([rng.uniform(-0.2, 1.2, (R, 2)),
                            rng.choice([0.0, 1e-30, 1.0], (R, 1))], 1)
        d = rng.normal(size=(R, 3))
        d[::3, 2] = 0.0                       # parallel to the plane: det 0
        d[1::3, 2] = rng.choice([1e-38, -1e-30, 1e-20], R)[1::3]
        o, d = o.astype(np.float32), d.astype(np.float32)
    else:  # non_finite
        v = (rng.normal(size=(128, 3, 3)) * 0.3).astype(np.float32)
        o = rng.normal(size=(R, 3)).astype(np.float32)
        d = rng.normal(size=(R, 3)).astype(np.float32)
        o[::4] = np.float32([3e38, 3e38, 0.0])       # o x d overflows
        d[::4] = np.float32([0.6, -0.8, 0.0])
        o[1::4, 0] = np.inf
        d[2::4, 1] = np.nan
        o[3::8] = np.float32([1e19, -2e19, 5e18])    # large but finite
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    phi = ray_features(torch.as_tensor(o, dtype=torch.float32),
                       torch.as_tensor(d.astype(np.float32)))
    return (phi[None], _feats(v), torch.as_tensor(tmin)[None],
            torch.as_tensor(tmax)[None])


def _keys(ok, t):
    """The kernels' candidate keys: bits of max(t, +0) where accepted."""
    kb = torch.where(t > 0.0, t, 0.0).view(torch.int32)
    return torch.where(ok, kb, t_pd.INT32_MAX)


@pytest.mark.parametrize("name", CASES)
def test_sparse_chain_matches_the_10_deep_chain(name):
    """The model (19 terms, the reject, non-finite rays refused) and the
    10-deep chain accept the same (ray, lane) tests with the same keys."""
    phi, feats, tmin, tmax = _case(name)
    ok_s, t_s = t_pd.kernel_order_hits(phi, feats, tmin, tmax)
    ok_d, t_d = t_pd.kernel_order_hits(phi, feats, tmin, tmax, sparse=False)
    assert torch.equal(ok_s, ok_d)
    assert torch.equal(_keys(ok_s, t_s), _keys(ok_d, t_d))
    if name != "non_finite":
        assert int(ok_d.sum()) > 0
    else:
        # The finite rays still hit; a non-finite one accepts nothing.
        finite = torch.isfinite(phi[0, :, :10]).all(dim=1)
        assert int(ok_d[0][finite].sum()) > 0
        assert not ok_d[0][~finite].any()


@pytest.mark.parametrize("name", CASES)
def test_reject_never_refuses_an_accepted_test(name):
    """``quick_reject`` on the 19-term quantities never refuses a test
    that the exact epilogue accepts on the same quantities; on the random
    set it refuses most tests."""
    phi, feats, tmin, tmax = _case(name)
    q = t_pd.kernel_order_quads(phi, feats, t_pd.SPARSE_ROWS)
    ok, _ = t_pd.exact_epilogue(*q, tmin[..., None], tmax[..., None])
    rej = t_pd.quick_reject(*q, (tmin >= 0)[..., None])
    assert not bool((rej & ok).any())
    if name == "random":
        assert float(rej.float().mean()) > 0.8
    if name == "degenerate_det":
        det = q[0].abs()
        lo, hi = t_pd.REJECT_DET_RANGE
        # The set reaches zero, subnormal and out-of-range det.
        assert bool((det == 0).any())
        assert bool(((det > 0) & (det < 2.0 ** -126)).any())
        assert bool(((det > 0) & (det < lo)).any())
        assert bool((det > hi).any())


def test_reject_margins_clear_the_edge_slack():
    """The reject's constants, rounded to float32 as the kernel's
    literals are, clear the acceptance slack by the rounding argument of
    ``csrc/featurized.cuh:quick_reject`` (eps = 2^-24): a refused u or v
    lies below -slack, a refused u + v above 1 + slack."""
    f32 = lambda x: float(np.float32(x))
    eps = 2.0 ** -24
    m, k = f32(t_pd.REJECT_MARGIN), f32(t_pd.REJECT_SUM)
    assert m * (1 - eps) ** 3 > f32(t_pd.EDGE_EPS)
    uv = k * (1 - eps) * (1 - 2.01 * eps) - 2.01 * eps * 4 * m * (1 + eps) \
        - 2.0 ** -148
    assert uv * (1 - eps) > f32(1 + t_pd.EDGE_EPS)
    lo, hi = t_pd.REJECT_DET_RANGE
    assert lo * hi == 1 and 1 / hi >= 2.0 ** -126 and m * lo >= 2.0 ** -126


def _bits(scene):
    return t_pd._idx_bits(scene.cluster_size // scene.sub_chunks)


@pytest.mark.parametrize("blobby,SUB,coherent", [
    (False, 1, True), (False, 4, False), (True, 1, False), (True, 4, False)])
def test_worklist_model_matches_jax(blobby, SUB, coherent):
    """The model-driven worklist sweep against JAX's ``_run_worklist`` in
    interpret mode: decoded keys within rtol 2e-6, equal pairs where the
    keys are equal (tests/test_torch_worklist.py's contract). On a subset
    of tiles it gives the same rows as over all of them."""
    js, ts = _scenes(blobby, SUB)
    C, bits = ts.cluster_size, _bits(ts)
    o, d = ray_arrays(R=1024, seed=1, coherent=coherent,
                      zero_dirs=not coherent)
    t_max = np.full(1024, np.inf, np.float32)
    t_max[5::11] = 2.2
    tr = torch_rays(o, d, t_max=torch.as_tensor(t_max))
    tids, cids, phi, tmin, key0, _, _, _ = t_pd._phase_a_and_worklist(
        ts, *t_pd.flat_rays(tr), TILE=TILE)
    pair0 = torch.full_like(key0, -1)
    jt, jc, jphi, jtmin, jkey0, jpair0 = jax_worklist_args(
        tids, cids, phi, tmin, key0, pair0, TILE)
    kj, pj = j_pd._run_worklist(
        jt, jc, jphi, js.tri_feats, js.sub_bounds, jtmin, jkey0, TILE=TILE,
        C=C, SUB=SUB, n_blocks=int(tids.shape[0]), interpret=True,
        pair0=jpair0)
    kw = dict(TILE=TILE, C=C, SUB=SUB)
    args = (tids, cids, phi, ts.tri_feats, ts.sub_bounds, tmin, key0, pair0)
    kt, pt = t_pd.run_worklist_model(*args, **kw)
    kj, pj = np_(kj)[:1024], np_(pj)[:1024]
    kt, pt = np_(kt), np_(pt)
    hj, ht = pj >= 0, pt >= 0
    assert np.array_equal(hj, ht) and ht.sum() > 0
    mask = (1 << bits) - 1
    np.testing.assert_allclose((kt[ht] & ~mask).view(np.float32),
                               (kj[ht] & ~mask).view(np.float32),
                               rtol=2e-6, atol=0)
    same = kj == kt
    assert np.array_equal(pj[same], pt[same])
    tiles = torch.tensor([0, 3, 5, 7])
    ks, ps = t_pd.run_worklist_model(*args, **kw, tiles=tiles)
    rows = t_pd.tile_rows(tiles, TILE)
    assert np.array_equal(np_(ks), kt[np_(rows)])
    assert np.array_equal(np_(ps), pt[np_(rows)])


@pytest.mark.parametrize("blobby", [False, True], ids=["grid", "blobby"])
def test_occlusion_model_matches_jax(blobby):
    """The model-driven occlusion sweep against JAX's ``_run_occlusion``
    in interpret mode: equal occluders (tests/test_torch_occlusion.py's
    contract); on a subset of tiles, the same rows as over all of them."""
    js, ts = _scenes(blobby)
    o, d = ray_arrays(R=1024, seed=3, coherent=not blobby, zero_dirs=blobby)
    t_max = np.full(1024, np.inf, np.float32)
    t_max[::5] = 1.6
    tr = torch_rays(o, d, t_max=torch.as_tensor(t_max))
    tids, cids, phi, tmin, tmax = t_pd._occl_phase_a(
        ts, *t_pd.flat_rays(tr), TILE=TILE)
    kw = dict(TILE=TILE, C=ts.cluster_size)
    got = t_pd.run_occlusion_model(tids, cids, phi, ts.tri_feats, tmin, tmax,
                                   **kw)
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
    tiles = torch.tensor([1, 2, 6])
    sub = t_pd.run_occlusion_model(tids, cids, phi, ts.tri_feats, tmin, tmax,
                                   **kw, tiles=tiles)
    assert np.array_equal(np_(sub), np_(got)[np_(t_pd.tile_rows(tiles,
                                                                TILE))])
