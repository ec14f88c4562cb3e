"""The kernel-order model of the sweep kernels K2-K5
(``ops/dense.py:kernel_order_hits``), on the CPU.

The redesigned kernels chain only the 19 nonzero terms of the featurized
test and reject most tests before the division. The model evaluates the
test in their order with a single-rounding fused multiply-add, so it must
give what the 10-deep chain gives, in (accept, key), bit for bit, on
adversarial inputs: random rays aimed at random triangles, rays along
shared edges and through shared vertices, det of +-0, subnormal and
near the reject's range, and rays whose features are not finite. The
reject must never refuse a test that the exact epilogue accepts. Then the
model drives the worklist and occlusion sweeps (K3, K4) and the regroup
and packed sweeps (K2, K5), which must meet the same contract against the
JAX package's kernels in interpret mode as ``tests/test_torch_worklist.py``,
``tests/test_torch_occlusion.py``, ``tests/test_torch_regroup.py`` and
``tests/test_torch_packed.py`` hold the ``torch.bmm`` plain versions to.
K2's and K5's model must also equal the 10-deep chain on a query's own
blocks, where rows that cannot accept (the dummy subgroup, empty t
ranges, non-finite features) are skipped.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raycore_tpu.ops import pallas_dense as j_pd
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu_torch.accel.dense import _featurize_tris, ray_features
from raycore_tpu_torch.ops import dense as t_pd
from raycore_tpu_torch.ops import regroup as t_pr
from test_torch_packed import _jax_run_packed, _stage1 as _packed_stage1
from test_torch_packed import _scenes as _packed_scenes
from test_torch_regroup import _scenes as _regroup_scenes
from test_torch_regroup import _sweep_close
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


# The kernel-order model of the closest-hit sweeps K2 and K5
# (ops/regroup.py:run_regrouped_model, run_packed_model).


ROW_BAD_FEATURE = ((3, float("inf")), (6, -float("inf")), (0, float("nan")))


def _dense_chain(phi, feats, tmin, tmax):
    return t_pd.kernel_order_hits(phi, feats, tmin, tmax, sparse=False)


def _adversarial_blocks(engine, C, G, SPB, SUBC, seed=0):
    """A query's own blocks and ray table (the dummy subgroup included),
    with rows the sweeps must refuse or treat apart: t_min < 0, finite
    t_max, non-finite features, an empty or NaN t range; plus two blocks
    with cid = -1. Returns (block_subs, block_cid, tbl, feats, dead rows
    of the table (n_sub + 1, G))."""
    rng = np.random.default_rng(seed)
    R = 1024
    # Coherent rays cull clusters per subgroup, so clusters end in partly
    # filled blocks padded with the dummy subgroup.
    o, d = ray_arrays(R=R, seed=seed, coherent=True)
    tmin = np.zeros(R, np.float32)
    tmin[1::9] = -0.5
    tmax = np.full(R, np.inf, np.float32)
    tmax[2::5] = rng.uniform(0.5, 3, R)[2::5]
    rays = torch_rays(o, d, t_min=torch.as_tensor(tmin),
                      t_max=torch.as_tensor(tmax))
    if engine == "regroup":
        _, ts = _regroup_scenes(C=C)
        po, pd_, ptmin, ptmax, _, G, TILE = t_pr._padded_batch(rays, 256, G)
        bc, bs, tbl, _ = t_pr._stage1_cm_core(ts, po, pd_, ptmin, ptmax, TILE,
                                              G, SPB)
    else:
        _, ts = _packed_scenes(SUBC, C=C)
        po, pd_, ptmin, ptmax, _, G, TILE = t_pr._padded_batch(rays, 512, G)
        bc, bs, tbl, _ = t_pr._stage1_packed_core(ts, po, pd_, ptmin, ptmax,
                                                  TILE, G, SPB)
    tbl = tbl.clone()
    flat = tbl[:-1].reshape(-1, 16)
    for k, (col, val) in enumerate(ROW_BAD_FEATURE):
        flat[3 + k::97, col] = val
    flat[11::89, t_pr.COL_TMIN] = 5.0                 # t_min > t_max
    flat[11::89, t_pr.COL_TMAX] = 1.0
    flat[13::89, t_pr.COL_TMAX] = float("nan")
    bc = torch.cat([bc, torch.full((2,), -1, dtype=torch.int32)])
    bs = torch.cat([bs, bs[:2]])
    phi = tbl[:, :, :10]
    dead = ~torch.isfinite(phi).all(dim=2) \
        | ~(tbl[:, :, t_pr.COL_TMIN] <= tbl[:, :, t_pr.COL_TMAX])
    return bs, bc, tbl, ts.tri_feats, dead


@pytest.mark.parametrize("engine,C,G,SPB,SUBC", [
    ("regroup", 128, 32, 16, 1), ("regroup", 64, 16, 32, 1),
    ("packed", 128, 32, 2, 4), ("packed", 128, 32, 4, 1)])
def test_sweep_model_matches_the_10_deep_chain(engine, C, G, SPB, SUBC):
    """K2's and K5's model (19 terms, dead rows, the reject) gives what the
    10-deep chain gives, (key, pair) bit for bit, on a query's own blocks
    with adversarial rows; dead rows, the dummy subgroup's slots and the
    cid = -1 blocks miss."""
    bs, bc, tbl, feats, dead = _adversarial_blocks(engine, C, G, SPB, SUBC)
    C_eff = C // SUBC
    kw = dict(G=G, SPB_sub=SPB, C_eff=C_eff, SUBC=SUBC)
    km, pm = t_pr.run_packed_model(bs, bc, tbl, feats, **kw)
    kd, pd_ = t_pr.run_packed_plain(bs, bc, tbl, feats, **kw,
                                    hits=_dense_chain)
    assert torch.equal(km, kd) and torch.equal(pm, pd_)
    if engine == "regroup":
        kr, pr = t_pr.run_regrouped_model(bs, bc, tbl, feats, G=G, SPB=SPB,
                                          C=C)
        assert torch.equal(kr, km) and torch.equal(pr, pm)
    rows_dead = dead[bs.long()].reshape(-1)       # per (block, slot, ray)
    hit = pm >= 0
    assert int(hit.sum()) > 100
    assert not bool(hit[rows_dead].any())
    n_sub = tbl.shape[0] - 1
    assert bool((bs == n_sub).any())              # dummy slots are there
    assert bool(rows_dead.any()) and bool((dead[:-1]).any())
    tail = 2 * G * SPB
    assert bool((km[-tail:] == t_pd.INT32_MAX).all())
    assert bool((pm[-tail:] == -1).all())
    # The t_min < 0 rows hit too (the reject's t clause is off there).
    tmin_neg = (tbl[:, :, t_pr.COL_TMIN] < 0)[bs.long()].reshape(-1)
    assert bool(hit[tmin_neg].any())


@pytest.mark.parametrize("C,G,SPB", [(128, 32, 16), (64, 32, 16),
                                     (128, 16, 32)])
def test_regroup_model_matches_jax(C, G, SPB):
    """K2's model against JAX's ``run_regrouped`` in interpret mode, as
    ``test_sweep_plain_matches_jax_run_regrouped`` holds the plain
    version; on a subset of blocks it gives those blocks' rows."""
    js, ts = _regroup_scenes(C=C)
    o, d = ray_arrays(R=1024, seed=2)
    po, pd_, ptmin, ptmax, _, G, TILE = t_pr._padded_batch(
        torch_rays(o, d), 256, G)
    bc, bs, tbl, (_, _, nb) = t_pr._stage1_cm_core(ts, po, pd_, ptmin, ptmax,
                                                   TILE, G, SPB)
    kj, pj = j_pr.run_regrouped(jnp.asarray(np_(bs)), jnp.asarray(np_(bc)),
                                jnp.asarray(np_(tbl)), js.tri_feats, G=G,
                                SPB=SPB, C=C, n_blocks=nb, interpret=True)
    kw = dict(G=G, SPB=SPB, C=C)
    kt, pt = t_pr.run_regrouped_model(bs, bc, tbl, ts.tri_feats, **kw)
    _sweep_close(kj, pj, kt, pt)
    blocks = torch.tensor([0, nb // 3, nb - 1])
    ks, ps = t_pr.run_regrouped_model(bs, bc, tbl, ts.tri_feats, **kw,
                                      blocks=blocks)
    rows = t_pd.tile_rows(blocks, G * SPB)
    assert torch.equal(ks, kt[rows]) and torch.equal(ps, pt[rows])


@pytest.mark.parametrize("SUBC,spb_sub,packs", [(4, 2, 8), (4, 4, 4),
                                                (1, 2, 4)])
def test_packed_model_matches_jax(SUBC, spb_sub, packs):
    """K5's model against JAX's ``run_packed`` in interpret mode, as
    ``test_sweep_plain_matches_jax_run_packed`` holds the plain version;
    on a subset of blocks it gives those blocks' rows."""
    js, ts = _packed_scenes(SUBC)
    o, d = ray_arrays(R=1024, seed=2)
    (bc, bs, tbl, _), _, G, _ = _packed_stage1(ts, o, d, spb_sub=spb_sub)
    kw = dict(G=G, SPB_sub=spb_sub, C_eff=ts.cluster_size // SUBC,
              SUBC=SUBC)
    kj, pj = _jax_run_packed(bs, bc, tbl, js.tri_feats, PACKS=packs, **kw)
    kt, pt = t_pr.run_packed_model(bs, bc, tbl, ts.tri_feats, **kw)
    _sweep_close(kj, pj, kt, pt)
    nb = bc.shape[0]
    blocks = torch.tensor([nb - 1, 1, nb // 2])
    ks, ps = t_pr.run_packed_model(bs, bc, tbl, ts.tri_feats, **kw,
                                   blocks=blocks)
    rows = t_pd.tile_rows(blocks, G * spb_sub)
    assert torch.equal(ks, kt[rows]) and torch.equal(ps, pt[rows])
