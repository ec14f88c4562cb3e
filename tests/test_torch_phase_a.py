"""Parity of phase A (kernel K1's plain version) and the compact stage 1
with the JAX package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode. The entry matrix
must be bit-for-bit equal, including where the +infs (culled pairs) fall,
and the stage-1 block lists must be equal block for block. Kernel K1's
arithmetic (``phase_a_model``) must equal the plain version and JAX's
kernel bit for bit on adversarial stats and boxes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.ops import pallas_dense as j_pd
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch.ops import dense as t_pd
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_adversarial import (PHASE_A_CASES, phase_a_case,
                               phase_a_signed_zeros, stage1_rows)
from torch_parity import (CPU, assert_ray_features_close, bits, np_,
                          ray_arrays)


def _scenes(C=128, blobby=False):
    if blobby:
        return (j_dense.build_dense(j_mesh.blobby_mesh(64, 64),
                                    cluster_size=C),
                rt.build_dense(t_mesh.blobby_mesh(64, 64, device=CPU),
                               cluster_size=C))
    return (j_dense.build_dense(j_mesh.displaced_grid_mesh(n=40),
                                cluster_size=C),
            rt.build_dense(t_mesh.displaced_grid_mesh(n=40, device=CPU),
                           cluster_size=C))


def _prepared(R, seed, coherent, zero_dirs):
    """Flat ray arrays as the drivers hand them to stage 1: -0 directions
    turned into +0, t_min 0, t_max inf (some rays bounded)."""
    o, d = ray_arrays(R=R, seed=seed, coherent=coherent, zero_dirs=zero_dirs)
    d = np.where(d == 0.0, np.float32(0), d).astype(np.float32)
    t_min = np.zeros(len(o), np.float32)
    t_max = np.full(len(o), np.inf, np.float32)
    t_max[5::11] = 2.5
    return o, d, t_min, t_max


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


@pytest.mark.parametrize("coherent,zero_dirs,TILE", [
    (True, False, 256), (False, True, 128), (False, True, 1024),
    (False, False, 512)])
def test_phase_a_plain_matches_jax_bitwise(coherent, zero_dirs, TILE):
    """The tile stats (``bundle_stats`` at n = TILE, the JAX package's
    ``subgroup_stats`` at a group of TILE rays) and the entry matrix, bit
    for bit."""
    js, ts = _scenes()
    arrays = _prepared(1024, 1, coherent, zero_dirs)
    ja, ta = _both(*arrays)
    n_tiles = len(arrays[0]) // TILE
    rows = stage1_rows(*ta)
    assert np.array_equal(bits(j_pr.subgroup_stats(*ja, TILE)),
                          bits(t_pd.bundle_stats(*rows, TILE)))
    ref = j_pd.phase_a_entry(js, *ja, n_tiles, TILE, True)
    got = t_pd.phase_a_entry(*rows, ts.cluster_min, ts.cluster_max, TILE)
    assert np.array_equal(bits(ref), bits(got))
    fin = np.isfinite(np_(got))
    assert 0 < fin.sum() < fin.size


def test_phase_a_against_ragged_boxes_matches_jax():
    """Arbitrary AABBs, K not a multiple of the reference's 1024 lane
    block (which pads K with 1e30 boxes; the port does not pad)."""
    rng = np.random.default_rng(7)
    K = 1500
    lo = rng.uniform(-1, 1, (K, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.3, (K, 3)).astype(np.float32)
    arrays = _prepared(1024, 2, False, True)
    ja, ta = _both(lo, hi, *arrays)
    ref = j_pd.phase_a_entry_bounds(*ja, 8, 128, True)
    got = t_pd.phase_a_entry(*stage1_rows(*ta[2:]), *ta[:2], 128)
    assert got.shape == (8, K)
    assert np.array_equal(bits(ref), bits(got))


@pytest.mark.parametrize("case", PHASE_A_CASES)
def test_phase_a_model_matches_plain_and_jax_bitwise(case):
    """K1's fast arithmetic (extreme differences, 4 products an axis,
    plain arithmetic outside its class or where t_lo is zero) against the
    plain version and JAX's kernel in interpret mode, bit for bit: NaN and
    +-inf in each stats column, +-0 directions, inverse directions at
    exactly +-INV_DIR_CLAMP, boxes padded with +-1e30, empty boxes, and
    t_min_lo > t_max_hi; a tile count and K that are not whole strips and
    CTAs."""
    st, b = phase_a_case(case)
    ref = j_pd._phase_a_fast(jnp.asarray(st), jnp.asarray(b), interpret=True)
    plain = t_pd.phase_a_plain(torch.as_tensor(st), torch.as_tensor(b))
    got = t_pd.phase_a_model(torch.as_tensor(st), torch.as_tensor(b))
    assert np.array_equal(bits(plain), bits(ref))
    assert np.array_equal(bits(got), bits(plain))
    fin = np.isfinite(np_(got))
    assert 0 < fin.sum() < fin.size


def test_phase_a_model_keeps_the_sign_of_zero_entries():
    """Corner products that are zeros of both signs, with t_min_lo +-0:
    entries of +-0, whose sign the min/max chain's choice among equal zeros
    decides. The model takes the plain version's own value for them, bit
    for bit. (The JAX package's min/max on the CPU keep other zeros than
    PyTorch's on some of these entries, so JAX is not compared here.)"""
    st, b = phase_a_signed_zeros()
    plain = t_pd.phase_a_plain(torch.as_tensor(st), torch.as_tensor(b))
    got = t_pd.phase_a_model(torch.as_tensor(st), torch.as_tensor(b))
    assert np.array_equal(bits(got), bits(plain))
    zeros = np_(plain) == 0
    assert zeros.any() and np.signbit(np_(plain)[zeros]).any()


@pytest.mark.parametrize("coherent,zero_dirs,TILE", [
    (True, False, 256), (False, True, 128)])
def test_phase_a_model_on_query_stats(coherent, zero_dirs, TILE):
    """The model on the stats and bounds a query builds, against the
    plain version, bit for bit."""
    _, ts = _scenes()
    arrays = _prepared(1024, 1, coherent, zero_dirs)
    ta = [torch.as_tensor(a) for a in arrays]
    ta = t_pd.pad_rays(*ta, TILE)
    stats, bounds = t_pd.phase_a_inputs(*stage1_rows(*ta), ts.cluster_min,
                                        ts.cluster_max, TILE)
    assert np.array_equal(bits(t_pd.phase_a_model(stats, bounds)),
                          bits(t_pd.phase_a_plain(stats, bounds)))


def test_worklist_compaction_matches_jax():
    rng = np.random.default_rng(3)
    entry = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    entry[rng.uniform(size=entry.shape) < 0.8] = np.inf
    total = int(np.isfinite(entry).sum())
    jt, jc, jtot = j_pd.build_worklist(jnp.asarray(entry), entry.size)
    tt, tc = t_pd.build_worklist(torch.as_tensor(entry))
    assert int(jtot) == total == tt.shape[0]
    assert np.array_equal(np_(jt)[:total], np_(tt))
    assert np.array_equal(np_(jc)[:total], np_(tc))
    flat = np.isfinite(entry).reshape(-1)
    jsel, _ = j_pd.compact_indices(jnp.asarray(flat), flat.size)
    assert np.array_equal(np_(jsel)[:total],
                          np_(t_pd.compact_indices(torch.as_tensor(flat))))


@pytest.mark.parametrize("coherent,zero_dirs", [
    (False, True), (True, False), (False, False)])
def test_subgroup_stats_and_refine_match_jax(coherent, zero_dirs):
    """``bundle_stats`` at the subgroup and the tile sizes, on inverse
    directions read from the ray features as the query engines read them,
    against the JAX package's ``subgroup_stats``, and the refine on the
    subgroup stats, bit for bit."""
    js, ts = _scenes(C=64)
    o, d, t_min, t_max = _prepared(1024, 4, coherent, zero_dirs)
    G, TILE = 32, 256
    ja, ta = _both(o, d, t_min, t_max)
    rows = stage1_rows(*ta)
    for n in (8, G, TILE):
        assert np.array_equal(bits(j_pr.subgroup_stats(*ja, n)),
                              bits(t_pd.bundle_stats(*rows, n)))
    sj = j_pr.subgroup_stats(*ja, G)
    st = t_pd.bundle_stats(*rows, G)
    rng = np.random.default_rng(5)
    tids = rng.integers(0, 1024 // TILE, 300).astype(np.int32)
    cids = rng.integers(0, js.n_clusters, 300).astype(np.int32)
    fj = j_pr.refine_pairs(sj, jnp.asarray(tids), jnp.asarray(cids),
                           js.cluster_min, js.cluster_max, TILE // G,
                           1024 // TILE)
    ft = t_pr.refine_pairs(st, torch.as_tensor(tids), torch.as_tensor(cids),
                           ts.cluster_min, ts.cluster_max, TILE // G,
                           1024 // TILE)
    assert np.array_equal(bits(fj), bits(ft))
    assert 0 < np.isfinite(np_(ft)).sum() < ft.numel()


@pytest.mark.parametrize("C,G,SPB,coherent,blobby", [
    (128, 32, 16, True, False), (64, 32, 16, False, False),
    (128, 16, 32, False, False), (128, 32, 16, False, True)])
def test_stage1_blocks_match_jax(C, G, SPB, coherent, blobby):
    """The compact stage 1: same counts, the same first ``total`` blocks
    (cluster and subgroups), at exact capacities on the JAX side, and the
    same ray table."""
    js, ts = _scenes(C=C, blobby=blobby)
    arrays = _prepared(1024, 6, coherent, not coherent)
    R, TILE = len(arrays[0]), 256
    ja, ta = _both(*arrays)
    n_tiles, n_sub, K = R // TILE, R // G, js.n_clusters
    bcj, bsj, tblj, totals, _, _ = j_pr._stage1_cm(
        js, *ja, TILE=TILE, G=G, SPB=SPB, P_cap=n_tiles * K,
        Q_cap=n_sub * K, interpret=True)
    bct, bst, tblt, counts = t_pr._stage1_cm_core(ts, *ta, TILE, G, SPB)
    assert tuple(int(x) for x in np_(totals)) == counts
    nb = counts[2]
    assert nb > 0
    assert np.array_equal(np_(bcj)[:nb], np_(bct))
    assert np.array_equal(np_(bsj)[:nb], np_(bst))
    # The ray table: per-ray features plus the dummy subgroup.
    tblj, tblt = np_(tblj), np_(tblt)
    assert tblj.shape == tblt.shape
    assert np.array_equal(bits(tblj[-1]), bits(tblt[-1]))
    assert_ray_features_close(tblj[:-1].reshape(R, 16),
                              tblt[:-1].reshape(R, 16), *arrays[:2])


def test_pack_presorted_matches_jax():
    """Rank packing of a cluster-contiguous list, ragged cluster runs."""
    rng = np.random.default_rng(8)
    runs = rng.integers(1, 40, 12)
    cid = np.repeat(np.sort(rng.choice(50, 12, replace=False)), runs)
    sub = rng.integers(0, 90, cid.size)
    cid, sub = cid.astype(np.int32), sub.astype(np.int32)
    SPB, n_sub, K = 8, 90, 50
    valid = np.ones(cid.size, bool)
    B_cap = cid.size // SPB + K + 1
    bcj, bsj, tot = j_pr.pack_presorted_cluster_major(
        jnp.asarray(cid), jnp.asarray(sub), jnp.asarray(valid), SPB=SPB,
        n_sub=n_sub, B_cap=B_cap, K=K)
    bct, bst = t_pr.pack_presorted_cluster_major(
        torch.as_tensor(cid), torch.as_tensor(sub), SPB=SPB, n_sub=n_sub)
    assert int(tot) == bct.shape[0] == int(np.sum(-(-runs // SPB)))
    assert np.array_equal(np_(bcj)[:int(tot)], np_(bct))
    assert np.array_equal(np_(bsj)[:int(tot)], np_(bst))
