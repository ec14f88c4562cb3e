"""The subgroup refine (kernel K7's plain version and its arithmetic) on the
CPU.

``refine_pairs_model`` computes ``refine_pairs_plain`` as kernel K7 does
(``csrc/refine_pairs.cu`` with ``csrc/entry.cuh``): it must equal the
plain version bit for bit, +-0 and NaN included, on adversarial stats and
boxes and on a query's own operands. On CPU tensors ``refine_pairs`` is
the plain version and launches nothing.
"""
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu_torch.ops import dense as ops_dense
from raycore_tpu_torch.ops import instanced as ops_inst
from raycore_tpu_torch.ops import regroup as ops_regroup
from torch_adversarial import (PHASE_A_CASES, REFINE_PAIRS, REFINE_TILES,
                               morton_grid, refine_case, refine_operands,
                               stage1_rows)

def _bits(t):
    return t.contiguous().view(torch.int32)


def _refine_args(case, SPT, P):
    stats, tids, cids, cmin, cmax = (torch.as_tensor(a) for a in
                                     refine_case(case, SPT, P))
    return stats, tids, cids, cmin, cmax, SPT, REFINE_TILES


@pytest.mark.parametrize("case", PHASE_A_CASES + ("signed_zeros",))
@pytest.mark.parametrize("SPT", [16, 32, 64])
def test_refine_pairs_model_matches_plain_bitwise(SPT, case):
    """On each of tests/torch_adversarial.py's phase-A cases (non-finite
    stats, +-0 directions, clamped axes, padded and empty boxes, t_min_lo
    > t_max_hi, zero corner products of both signs), at each ragged P."""
    for P in REFINE_PAIRS:
        args = _refine_args(case, SPT, P)
        plain = ops_regroup.refine_pairs_plain(*args)
        model = ops_regroup.refine_pairs_model(*args)
        assert plain.shape == model.shape == (P, SPT)
        assert torch.equal(_bits(model), _bits(plain)), (case, SPT, P)


def test_refine_pairs_model_takes_both_paths():
    """The adversarial cases reach the fast arithmetic and the plain one,
    and the signed-zero case has entries of both zeros."""
    fast_share = []
    for case in ("base", "clamped", "nonfinite_col7"):
        stats, tids, cids, cmin, cmax, SPT, n_tiles = _refine_args(
            case, 32, 301)
        st = stats.reshape(n_tiles, SPT * 14)[tids.long()] \
            .reshape(-1, SPT, 14)
        _, fast = ops_dense.interval_entry_paths(
            st, cmin[cids.long()][:, None], cmax[cids.long()][:, None])
        fast_share.append(float(fast.float().mean()))
    assert fast_share[0] > 0.5 and min(fast_share) < 1.0
    entry = ops_regroup.refine_pairs_plain(*_refine_args("signed_zeros", 64,
                                                         301))
    zero = entry[entry == 0]
    assert bool(torch.signbit(zero).any()) and bool((~torch.signbit(zero))
                                                    .any())


def _incoherent(R, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    o[:, 2] = 2.0
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d[::7, 0] = 0.0
    d[1::7, 1] = -0.0
    d[2::7, 0] = 3e-6
    return rt.Ray.create(torch.as_tensor(o), torch.as_tensor(d))


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("tile,G", [(512, 32), (2048, 32), (256, 16)])
def test_refine_pairs_model_on_query_operands(tile, G, coherent):
    """A regrouped query's own operands at SPT 16 and 64: incoherent rays
    with +-0 and tiny direction components, and a Morton-ordered grid of
    downward rays, whose subgroups miss most of their tile's clusters."""
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device="cpu"),
                           cluster_size=32)
    rays = (rt.Ray.create(*(torch.as_tensor(a) for a in morton_grid(64)))
            if coherent else _incoherent(4096, 3))
    args = refine_operands(scene.cluster_min, scene.cluster_max, rays, tile,
                           G)
    plain = ops_regroup.refine_pairs_plain(*args)
    assert torch.equal(_bits(ops_regroup.refine_pairs_model(*args)),
                       _bits(plain))
    finite = int(torch.isfinite(plain).sum())
    assert 0 < finite <= plain.numel()
    if coherent:
        assert finite < plain.numel() // 2


def test_refine_pairs_on_cpu_is_the_plain_version():
    """On CPU tensors refine_pairs returns the plain version's bits,
    launches nothing and adds P*SPT to ``tested``; a query adds the
    finite entries it keeps to ``kept``."""
    args = _refine_args("base", 64, 301)
    launches = ops_regroup.refine_pairs.launches
    tested = ops_regroup.refine_pairs.tested
    got = ops_regroup.refine_pairs(*args)
    assert torch.equal(_bits(got),
                       _bits(ops_regroup.refine_pairs_plain(*args)))
    assert ops_regroup.refine_pairs.launches == launches
    assert ops_regroup.refine_pairs.tested == tested + 301 * 64

    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device="cpu"),
                           cluster_size=32)
    rays = rt.Ray.create(*(torch.as_tensor(a) for a in morton_grid(64)))
    o, d, t_min, t_max, _, G, TILE = ops_regroup._padded_batch(rays, 512,
                                                              32)
    tested = ops_regroup.refine_pairs.tested
    kept = ops_regroup.refine_pairs.kept
    P, sub, _, entry, _ = ops_regroup.subgroup_pairs(
        scene, *stage1_rows(o, d, t_min, t_max), TILE, G)
    assert ops_regroup.refine_pairs.tested == tested + P * (TILE // G)
    assert ops_regroup.refine_pairs.kept == kept + sub.shape[0]
    assert bool(torch.isfinite(entry).all())
    assert 0 < sub.shape[0] < P * (TILE // G)


def test_refine_pairs_model_on_instanced_operands():
    """The instanced engine's world-space refine: (tile, instance) pairs
    against the instance AABBs, on a Morton-ordered grid of rays."""
    rng = np.random.default_rng(1234)
    tlas = rt.TLAS(device="cpu")
    sph = rt.sphere_mesh(radius=1.0, n_theta=8, n_phi=16, device="cpu")
    for _ in range(12):
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.eye(3) * rng.uniform(0.4, 1.2)
        m[:, 3] = rng.uniform(-3, 3, 3)
        tlas.push(sph, m)
    scene = rt.bake_instanced(tlas, cluster_size=32)
    rays = rt.Ray.create(*(torch.as_tensor(a)
                           for a in morton_grid(64, half=4.5, z=6.0)))
    args = refine_operands(scene.inst_aabb_min, scene.inst_aabb_max, rays,
                           256, 8, tile_major=True)
    plain = ops_regroup.refine_pairs_plain(*args)
    assert torch.equal(_bits(ops_regroup.refine_pairs_model(*args)),
                       _bits(plain))
    assert 0 < int(torch.isfinite(plain).sum()) < plain.numel()
    assert ops_inst.refine_worklist is ops_regroup.refine_worklist
