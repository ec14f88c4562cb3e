"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and nvcc and skips without them; this
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu_torch.kernels import _build
from raycore_tpu_torch.ops import affine as ops_affine
from raycore_tpu_torch.ops import brute as ops_brute
from raycore_tpu_torch.ops import dense as ops_dense
from raycore_tpu_torch.ops import regroup as ops_regroup
from raycore_tpu_torch.tools import epilogue_experiments as t_epi
from raycore_tpu_torch.tools import gather_probe as t_gather
from raycore_tpu_torch.tools import probe_block_overhead as t_block
from raycore_tpu_torch.tools import probe_matmul_shapes as t_mm
from raycore_tpu_torch.tools._common import best_ms, check_equal
from torch_adversarial import (AFFINE_CASES, GATHER_CASES, PHASE_A_CASES,
                               REFINE_PAIRS, REFINE_TILES, affine_case,
                               affine_rays, block_probe_case, brute_case,
                               epilogue_probe_case, gather_case, morton_grid,
                               phase_a_case, phase_a_signed_zeros,
                               refine_case, refine_operands, stage1_rows)

pytestmark = pytest.mark.cuda

INT32_MAX = 0x7FFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _incoherent_rays(R, seed, device, zero_dirs=True):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    o[:, 2] = 2.0
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    if zero_dirs:                 # clamped inverse directions: the widen path
        d[::7, 0] = 0.0
        d[1::7, 1] = -0.0
        d[2::7, 0] = 3e-6
    return rt.Ray.create(torch.as_tensor(o, device=device),
                         torch.as_tensor(d, device=device))


def _stage1(scene, rays, tile, G, SPB):
    po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._padded_batch(
        rays, tile, G)
    return ops_regroup._stage1_cm_core(scene, po, pd, ptmin, ptmax, TILE, G,
                                       SPB)


@pytest.mark.parametrize("tile", [128, 512])
def test_phase_a_kernel_bitwise(cuda, tile):
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                           cluster_size=64)
    rays = _incoherent_rays(2048, 1, cuda)
    po, pd, ptmin, ptmax, _, _, TILE = ops_regroup._padded_batch(
        rays, tile, 32)
    stats, bounds = ops_dense.phase_a_inputs(
        *stage1_rows(po, pd, ptmin, ptmax), scene.cluster_min,
        scene.cluster_max, TILE)
    # A ragged cluster count with far-away padding bounds.
    bounds = torch.cat([bounds, torch.full((6, 37), 1e30, device=cuda)], 1)
    before = ops_dense.phase_a.launches
    ek = ops_dense.phase_a(stats, bounds)
    assert ops_dense.phase_a.launches == before + 1
    ep = ops_dense.phase_a_plain(stats, bounds)
    assert torch.equal(ek.view(torch.int32), ep.view(torch.int32))
    assert 0 < int(torch.isfinite(ek).sum()) < ek.numel()


@pytest.mark.parametrize("case", PHASE_A_CASES + ("signed_zeros",))
def test_phase_a_kernel_adversarial_bitwise(cuda, case):
    """K1 against its plain version and its model, bit for bit, on
    tests/torch_adversarial.py's stats and boxes (non-finite stats
    columns, +-0 directions, clamped axes, padded and empty boxes, t_min_lo
    > t_max_hi, zero corner products of both signs), with a tile count and
    K that are not whole strips and CTAs."""
    st, b = (phase_a_signed_zeros() if case == "signed_zeros"
             else phase_a_case(case))
    stats, bounds = (torch.as_tensor(a, device=cuda) for a in (st, b))
    ek = ops_dense.phase_a(stats, bounds)
    ep = ops_dense.phase_a_plain(stats, bounds)
    em = ops_dense.phase_a_model(stats, bounds)
    assert torch.equal(ek.view(torch.int32), ep.view(torch.int32))
    assert torch.equal(em.view(torch.int32), ep.view(torch.int32))


def _refine_kernel_check(args, coherent):
    """K7 once, bit for bit against its plain version and its model; no
    launch on an empty worklist."""
    before = ops_regroup.refine_pairs.launches
    ek = ops_regroup.refine_pairs(*args)
    assert ops_regroup.refine_pairs.launches == before + 1
    ep = ops_regroup.refine_pairs_plain(*args)
    em = ops_regroup.refine_pairs_model(*args)
    assert torch.equal(ek.view(torch.int32), ep.view(torch.int32))
    assert torch.equal(em.view(torch.int32), ep.view(torch.int32))
    finite = int(torch.isfinite(ek).sum())
    assert 0 < finite <= ek.numel()
    if coherent:
        assert finite < ek.numel()
    stats, tids, cids, *rest = args
    empty = ops_regroup.refine_pairs(stats, tids[:0], cids[:0], *rest)
    assert empty.shape == (0, rest[2])
    assert ops_regroup.refine_pairs.launches == before + 1


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("tile", [512, 2048])
def test_refine_pairs_kernel_bitwise(cuda, tile, coherent):
    """K7 on a regrouped batch at SPT 16 and 64 (G 32): incoherent rays
    with +-0 and tiny direction components, padded to whole tiles, and a
    Morton-ordered grid whose subgroups miss most of their tile's
    clusters."""
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                           cluster_size=32)
    if coherent:
        rays = rt.Ray.create(*(torch.as_tensor(a, device=cuda)
                               for a in morton_grid(64)))
    else:
        rays = _incoherent_rays(8000, 6, cuda)
    _refine_kernel_check(refine_operands(scene.cluster_min,
                                         scene.cluster_max, rays, tile, 32),
                         coherent)


@pytest.mark.parametrize("SPT", [16, 64])
@pytest.mark.parametrize("case", PHASE_A_CASES + ("signed_zeros",))
def test_refine_pairs_kernel_adversarial_bitwise(cuda, case, SPT):
    """K7 against its plain version and its model, bit for bit, on
    tests/torch_adversarial.py's phase-A cases as subgroup stats (non-
    finite stats columns, +-0 directions, clamped axes, padded and empty
    boxes, t_min_lo > t_max_hi, zero corner products of both signs), at
    pair counts that are not whole CTAs."""
    for P in REFINE_PAIRS:
        stats, tids, cids, cmin, cmax = (
            torch.as_tensor(a, device=cuda) for a in refine_case(case, SPT, P))
        args = (stats, tids, cids, cmin, cmax, SPT, REFINE_TILES)
        before = ops_regroup.refine_pairs.launches
        ek = ops_regroup.refine_pairs(*args)
        assert ops_regroup.refine_pairs.launches == before + (P > 0)
        ep = ops_regroup.refine_pairs_plain(*args)
        em = ops_regroup.refine_pairs_model(*args)
        assert ek.shape == (P, SPT)
        assert torch.equal(ek.view(torch.int32), ep.view(torch.int32))
        assert torch.equal(em.view(torch.int32), ep.view(torch.int32))


def test_refine_pairs_kernel_on_instanced_operands(cuda):
    """K7 on the instanced engine's world-space refine: its (tile,
    instance) worklist against the instance AABBs (inst_aabb_min/max), at
    the engine's tile 256 and G 8."""
    _, scene = _instanced_scene(cuda)
    for rays, coherent in (
            (_instanced_rays(2048, 5, cuda), False),
            (rt.Ray.create(*(torch.as_tensor(a, device=cuda) for a in
                             morton_grid(64, half=4.5, z=6.0))), True)):
        _refine_kernel_check(refine_operands(
            scene.inst_aabb_min, scene.inst_aabb_max, rays, 256, 8,
            tile_major=True), coherent)


@pytest.mark.parametrize("mesh,C,G,SPB", [("grid", 128, 32, 16),
                                          ("grid", 64, 16, 32),
                                          ("blobby", 512, 32, 16)])
def test_regroup_sweep_kernel_matches_plain(cuda, mesh, C, G, SPB):
    """Same blocks through the kernel and the plain bmm: padding blocks
    write the sentinels, hit masks agree, t agrees within rtol 2e-6 (the
    dot's summation order differs) and rows with equal keys name the same
    triangle. C=512 takes 80 KB of shared memory, past the 48 KB
    default."""
    tris = (rt.displaced_grid_mesh(n=40, device=cuda) if mesh == "grid"
            else rt.blobby_mesh(n_theta=64, n_phi=64, device=cuda))
    scene = rt.build_dense(tris, cluster_size=C)
    block_cid, block_subs, tbl, _ = _stage1(
        scene, _incoherent_rays(1024, 2, cuda), 512, G, SPB)
    pad = torch.full((3,), -1, dtype=torch.int32, device=cuda)
    block_cid = torch.cat([block_cid, pad])
    block_subs = torch.cat([block_subs, block_subs[:3]])
    kw = dict(G=G, SPB=SPB, C=C)
    before = ops_regroup.run_regrouped.launches
    kk, pk = ops_regroup.run_regrouped(block_subs, block_cid, tbl,
                                       scene.tri_feats, **kw)
    assert ops_regroup.run_regrouped.launches == before + 1
    kp, pp = ops_regroup.run_regrouped_plain(block_subs, block_cid, tbl,
                                             scene.tri_feats, **kw)
    tail = 3 * G * SPB
    assert bool((kk[-tail:] == INT32_MAX).all())
    assert bool((pk[-tail:] == -1).all())
    hk, hp = kk != INT32_MAX, kp != INT32_MAX
    assert int(hp.sum()) > 0
    assert torch.equal(hk, hp)
    tk, tp = kk[hk].view(torch.float32), kp[hk].view(torch.float32)
    torch.testing.assert_close(tk, tp, rtol=2e-6, atol=0)
    # Where the keys agree, the winning lane (smallest on ties) agrees.
    same_key = kk[hk] == kp[hk]
    assert torch.equal(pk[hk][same_key], pp[hk][same_key])


def test_closest_hit_on_card_matches_cpu_and_oracle(cuda):
    """The regrouped engine (K1, K7, K2) on the card. 1024 rays are below
    REGROUP_MIN_RAYS, so it is called directly, as dispatch calls it for
    large batches."""
    query = lambda s, r: ops_regroup.closest_hit_regrouped(s, r, tile=2048)
    tris_cpu = rt.displaced_grid_mesh(n=40, device="cpu")
    rays_cpu = _incoherent_rays(1024, 3, "cpu")
    ref = query(rt.build_dense(tris_cpu, cluster_size=128), rays_cpu)
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                           cluster_size=128)
    rays = _incoherent_rays(1024, 3, cuda)
    counts = (ops_dense.phase_a.launches, ops_regroup.run_regrouped.launches,
              ops_regroup.refine_pairs.launches)
    got = query(scene, rays)
    assert ops_dense.phase_a.launches == counts[0] + 1
    assert ops_regroup.run_regrouped.launches == counts[1] + 1
    assert ops_regroup.refine_pairs.launches == counts[2] + 1
    assert got.t.device.type == "cuda"
    oracle = rt.closest_hit_brute(scene.prims, rays)
    for other in (ref, oracle):
        h = other.hit.cpu()
        assert torch.equal(h, got.hit.cpu())
        torch.testing.assert_close(got.t.cpu()[h], other.t.cpu()[h],
                                   rtol=2e-5, atol=2e-6)
        differ = got.prim_idx.cpu()[h] != other.prim_idx.cpu()[h]
        if differ.any():
            rt_, gt = other.t.cpu()[h][differ], got.t.cpu()[h][differ]
            assert float(((gt - rt_).abs() / rt_.clamp_min(1e-6)).max()) \
                < 2e-6


def test_multiwave_on_card_matches_cpu(cuda):
    """The ordered multiwave (passes=4) on a small blobby: the card's
    result equals the CPU's (equal hit and prim, t within 2e-6), with K2
    launched on the wave grid and on the remainder grid."""
    o, d = morton_grid(64)
    res = {}
    for dev in ("cpu", cuda):
        scene = rt.build_dense(rt.blobby_mesh(64, 64, device=dev),
                               cluster_size=64)
        rays = rt.Ray.create(torch.as_tensor(o, device=dev),
                             torch.as_tensor(d, device=dev))
        before = ops_regroup.run_regrouped.launches
        res[str(dev)] = ops_regroup.closest_hit_regrouped(scene, rays,
                                                          passes=4)
    assert ops_regroup.run_regrouped.launches == before + 2
    ref, got = res["cpu"], res[str(cuda)]
    assert torch.equal(ref.hit, got.hit.cpu())
    assert torch.equal(ref.prim_idx, got.prim_idx.cpu())
    torch.testing.assert_close(got.t.cpu(), ref.t, rtol=2e-6, atol=0)
    assert 0.5 < float(ref.hit.float().mean()) < 1.0


def _worklist(scene, rays, tile):
    """The tile worklist of a query as the driver builds it."""
    o, d, t_min, t_max = ops_dense.flat_rays(rays)
    TILE = ops_dense._tile_of(rays, tile)
    tids, cids, phi, tmin, key0, _, _, _ = ops_dense._phase_a_and_worklist(
        scene, o, d, t_min, t_max, TILE=TILE)
    return tids, cids, phi, tmin, key0, TILE


def _worklist_scene(C, SUB, cuda):
    tris = rt.blobby_mesh(n_theta=64, n_phi=64, device=cuda)
    return rt.build_dense(tris, cluster_size=C, sub_chunks=SUB)


def _blobby_rays(R, seed, device):
    """Rays through the blob: several layers, hits and misses."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    o[:, 2] = 2.5
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d[::7, 0] = 0.0
    return rt.Ray.create(torch.as_tensor(o, device=device),
                         torch.as_tensor(d, device=device))


@pytest.mark.parametrize("TILE", [8, 100, 512])
@pytest.mark.parametrize("SUB", [1, 4])
@pytest.mark.parametrize("C", [64, 256, 512])
def test_worklist_sweep_kernel_matches_plain(cuda, C, SUB, TILE):
    """K3 against its plain version on a query's own worklist, seeded from
    t_max and then from a first pass (key0/pair0): equal hit masks, t
    within rtol 2e-6 (the dot's summation order differs) and equal pairs
    where the keys are equal. C=512 takes 80 KB of shared memory; TILE=8
    and 100 are not multiples of a warp."""
    scene = _worklist_scene(C, SUB, cuda)
    tids, cids, phi, tmin, key0, TILE = _worklist(
        scene, _blobby_rays(1000, 4, cuda), TILE)
    kw = dict(TILE=TILE, C=C, SUB=SUB)
    args = (tids, cids, phi, scene.tri_feats, scene.sub_bounds, tmin)
    bits = ops_dense._idx_bits(C // SUB)
    for pass_ in range(2):
        before = ops_dense.run_worklist.launches
        kk, pk = ops_dense.run_worklist(*args, key0, None if pass_ == 0
                                        else p_seed, **kw)
        assert ops_dense.run_worklist.launches == before + 1
        kp, pp = ops_dense.run_worklist_plain(
            *args, key0, torch.full_like(key0, -1) if pass_ == 0 else p_seed,
            **kw)
        hk, hp = pk >= 0, pp >= 0
        assert int(hp.sum()) > 0
        assert torch.equal(hk, hp)
        tk = ops_dense._t_from_keys(kk[hk], bits)
        tp = ops_dense._t_from_keys(kp[hk], bits)
        torch.testing.assert_close(tk, tp, rtol=2e-6, atol=0)
        same_key = kk == kp
        assert torch.equal(pk[same_key], pp[same_key])
        # Second pass: seed with the first pass's keys over half the
        # blocks, sweep the other half.
        key0, p_seed = kk, pk
        half = tids.shape[0] // 2
        args = (tids[half:].clone(), cids[half:].clone()) + args[2:]


@pytest.mark.parametrize("TILE", [8, 100, 512])
@pytest.mark.parametrize("SUB", [1, 4])
@pytest.mark.parametrize("C", [64, 256, 512])
def test_occlusion_sweep_kernel_matches_plain(cuda, C, SUB, TILE):
    """K4 against its plain version: equal occluders on every row."""
    scene = _worklist_scene(C, SUB, cuda)
    rays = _blobby_rays(1000, 5, cuda)
    tids, cids, phi, tmin, _, TILE = _worklist(scene, rays, TILE)
    tmax = torch.full_like(tmin, float("inf"))
    tmax[::3] = 2.6          # short rays: some free, some occluded
    before = ops_dense.run_occlusion.launches
    kw = dict(TILE=TILE, C=C, SUB=SUB)
    got = ops_dense.run_occlusion(tids, cids, phi, scene.tri_feats, tmin,
                                  tmax, **kw)
    assert ops_dense.run_occlusion.launches == before + 1
    ref = ops_dense.run_occlusion_plain(tids, cids, phi, scene.tri_feats,
                                        tmin, tmax, **kw)
    assert 0 < int((ref >= 0).sum()) < ref.numel()
    assert torch.equal(got, ref)


def _non_finite(phi):
    """phi with rays whose features are not finite: o x d overflowed, an
    infinite origin, a NaN direction."""
    phi = phi.clone()
    phi[3::97, 3:6] = float("inf")
    phi[5::97, 6] = float("inf")
    phi[7::97, 0] = float("nan")
    return phi


@pytest.mark.parametrize("case", ["plain", "empty_tile", "non_finite"])
@pytest.mark.parametrize("TILE", [8, 100, 512])
@pytest.mark.parametrize("SUB", [1, 4])
@pytest.mark.parametrize("C", [64, 256])
def test_worklist_sweep_kernel_matches_model(cuda, C, SUB, TILE, case):
    """K3 bit for bit against its kernel-order model on every tile, seeded
    from t_max and then from a first pass. ``empty_tile`` drops the blocks
    of tile 1, which must keep its seed; ``non_finite`` adds rays with
    non-finite features, which accept nothing. At SUB = 4 the slab skip
    decides some (block, sub-chunk) pairs."""
    scene = _worklist_scene(C, SUB, cuda)
    tids, cids, phi, tmin, key0, TILE = _worklist(
        scene, _blobby_rays(1000, 4, cuda), TILE)
    if case == "empty_tile":
        keep = tids != 1
        tids, cids = tids[keep].contiguous(), cids[keep].contiguous()
    if case == "non_finite":
        phi = _non_finite(phi)
    kw = dict(TILE=TILE, C=C, SUB=SUB)
    pair0 = torch.full_like(key0, -1)
    for pass_ in range(2):
        args = (tids, cids, phi, scene.tri_feats, scene.sub_bounds, tmin,
                key0, pair0)
        kk, pk = ops_dense.run_worklist(*args, **kw)
        km, pm = ops_dense.run_worklist_model(*args, **kw)
        assert torch.equal(kk, km) and torch.equal(pk, pm)
        assert int((pk >= 0).sum()) > 0
        if case == "empty_tile" and pass_ == 0:
            rows = slice(TILE, 2 * TILE)
            assert torch.equal(kk[rows], key0[rows])
            assert torch.equal(pk[rows], pair0[rows])
        if SUB > 1 and pass_ == 0:
            _, _, live = ops_dense.worklist_plain_live(*args, **kw)
            assert 0 < live < SUB * tids.numel()
        key0, pair0 = kk, pk
        half = tids.shape[0] // 2
        tids, cids = tids[half:].clone(), cids[half:].clone()


@pytest.mark.parametrize("case", ["plain", "occluded_tile", "non_finite"])
@pytest.mark.parametrize("TILE", [8, 100, 512])
@pytest.mark.parametrize("SUB", [1, 4])
@pytest.mark.parametrize("C", [64, 256])
def test_occlusion_sweep_kernel_matches_model(cuda, C, SUB, TILE, case):
    """K4 bit for bit against its kernel-order model. ``occluded_tile``:
    downward rays over a heightfield, so that whole tiles are occluded
    before their last block and the walk ends early; ``non_finite`` adds
    rays with non-finite features, which stay free."""
    if case == "occluded_tile":
        scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                               cluster_size=C, sub_chunks=SUB)
        xs = torch.linspace(-0.9, 0.9, 48, device=cuda)
        o = torch.stack(torch.meshgrid(xs, xs, indexing="ij") + (
            torch.full((48, 48), 3.0, device=cuda),), -1).reshape(-1, 3)
        rays = rt.Ray.create(o, torch.tensor([0.0, 0.0, -1.0], device=cuda)
                             .expand_as(o).contiguous())
    else:
        scene = _worklist_scene(C, SUB, cuda)
        rays = _blobby_rays(1000, 5, cuda)
    tids, cids, phi, tmin, _, TILE = _worklist(scene, rays, TILE)
    tmax = torch.full_like(tmin, float("inf"))
    if case != "occluded_tile":
        tmax[::3] = 2.6          # short rays: some free, some occluded
    if case == "non_finite":
        phi = _non_finite(phi)
    kw = dict(TILE=TILE, C=C, SUB=SUB)
    args = (tids, cids, phi, scene.tri_feats, tmin, tmax)
    got = ops_dense.run_occlusion(*args, **kw)
    assert torch.equal(got, ops_dense.run_occlusion_model(*args, **kw))
    assert int((got >= 0).sum()) > 0
    if case == "occluded_tile":
        n_tiles = got.numel() // TILE
        occluded = (got.reshape(n_tiles, TILE) >= 0).all(dim=1)
        blocks = torch.bincount(tids.long(), minlength=n_tiles)
        assert bool((occluded & (blocks > 1)).any())
    if case == "non_finite":
        bad = ~torch.isfinite(phi[:, :10]).all(dim=1)
        assert bool(bad.any()) and not bool((got[bad] >= 0).any())


def test_worklist_queries_on_card_match_cpu_and_oracle(cuda):
    """closest_hit and any_hit below REGROUP_MIN_RAYS go through K1, K3 and
    K4, agree with the same query on the CPU and with the oracle."""
    tris_cpu = rt.displaced_grid_mesh(n=40, device="cpu")
    scene_cpu = rt.build_dense(tris_cpu, cluster_size=128, sub_chunks=4)
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                           cluster_size=128, sub_chunks=4)
    rays_cpu = _incoherent_rays(1024, 6, "cpu")
    rays = _incoherent_rays(1024, 6, cuda)
    counts = (ops_dense.phase_a.launches, ops_dense.run_worklist.launches,
              ops_dense.run_occlusion.launches,
              ops_regroup.run_regrouped.launches)
    got = rt.closest_hit(scene, rays)
    occ = rt.any_hit(scene, rays)
    assert (ops_dense.phase_a.launches, ops_dense.run_worklist.launches,
            ops_dense.run_occlusion.launches,
            ops_regroup.run_regrouped.launches) == \
        (counts[0] + 2, counts[1] + 1, counts[2] + 1, counts[3])
    ref = rt.closest_hit(scene_cpu, rays_cpu)
    assert torch.equal(got.hit.cpu(), ref.hit)
    torch.testing.assert_close(got.t.cpu(), ref.t, rtol=2e-5, atol=2e-6)
    assert torch.equal(occ.hit.cpu(), rt.any_hit(scene_cpu, rays_cpu).hit)
    assert torch.equal(occ.hit, got.hit)
    oracle = rt.closest_hit_brute(scene.prims, rays)
    assert torch.equal(oracle.hit, got.hit)


@pytest.mark.parametrize("SUB,spb_sub,packs", [(4, 2, 8), (1, 2, 8),
                                                (4, 4, 4)])
def test_packed_sweep_kernel_matches_plain(cuda, SUB, spb_sub, packs):
    """K5 against its plain version on a query's own blocks at C=256:
    C_eff = 64 (SUB=4) and C_eff = 256 (SUB=1, each slice staged in four
    lane chunks). Extra q = -1 blocks make the block count not a multiple
    of PACKS and write the sentinels; dummy subgroup slots never hit; hit
    masks agree, t within rtol 2e-6 (the dot's summation order differs)
    and rows with equal keys name the same triangle."""
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                           cluster_size=256, sub_chunks=SUB)
    # Coherent rays, so that subgroups cull sub-chunks and sub-clusters
    # end in partly filled blocks.
    xs = torch.linspace(-0.9, 0.9, 64, device=cuda)
    o = torch.stack(torch.meshgrid(xs, xs, indexing="ij") + (
        torch.full((64, 64), 3.0, device=cuda),), -1).reshape(-1, 3)
    rays = rt.Ray.create(o, torch.tensor([0.0, 0.0, -1.0], device=cuda))
    po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._padded_batch(
        rays, 512, 32)
    bc, bs, tbl, _ = ops_regroup._stage1_packed_core(
        scene, po, pd, ptmin, ptmax, TILE, G, spb_sub)
    n_pad = 3 if (bc.shape[0] + 3) % packs else 4
    bc = torch.cat([bc, torch.full((n_pad,), -1, dtype=torch.int32,
                                   device=cuda)])
    bs = torch.cat([bs, bs[:n_pad]])
    kw = dict(G=G, SPB_sub=spb_sub, C_eff=256 // SUB, SUBC=SUB)
    before = ops_regroup.run_packed.launches
    kk, pk = ops_regroup.run_packed(bs, bc, tbl, scene.tri_feats,
                                    PACKS=packs, **kw)
    assert ops_regroup.run_packed.launches == before + 1
    kp, pp = ops_regroup.run_packed_plain(bs, bc, tbl, scene.tri_feats, **kw)
    tail = n_pad * G * spb_sub
    assert bool((kk[-tail:] == INT32_MAX).all())
    assert bool((pk[-tail:] == -1).all())
    dummy = (bs == tbl.shape[0] - 1).repeat_interleave(G, dim=1).reshape(-1)
    assert bool(dummy.any()) and bool((kk[dummy] == INT32_MAX).all())
    hk, hp = kk != INT32_MAX, kp != INT32_MAX
    assert int(hp.sum()) > 0
    assert torch.equal(hk, hp)
    tk, tp = kk[hk].view(torch.float32), kp[hk].view(torch.float32)
    torch.testing.assert_close(tk, tp, rtol=2e-6, atol=0)
    same_key = kk[hk] == kp[hk]
    assert torch.equal(pk[hk][same_key], pp[hk][same_key])


def _adversarial_table(tbl):
    """The ray table with rows K2 and K5 must refuse: non-finite features
    (``_non_finite``) and an empty or NaN t range."""
    tbl = tbl.clone()
    flat = tbl[:-1].reshape(-1, 16)
    flat[:, :10] = _non_finite(flat)[:, :10]
    flat[11::89, ops_regroup.COL_TMIN] = 5.0
    flat[11::89, ops_regroup.COL_TMAX] = 1.0
    flat[13::89, ops_regroup.COL_TMAX] = float("nan")
    return tbl


@pytest.mark.parametrize("mesh,C,G,SPB", [("grid", 128, 32, 16),
                                          ("grid", 64, 16, 32),
                                          ("blobby", 512, 32, 16)])
def test_regroup_sweep_kernel_matches_model(cuda, mesh, C, G, SPB):
    """K2 bit for bit against its kernel-order model on every block of a
    query: padding blocks (cid -1), dummy subgroup slots, rays with
    non-finite features and empty t ranges; K5 at one sub-chunk per
    cluster and PACKS 1 gives the same bits."""
    tris = (rt.displaced_grid_mesh(n=40, device=cuda) if mesh == "grid"
            else rt.blobby_mesh(n_theta=64, n_phi=64, device=cuda))
    scene = rt.build_dense(tris, cluster_size=C)
    block_cid, block_subs, tbl, _ = _stage1(
        scene, _incoherent_rays(1024, 2, cuda), 512, G, SPB)
    block_cid = torch.cat([block_cid, torch.full((3,), -1, dtype=torch.int32,
                                                 device=cuda)])
    block_subs = torch.cat([block_subs, block_subs[:3]])
    tbl = _adversarial_table(tbl)
    args = (block_subs, block_cid, tbl, scene.tri_feats)
    kk, pk = ops_regroup.run_regrouped(*args, G=G, SPB=SPB, C=C)
    km, pm = ops_regroup.run_regrouped_model(*args, G=G, SPB=SPB, C=C)
    assert torch.equal(kk, km) and torch.equal(pk, pm)
    assert int((pk >= 0).sum()) > 0
    k5, p5 = ops_regroup.run_packed(*args, G=G, SPB_sub=SPB, PACKS=1,
                                    C_eff=C, SUBC=1)
    assert torch.equal(k5, kk) and torch.equal(p5, pk)


def _instanced_scene(device, n_inst=12, C=32, seed=1234):
    """tests/test_instanced_engine.py's scene: spheres and boxes under
    random scaled rotations about z, baked at cluster size C."""
    rng = np.random.default_rng(seed)
    tlas = rt.TLAS(device=device)
    sph = rt.sphere_mesh(radius=1.0, n_theta=8, n_phi=16, device=device)
    box = rt.box_mesh(device=device)
    for i in range(n_inst):
        s, th = rng.uniform(0.4, 1.2), rng.uniform(0, 2 * np.pi)
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                             [np.sin(th), np.cos(th), 0], [0, 0, 1]]) * s
        m[:, 3] = rng.uniform(-3, 3, 3)
        tlas.push(sph if i == 0 or i % 2 else box, m)
    return tlas, rt.bake_instanced(tlas, cluster_size=C)


def _instanced_rays(n, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.5, 4.5, (n, 3)).astype(np.float32)
    o[:, 2] = -6.0
    d = rng.uniform(-3, 3, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return rt.Ray.create(torch.as_tensor(o, device=device),
                         torch.as_tensor(d.astype(np.float32), device=device))


def _instanced_stage1(scene, rays, tile=256, G=8, SPB=16):
    from raycore_tpu_torch.ops import instanced as ops_inst
    po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._padded_batch(
        rays, tile, G)
    return ops_inst._stage1_inst_core(scene, po, pd, ptmin, ptmax, TILE, G,
                                      SPB), G


@pytest.mark.parametrize("C", [32, 128])
def test_regroup_sweep_pairrow_kernel_matches_model(cuda, C):
    """K2 in its pairrow mode on an instanced query's blocks plus padding
    blocks, on the adversarial ray table: bit for bit against
    run_regrouped_model(payload="pairrow"); against the plain version
    within rtol 2e-6 with equal pair ids where the keys are equal; its
    keys are the prim mode's, and both modes name the same lane."""
    _, scene = _instanced_scene(cuda, C=C)
    s1, G = _instanced_stage1(scene, _instanced_rays(2048, 5, cuda))
    SPB = 16
    block_cid = torch.cat([s1.block_cid, torch.full(
        (3,), -1, dtype=torch.int32, device=cuda)])
    block_subs = torch.cat([s1.block_subs, s1.block_subs[:3]])
    for tbl in (s1.tbl, _adversarial_table(s1.tbl)):
        args = (block_subs, block_cid, tbl, scene.tri_feats)
        kw = dict(G=G, SPB=SPB, C=C)
        before = ops_regroup.run_regrouped.launches
        kk, pk = ops_regroup.run_regrouped(*args, **kw, payload="pairrow")
        assert ops_regroup.run_regrouped.launches == before + 1
        km, pm = ops_regroup.run_regrouped_model(*args, **kw,
                                                 payload="pairrow")
        assert torch.equal(kk, km) and torch.equal(pk, pm)
        hit = pk >= 0
        assert int(hit.sum()) > 0
        rows = torch.arange(pk.numel(), device=cuda)
        assert torch.equal((pk[hit] // C), rows[hit] // G)
        kp, pp = ops_regroup.run_regrouped(*args, **kw)
        assert torch.equal(kp, kk)
        assert torch.equal(pp[hit] % C, pk[hit] % C)
    kq, pq = ops_regroup.run_regrouped_plain(block_subs, block_cid, s1.tbl,
                                             scene.tri_feats, G=G, SPB=SPB,
                                             C=C, payload="pairrow")
    kk, pk = ops_regroup.run_regrouped(block_subs, block_cid, s1.tbl,
                                       scene.tri_feats, G=G, SPB=SPB, C=C,
                                       payload="pairrow")
    hk, hq = kk != INT32_MAX, kq != INT32_MAX
    assert torch.equal(hk, hq)
    torch.testing.assert_close(kk[hk].view(torch.float32),
                               kq[hk].view(torch.float32), rtol=2e-6, atol=0)
    same = kk == kq
    assert torch.equal(pk[same], pq[same])


def test_regroup_sweep_pairrow_range_is_checked(cuda):
    """A pairrow grid whose largest id, n_blocks*SPB*C - 1, passes int32
    raises ValueError before anything is allocated or launched."""
    SPB, C, G = 16, 2048, 8
    nb = (1 << 31) // (SPB * C) + 1
    subs = torch.zeros((nb, SPB), dtype=torch.int32, device=cuda)
    cid = torch.zeros((nb,), dtype=torch.int32, device=cuda)
    tbl = torch.zeros((2, G, 16), device=cuda)
    feats = torch.zeros((1, 16, 4 * C), device=cuda)
    before = ops_regroup.run_regrouped.launches
    with pytest.raises(ValueError, match="int32"):
        ops_regroup.run_regrouped(subs, cid, tbl, feats, G=G, SPB=SPB, C=C,
                                  payload="pairrow")
    assert ops_regroup.run_regrouped.launches == before


def test_instanced_query_on_card_matches_cpu_and_traversal(cuda):
    """closest_hit on a DenseInstancedScene launches K1, K7 and K2 once
    each and meets the engine contract against the same query on the CPU
    (the plain versions) and the traversal on the card."""
    tlas_c, scene_c = _instanced_scene("cpu")
    tlas, scene = _instanced_scene(cuda)
    ref = rt.closest_hit(scene_c, _instanced_rays(2048, 5, "cpu"))
    rays = _instanced_rays(2048, 5, cuda)
    counts = (ops_dense.phase_a.launches, ops_regroup.run_regrouped.launches,
              ops_regroup.refine_pairs.launches)
    got = rt.closest_hit(scene, rays)
    assert ops_dense.phase_a.launches == counts[0] + 1
    assert ops_regroup.run_regrouped.launches == counts[1] + 1
    assert ops_regroup.refine_pairs.launches == counts[2] + 1
    assert got.t.device.type == "cuda"
    trav = rt.closest_hit(tlas.sync(), rays)
    trav_c = rt.closest_hit(tlas_c.sync(), _instanced_rays(2048, 5, "cpu"))
    assert torch.equal(trav.hit.cpu(), trav_c.hit)
    torch.testing.assert_close(trav.t.cpu()[trav_c.hit], trav_c.t[trav_c.hit],
                               rtol=2e-5, atol=2e-6)
    h = ref.hit
    assert torch.equal(h, got.hit.cpu()) and int(h.sum()) > 50
    torch.testing.assert_close(got.t.cpu()[h], ref.t[h], rtol=2e-5,
                               atol=2e-6)
    differ = (got.prim_idx.cpu()[h] != ref.prim_idx[h]) \
        | (got.instance_idx.cpu()[h] != ref.instance_idx[h])
    if differ.any():
        rt_, gt = ref.t[h][differ], got.t.cpu()[h][differ]
        assert float(((gt - rt_).abs() / rt_.clamp_min(1e-6)).max()) < 2e-6
    torch.testing.assert_close(got.t.cpu()[h], trav.t.cpu()[h], rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(rt.any_hit(scene, rays).hit, got.hit)


# K8: the instanced frame's affine arithmetic (ops/affine.py).

def _bits_equal(a, b):
    """Equal shapes and bits (float32 compared as int32)."""
    if a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return torch.equal(a, b)


def _affine_tables(case, device):
    return tuple(torch.as_tensor(a, device=device) for a in affine_case(case))


@pytest.mark.parametrize("case", AFFINE_CASES)
def test_refresh_tables_kernel_bitwise(cuda, case):
    """K8's refresh once, bit for bit against its plain version on the
    card (mat3x4_inverse(fused=True) and transformed_aabbs, whose fused
    multiply-adds are core/triangle.py:fma's float64 emulation) and its
    inverses against the plain version on the CPU: the benchmark cell's
    poses, random scaled rotations with translations up to 1e6, |det|
    about 1e-30, and signed permutations with +-0 and subnormal entries
    under boxes with -0 and +0 faces, whose corners tie at zeros of both
    signs (the min and max keep the zero PyTorch's amin and amax keep on
    the card)."""
    args = _affine_tables(case, cuda)
    before = ops_affine.refresh_tables.launches
    got = ops_affine.refresh_tables(*args)
    assert ops_affine.refresh_tables.launches == before + 1
    want = ops_affine.refresh_tables_plain(*args)
    for g, w, name in zip(got, want, ("inst_inv", "aabb_min", "aabb_max")):
        assert _bits_equal(g, w), name
    inv_cpu = ops_affine.refresh_tables_plain(*(a.cpu() for a in args))[0]
    assert _bits_equal(got[0].cpu(), inv_cpu)
    if case == "signed_zeros":
        for b in got[1:]:
            z = b == 0
            assert int((z & torch.signbit(b)).sum()) > 0
            assert int((z & ~torch.signbit(b)).sum()) > 0


@pytest.mark.parametrize("case", AFFINE_CASES)
@pytest.mark.parametrize("mode", ["pairs8", "pairs32", "rays"])
def test_local_rays_kernel_bitwise(cuda, mode, case):
    """K8's local rays once, bit for bit against the plain version on the
    card and on the CPU, through each case's inverses, on rays with +-0 and subnormal
    direction components: pair mode at G 8 and 32 (random subgroups and
    instances, a row count that is not a whole number of CTAs; -0 in d_l
    becomes +0, t_min and t_max ride along), ray mode with instance -1
    among the ids (it reads instance 0; d_l keeps -0, which the cell's
    identity rotations leave on some rays)."""
    inv = ops_affine.refresh_tables_plain(*_affine_tables(case, "cpu"))[0]
    inv = inv.to(cuda)
    I, R = inv.shape[0], 4096
    rng = np.random.default_rng(3)
    o, d = (torch.as_tensor(a, device=cuda) for a in affine_rays(R, 5))
    if mode == "rays":
        inst = torch.as_tensor(rng.integers(-1, I, R), device=cuda)
        pairs, n = None, R
    else:
        G, Q = int(mode[5:]), 777
        ids = lambda hi: torch.as_tensor(rng.integers(0, hi, Q),
                                         dtype=torch.int32, device=cuda)
        sub, inst = ids(R // G), ids(I)
        t_min = torch.as_tensor(rng.uniform(0, 1, R).astype(np.float32),
                                device=cuda)
        t_max = torch.full((R,), float("inf"), device=cuda)
        t_max[::3] = -float("inf")
        pairs, n = (sub, t_min, t_max, G), Q * G
    before = (ops_affine.local_rays.launches, ops_affine.local_rays.rows)
    got = ops_affine.local_rays(inv, inst, o, d, pairs)
    assert ops_affine.local_rays.launches == before[0] + 1
    assert ops_affine.local_rays.rows == before[1] + n
    want = ops_affine.local_rays_plain(inv, inst, o, d, pairs)
    on_cpu = lambda a: a.cpu() if torch.is_tensor(a) else a
    cpu = ops_affine.local_rays_plain(
        inv.cpu(), inst.cpu(), o.cpu(), d.cpu(),
        None if pairs is None else tuple(map(on_cpu, pairs)))
    assert len(got) == len(want) == (2 if pairs is None else 4)
    for g, w, c in zip(got, want, cpu):
        assert _bits_equal(g, w)
        assert _bits_equal(g.cpu(), c)
    neg_zero = int(((got[1] == 0) & torch.signbit(got[1])).sum())
    if pairs is not None:
        assert neg_zero == 0
    elif case == "cell_poses":
        assert neg_zero > 0


def test_affine_kernels_launch_nothing_on_empty_grids(cuda):
    """No instance, no pair (Q = 0) and no ray (N = 0): empty results of
    the right shapes and no launch."""
    tf, lo, hi = _affine_tables("random", cuda)
    o, d = (torch.as_tensor(a, device=cuda) for a in affine_rays(64, 1))
    inv = ops_affine.refresh_tables_plain(tf, lo, hi)[0]
    e32 = torch.zeros((0,), dtype=torch.int32, device=cuda)
    t = torch.zeros((64,), device=cuda)
    before = (ops_affine.refresh_tables.launches,
              ops_affine.local_rays.launches)
    got = ops_affine.refresh_tables(tf[:0], lo[:0], hi[:0])
    assert [tuple(g.shape) for g in got] == [(0, 3, 4), (0, 3), (0, 3)]
    got = ops_affine.local_rays(inv, e32, o, d, (e32, t, t, 8))
    assert [tuple(g.shape) for g in got] == [(0, 3), (0, 3), (0,), (0,)]
    got = ops_affine.local_rays(inv, e32.long(), o[:0], d[:0])
    assert [tuple(g.shape) for g in got] == [(0, 3), (0, 3)]
    assert (ops_affine.refresh_tables.launches,
            ops_affine.local_rays.launches) == before


def test_instanced_frame_on_card_equals_cpu_bitwise(cuda, monkeypatch):
    """A frame of _instanced_scene (every instance moved, refresh_instances,
    closest_hit): on the card K8 once in the refresh and twice in the
    query (stage 1's pair rows, the finalize's rays) and the fma
    emulation never called. What K8 wrote (the refreshed tables, the
    local rays) is bit for bit what the CPU run of the same frame
    computed; hit, prim and instance are bit for bit the CPU's and t is
    within the engine contract of it (the finalize's PyTorch arithmetic
    on those same local rays rounds t and the barycentrics differently
    on the two devices); hit, prim, instance, t and the barycentrics are
    bit for bit the card's frame with K8's plain versions in its
    place."""
    from raycore_tpu_torch.core import triangle as core_tri
    from raycore_tpu_torch.ops import instanced as ops_inst
    from raycore_tpu_torch.scene import instanced as scene_inst
    emulated, written = [], []
    fma = core_tri.fma
    monkeypatch.setattr(core_tri, "fma",
                        lambda *a: emulated.append(1) or fma(*a))

    def recording(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            written.extend(x.cpu() for x in out)
            return out
        return call

    def frame(device, refresh, local):
        """The frame's result, what the refresh and the local rays wrote,
        and the fma emulation's calls in them."""
        monkeypatch.setattr(scene_inst, "refresh_tables", recording(refresh))
        monkeypatch.setattr(ops_inst, "local_rays", recording(local))
        tlas, scene = _instanced_scene(device)
        rng = np.random.default_rng(9)
        for hid in list(tlas._handles):
            rec = tlas._instances[tlas._handles[hid][0]]
            m = rec.transform.copy()
            m[:, 3] += rng.uniform(-0.2, 0.2, 3).astype(np.float32)
            tlas.update_transform(rt.TLASHandle(hid), m)
        rays = _instanced_rays(2048, 5, device)
        calls = len(emulated)
        del written[:]
        res = rt.closest_hit(rt.refresh_instances(scene, tlas), rays)
        return res, list(written), len(emulated) - calls

    kernel = (ops_affine.refresh_tables, ops_affine.local_rays)
    plain = (ops_affine.refresh_tables_plain, ops_affine.local_rays_plain)
    ref, ref_written, _ = frame("cpu", *kernel)
    before = (ops_affine.refresh_tables.launches,
              ops_affine.local_rays.launches)
    got, got_written, n_fma = frame(cuda, *kernel)
    assert (ops_affine.refresh_tables.launches,
            ops_affine.local_rays.launches) == (before[0] + 1, before[1] + 2)
    assert n_fma == 0
    assert len(got_written) == len(ref_written) == 3 + 4 + 2
    for i, (g, r) in enumerate(zip(got_written, ref_written)):
        assert _bits_equal(g, r), i
    card_plain, _, n_fma = frame(cuda, *plain)
    assert n_fma > 0 and int(ref.hit.sum()) > 50
    for f in ("hit", "prim_idx", "instance_idx", "t", "barycentric"):
        assert _bits_equal(getattr(got, f), getattr(card_plain, f)), f
    for f in ("hit", "prim_idx", "instance_idx"):
        assert _bits_equal(getattr(got, f).cpu(), getattr(ref, f)), f
    torch.testing.assert_close(got.t.cpu(), ref.t, rtol=2e-5, atol=2e-6)


def test_refresh_on_card_dispatches_few_operations(cuda, monkeypatch):
    """refresh_instances on the card: at most 8 ATen operations that are
    not views (the upload, one allocation, the root box's amin, amax and
    stack), none of them on float64, and core/triangle.py:fma never
    called."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from raycore_tpu_torch.core import triangle as core_tri

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                self.ops.append((str(func), getattr(out, "dtype", None)))
            return out

    tlas, scene = _instanced_scene(cuda)
    rt.refresh_instances(scene, tlas)
    monkeypatch.setattr(core_tri, "fma", None)
    mode = Ops()
    with mode:
        rt.refresh_instances(scene, tlas)
    assert 0 < len(mode.ops) <= 8, mode.ops
    assert all(dt != torch.float64 for _, dt in mode.ops), mode.ops


@pytest.mark.parametrize("SUB,spb_sub,packs,lane_chunk", [
    (4, 2, 8, 64), (1, 2, 8, 64), (1, 2, 8, 256), (4, 4, 4, 64)])
def test_packed_sweep_kernel_matches_model(cuda, SUB, spb_sub, packs,
                                           lane_chunk):
    """K5 bit for bit against its kernel-order model at C=256 on a query's
    own blocks with q = -1 blocks (a count that is not a multiple of
    PACKS), dummy slots and adversarial rays; at C_eff = 256 in 64-lane
    chunks and with the slice staged whole."""
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                           cluster_size=256, sub_chunks=SUB)
    xs = torch.linspace(-0.9, 0.9, 64, device=cuda)
    o = torch.stack(torch.meshgrid(xs, xs, indexing="ij") + (
        torch.full((64, 64), 3.0, device=cuda),), -1).reshape(-1, 3)
    rays = rt.Ray.create(o, torch.tensor([0.0, 0.0, -1.0], device=cuda))
    po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._padded_batch(
        rays, 512, 32)
    bc, bs, tbl, _ = ops_regroup._stage1_packed_core(
        scene, po, pd, ptmin, ptmax, TILE, G, spb_sub)
    n_pad = 3 if (bc.shape[0] + 3) % packs else 4
    bc = torch.cat([bc, torch.full((n_pad,), -1, dtype=torch.int32,
                                   device=cuda)])
    bs = torch.cat([bs, bs[:n_pad]])
    tbl = _adversarial_table(tbl)
    kw = dict(G=G, SPB_sub=spb_sub, C_eff=256 // SUB, SUBC=SUB)
    kk, pk = ops_regroup.run_packed(bs, bc, tbl, scene.tri_feats,
                                    PACKS=packs, lane_chunk=lane_chunk, **kw)
    km, pm = ops_regroup.run_packed_model(bs, bc, tbl, scene.tri_feats, **kw)
    assert torch.equal(kk, km) and torch.equal(pk, pm)
    assert int((pk >= 0).sum()) > 0
    assert bool((bs == tbl.shape[0] - 1).any())


def test_sweeps_of_dead_warps_write_the_miss_sentinels(cuda):
    """Blocks whose every slot is the dummy subgroup (a whole warp, and a
    whole CTA, of dead rows) beside real blocks: K2 and K5 write INT32_MAX
    and -1 there and the real blocks' rows are unchanged."""
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                           cluster_size=128)
    bc, bs, tbl, _ = _stage1(scene, _incoherent_rays(1024, 2, cuda), 512,
                             32, 16)
    n_sub = tbl.shape[0] - 1
    dead_bs = torch.cat([torch.full_like(bs[:4], n_sub), bs])
    dead_bc = torch.cat([bc[:4], bc])
    args = (scene.tri_feats,)
    for run in (lambda s, c: ops_regroup.run_regrouped(
                    s, c, tbl, *args, G=32, SPB=16, C=128),
                lambda s, c: ops_regroup.run_packed(
                    s, c, tbl, *args, G=32, SPB_sub=16, PACKS=1, C_eff=128,
                    SUBC=1)):
        kk, pk = run(dead_bs, dead_bc)
        rows = 4 * 32 * 16
        assert bool((kk[:rows] == INT32_MAX).all())
        assert bool((pk[:rows] == -1).all())
        k0, p0 = run(bs, bc)
        assert torch.equal(kk[rows:], k0) and torch.equal(pk[rows:], p0)
        assert int((p0 >= 0).sum()) > 0


def test_sweep_wrappers_refuse_a_wider_slack(cuda, monkeypatch):
    """K2 and K5 refuse an edge slack wider than quick_reject's margins
    assume (REJECT_EDGE_LO, REJECT_EDGE_HI), and K5 a lane chunk that is
    not a multiple of 4 or whose slices pass the shared memory."""
    tbl = torch.zeros((3, 8, 16), device=cuda)
    feats = torch.zeros((2, 16, 64), device=cuda)
    subs = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    cid = torch.zeros((1,), dtype=torch.int32, device=cuda)
    kw = dict(G=8, SPB_sub=2, PACKS=1, C_eff=16, SUBC=1)
    ops_regroup.run_regrouped(subs, cid, tbl, feats, G=8, SPB=2, C=16)
    for chunk in (6, 0):
        with pytest.raises(RuntimeError, match="packed_sweep"):
            ops_regroup.run_packed(subs, cid, tbl, feats, lane_chunk=chunk,
                                   **kw)
    big = torch.zeros((1, 16, 4 * 1024), device=cuda)
    with pytest.raises(RuntimeError, match="packed_sweep"):
        ops_regroup.run_packed(subs, cid, tbl, big, G=8, SPB_sub=2, PACKS=4,
                               C_eff=1024, SUBC=1, lane_chunk=1024)
    monkeypatch.setattr(ops_regroup, "EDGE_EPS", 2e-5)
    with pytest.raises(RuntimeError, match="regroup_sweep"):
        ops_regroup.run_regrouped(subs, cid, tbl, feats, G=8, SPB=2, C=16)
    with pytest.raises(RuntimeError, match="packed_sweep"):
        ops_regroup.run_packed(subs, cid, tbl, feats, **kw)


def _pinhole_rays(side, device, dist=3.0, half=0.5):
    """A side x side pinhole camera at (0, 0, dist) looking down -z over
    [-half, half]^2 on the plane at distance 1; no ray has x or y = 0."""
    s = (np.arange(side, dtype=np.float32) + 0.5) / side * 2 * half - half
    X, Y = np.meshgrid(s, s, indexing="ij")
    d = np.stack([X, Y, -np.ones_like(X)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.array([0, 0, dist], np.float32), d.shape)
    return (torch.as_tensor(np.ascontiguousarray(o), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


@pytest.mark.parametrize("padded", [False, True])
def test_brute_sweep_kernel_bitwise(cuda, padded):
    """K6 against its plain version, bit for bit, on 1000 rays (not a
    multiple of RAY_TILE) against a 1,840-triangle sphere (not a multiple
    of TRI_BLOCK) with t ranges, and on the zero-padded table."""
    tris = rt.sphere_mesh(n_theta=24, n_phi=40, device=cuda)
    T = tris.vertices.shape[0]
    table = ops_brute.make_tri_table(tris)
    if not padded:
        table = table[:, :T].contiguous()
    o, d = _pinhole_rays(32, cuda)
    o, d = o[:1000].contiguous(), d[:1000].contiguous()
    t_min = torch.zeros(1000, device=cuda)
    t_max = torch.full((1000,), float("inf"), device=cuda)
    t_min[::5] = 2.5
    t_max[1::5] = 2.2
    before = ops_brute.run_brute.launches
    got = ops_brute.run_brute(table, o, d, t_min, t_max)
    assert ops_brute.run_brute.launches == before + 1
    ref = ops_brute.run_brute_plain(table, o, d, t_min, t_max)
    assert 0 < int((ref[1] >= 0).sum()) < 1000
    for g, r in zip(got, ref):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("table", ["ragged", "padded"])
def test_brute_sweep_kernel_adversarial_bitwise(cuda, table):
    """K6 against its plain version and its model, bit for bit, on
    tests/torch_adversarial.py's set: degenerate triangles (det +-0,
    subnormal, inf, NaN), rays through shared edges and vertices, +-0
    directions, empty and NaN t ranges, NaN origins; 300 rays (not a whole
    CTA or warp of rays), the table ragged or zero-padded to TRI_BLOCK."""
    tbl, o, d, t_min, t_max = (torch.as_tensor(a, device=cuda)
                               for a in brute_case())
    if table == "padded":
        pad = -tbl.shape[1] % ops_brute.TRI_BLOCK
        tbl = torch.cat([tbl, torch.zeros((9, pad), device=cuda)], 1)
    got = ops_brute.run_brute(tbl, o, d, t_min, t_max)
    ref = ops_brute.run_brute_plain(tbl, o, d, t_min, t_max)
    model = ops_brute.run_brute_model(tbl, o, d, t_min, t_max)
    assert 0 < int((ref[1] >= 0).sum()) < o.shape[0]
    for g, r, m in zip(got, ref, model):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert torch.equal(m.view(torch.int32), r.view(torch.int32))


def test_packed_and_brute_queries_on_card_match_cpu(cuda):
    """closest_hit_packed (K1, K7, K5) and closest_hit_brute_pallas (K6) on the
    card against the same queries on the CPU: the packed engine within
    the engine contract's rtol 2e-5 on t, the dense sweep bit for bit."""
    scene_cpu = rt.build_dense(rt.displaced_grid_mesh(n=40, device="cpu"),
                               cluster_size=128, sub_chunks=4)
    scene = rt.build_dense(rt.displaced_grid_mesh(n=40, device=cuda),
                           cluster_size=128, sub_chunks=4)
    rays_cpu = _incoherent_rays(1024, 8, "cpu")
    rays = _incoherent_rays(1024, 8, cuda)
    counts = (ops_dense.phase_a.launches, ops_regroup.run_packed.launches,
              ops_regroup.refine_pairs.launches)
    got = rt.closest_hit_packed(scene, rays)
    assert (ops_dense.phase_a.launches, ops_regroup.run_packed.launches,
            ops_regroup.refine_pairs.launches) \
        == (counts[0] + 1, counts[1] + 1, counts[2] + 1)
    ref = rt.closest_hit_packed(scene_cpu, rays_cpu)
    assert torch.equal(got.hit.cpu(), ref.hit) and bool(ref.hit.any())
    torch.testing.assert_close(got.t.cpu(), ref.t, rtol=2e-5, atol=2e-6)
    assert torch.equal(rt.closest_hit_brute(scene.prims, rays).hit, got.hit)

    tris = rt.sphere_mesh(n_theta=16, n_phi=24, device=cuda)
    tris_cpu = rt.sphere_mesh(n_theta=16, n_phi=24, device="cpu")
    o, d = _pinhole_rays(33, cuda)
    before = ops_brute.run_brute.launches
    got = rt.closest_hit_brute_pallas(tris, rt.Ray.create(o, d))
    assert ops_brute.run_brute.launches == before + 1
    ref = rt.closest_hit_brute_pallas(tris_cpu,
                                      rt.Ray.create(o.cpu(), d.cpu()))
    assert 0 < int(ref.hit.sum()) < ref.hit.numel()
    for f in ("hit", "prim_idx", "instance_idx"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f))
    for f in ("t", "barycentric"):
        assert torch.equal(getattr(got, f).cpu().view(torch.int32),
                           getattr(ref, f).view(torch.int32))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    stats = torch.zeros((4, 16), device=cuda)
    bounds = torch.zeros((6, 8), device=cuda)
    with pytest.raises(TypeError):
        ops_dense.phase_a(stats.double(), bounds)
    with pytest.raises(ValueError):
        ops_dense.phase_a(torch.zeros((16, 4), device=cuda).T, bounds)
    tbl = torch.zeros((3, 8, 16), device=cuda)
    feats = torch.zeros((2, 16, 64), device=cuda)
    subs = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    cid = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops_regroup.run_regrouped(subs.long(), cid, tbl, feats, G=8, SPB=2,
                                  C=16)
    with pytest.raises(ValueError):
        ops_regroup.run_regrouped(subs, cid, tbl, feats, G=8, SPB=2, C=18)
    with pytest.raises(ValueError, match="1024"):
        ops_regroup.run_packed(subs, cid, tbl, feats, G=8, SPB_sub=2,
                               PACKS=128, C_eff=4, SUBC=4)
    with pytest.raises(ValueError, match="shapes"):
        ops_regroup.run_packed(subs, cid, tbl, feats, G=8, SPB_sub=2,
                               PACKS=4, C_eff=8, SUBC=4)
    ids = torch.zeros((1,), dtype=torch.int32, device=cuda)
    phi = torch.zeros((2048, 16), device=cuda)
    rows = torch.zeros((2048,), device=cuda)
    keys = torch.zeros((2048,), dtype=torch.int32, device=cuda)
    sb = torch.zeros((2, 1, 128), device=cuda)
    with pytest.raises(ValueError, match="TILE"):
        ops_dense.run_worklist(ids, ids, phi, feats, sb, rows, keys,
                               TILE=2048, C=16, SUB=1)
    with pytest.raises(ValueError, match="C/SUB"):
        ops_dense.run_occlusion(ids, ids, phi, feats, rows, rows, TILE=512,
                                C=16, SUB=8)
    with pytest.raises(TypeError):
        ops_dense.run_occlusion(ids.long(), ids, phi, feats, rows, rows,
                                TILE=512, C=16)


def test_kernel_build_is_cached(cuda):
    path = _build.build()
    stamp = path.with_name(path.name + ".sha256")
    assert stamp.read_text().strip() == _build.source_hash()
    mtime = path.stat().st_mtime_ns
    assert _build.build() == path
    assert path.stat().st_mtime_ns == mtime


# The card probes P1-P4 (raycore_tpu_torch/tools/).

@pytest.mark.parametrize("prec,dtype", [("highest", torch.float32),
                                        ("default", torch.float32),
                                        ("high", torch.float32),
                                        ("default", torch.bfloat16)])
@pytest.mark.parametrize("M,K,N", [(256, 16, 128), (128, 128, 192),
                                   (2048, 16, 512)])
def test_matmul_probe_kernel_matches_plain(cuda, M, K, N, prec, dtype):
    """P3 at every tier against the plain version of that tier: the FMA
    tier bit for bit, the tensor-core tiers within ACC_REL times the row's
    sum of product magnitudes (``probe_matmul_shapes.tolerance``), a limit
    that a kernel computing the neighbouring tier's product fails
    (``tier_gap``, pinned on the CPU). Every step writes the same bits. At
    5 steps each CTA takes one step; at 4,099 (more than the SMs times the
    CTAs that fit on one) each walks several, its cursors wrapping."""
    a, b = t_mm.operands(M, K, N, dtype, cuda)
    steps = 4099 if M == 2048 else 5
    before = t_mm.run_matmul.launches
    got = t_mm.run_matmul(a, b, steps, prec)
    assert t_mm.run_matmul.launches == before + 1
    want = t_mm.run_matmul_plain(a, b, steps, prec)
    variant = t_mm.variant_of(prec, dtype)
    if variant == "fma":
        check_equal(got, want, "P3 fma")
    else:
        assert bool(((got - want).abs()
                     <= t_mm.tolerance(a, b, variant)).all())
    assert torch.equal(got, t_mm.run_matmul(a, b, 1, prec))


def test_matmul_probe_leaves_allow_tf32(cuda):
    """Neither the probe nor its library yardstick leaves
    torch.backends.cuda.matmul.allow_tf32 changed."""
    for flag in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = flag
        t_mm.probe(128, 16, 64, "default", steps=(4, 8), reps=1,
                   device=cuda)
        a, b = t_mm.operands(128, 16, 64, torch.float32, cuda)
        for prec in ("highest", "default"):
            t_mm.matmul_library(a, b, 4, prec)
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("variant", t_gather.VARIANTS)
def test_gather_probe_kernel_matches_plain(cuda, variant):
    """P1 on a (1008, 128) table (not a power of two) over 37 steps (not a
    multiple of the 8 steps a loop CTA takes): within 2^-14 of the fetched
    magnitudes (``gather_probe.tolerance``)."""
    idx, tbl = t_gather.make_inputs(1008, 37, cuda, seed=3)
    before = t_gather.run_gather.launches
    got = t_gather.run_gather(idx, tbl, variant)
    assert t_gather.run_gather.launches == before + 1
    want = t_gather.run_gather_plain(idx, tbl, variant)
    assert bool(((got - want).abs()
                 <= t_gather.tolerance(idx, tbl, variant)).all())


@pytest.mark.parametrize("case", ["one_tile_a_step", "one_tile_in_all"])
def test_gather_onehot_sets_and_clears_its_tile(cuda, case):
    """The onehot kernel's shared one-hot tiles on a (1008, 128) table. The
    indices come in aligned blocks of 16 rows, and the kernel's K-tiles
    are whole numbers of such blocks (wgmma's k16), so a block lies in one
    K-tile whatever rows a K-tile holds: every step's 512 indices in one
    block, block s for step s (modulo the 63 blocks), so a tile is set full
    and cleared before another step's; or every index of the run in the
    last 16 rows, which lie in the last, partial K-tile (1008 is a multiple
    of 16 and of no larger power of two), so every other tile stays empty.
    Within ``gather_probe.tolerance`` of the plain version, which a stale
    or missing entry would leave."""
    NN, steps = 1008, 37
    idx, tbl = t_gather.make_inputs(NN, steps, cuda, seed=5)
    gen = torch.Generator(device=cuda).manual_seed(6)
    if case == "one_tile_a_step":
        block = (torch.arange(steps, device=cuda) % (NN // 16)) \
            .repeat_interleave(512)
    else:
        block = torch.full((steps * 512,), NN // 16 - 1, device=cuda)
    off = torch.randint(0, 16, (steps * 512,), generator=gen, device=cuda)
    idx = (block * 16 + off).to(torch.int32)
    rows = (idx // 16).view(steps, 512)
    assert bool((rows == rows[:, :1]).all())
    got = t_gather.run_gather(idx, tbl, "onehot")
    want = t_gather.run_gather_plain(idx, tbl, "onehot")
    assert bool(((got - want).abs()
                 <= t_gather.tolerance(idx, tbl, "onehot")).all())


# Each end of P1's shared-memory tier and one row past it (the L2 tier).
GATHER_TIER_ROWS = sorted({max(1, t_gather.SLICE_ROWS[0] - 1),
                           *t_gather.SLICE_ROWS, t_gather.SLICE_ROWS[1] + 1})


@pytest.mark.parametrize("NN", GATHER_TIER_ROWS)
@pytest.mark.parametrize("variant", ["loop", "take"])
def test_gather_probe_kernel_equals_model(cuda, variant, NN):
    """P1's ``loop`` and ``take`` at each end of the shared-memory tier
    and one row past it, over 37 steps (a whole number of no tier's step
    groups): bit for bit ``run_gather_model`` in the tier ``gather_tier``
    picks, and a second launch gives the same bits."""
    idx, tbl = t_gather.make_inputs(NN, 37, cuda, seed=11)
    tier = t_gather.gather_tier(NN)
    got = t_gather.run_gather(idx, tbl, variant)
    check_equal(got, t_gather.run_gather_model(idx, tbl, variant, tier),
                f"P1 {variant}, NN {NN}, tier {tier}, against its model")
    check_equal(t_gather.run_gather(idx, tbl, variant), got,
                f"P1 {variant}, NN {NN}, a second launch")


def test_gather_probe_refuses_a_slice_that_does_not_fit(cuda):
    """The launcher's shared-memory tier at the most rows whose slice and
    the loop's 64 KB of index rings fit in the card's opt-in shared memory
    a block (bit for bit the model), and one row past it: refused at the
    launch, which raises, and nothing runs in its place."""
    from raycore_tpu_torch.tools._common import launch

    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    most = (optin - 65_536) // 16
    assert most >= t_gather.SLICE_ROWS[1]
    for NN in (most, most + 1):
        idx, tbl = t_gather.make_inputs(NN, 3, cuda, seed=12)
        out = torch.full((3, t_gather.W), float("nan"), device=cuda)
        args = (idx.data_ptr(), tbl.data_ptr(), out.data_ptr(), NN, 3,
                t_gather.VARIANTS.index("loop"), 4)
        if NN == most:
            launch("gather_probe", cuda, *args)
            check_equal(out, t_gather.run_gather_model(idx, tbl, "loop", 4),
                        "P1 loop, the largest slice that fits")
        else:
            with pytest.raises(RuntimeError, match="gather_probe"):
                launch("gather_probe", cuda, *args)
            torch.cuda.synchronize()
            assert bool(out.isnan().all())


@pytest.mark.parametrize("case", list(GATHER_CASES))
@pytest.mark.parametrize("variant", ["loop", "take"])
def test_gather_probe_edge_cases_equal_model(cuda, variant, case):
    """P1's ``loop`` and ``take`` on ``torch_adversarial.gather_case``: one
    table row, a row count not a whole number of 4, fewer steps than step
    groups, every index on one row, magnitudes near 2^100 and below
    2^-100. Bit for bit ``run_gather_model``; within tolerance of plain."""
    idx, tbl = (torch.as_tensor(x, device=cuda) for x in gather_case(case))
    got = t_gather.run_gather(idx, tbl, variant)
    check_equal(got, t_gather.run_gather_model(
        idx, tbl, variant, t_gather.gather_tier(tbl.shape[0])),
        f"P1 {variant} on {case}, against its model")
    assert bool(((got - t_gather.run_gather_plain(idx, tbl, variant)).abs()
                 <= t_gather.tolerance(idx, tbl, variant)).all())


@pytest.mark.parametrize("prec,dtype", [("highest", torch.float32),
                                        ("default", torch.bfloat16)])
def test_matmul_probe_time_grows_with_steps(cuda, prec, dtype):
    """Every step computes its own product: at (512, 16, 512) 32,768 steps
    take at least 3.5x the time of 8,192 (a product hoisted out of the
    step loop would leave the time nearly flat)."""
    a, b = t_mm.operands(512, 16, 512, dtype, cuda)
    t1, t4 = (best_ms(lambda n=n: t_mm.run_matmul(a, b, n, prec), 3)
              for n in (8192, 32768))
    assert t4 >= 3.5 * t1, (t1, t4)


@pytest.mark.parametrize("same_tile", [False, True])
@pytest.mark.parametrize("seed_key", ["tool", "finite"])
@pytest.mark.parametrize("variant", t_epi.VARIANTS)
def test_epilogue_probe_kernel_matches_plain(cuda, variant, seed_key,
                                             same_tile):
    """P2 on 6 tiles of 100 rows (not a warp multiple), 14 blocks: bit for
    bit except where the approximate reciprocal enters
    (``epilogue_experiments.check``); the finite seed accepts hits."""
    phi, feats, tmin, key0 = t_epi.make_inputs(100, n_tiles=6, device=cuda)
    if seed_key == "finite":
        key0 = t_epi.finite_key0(key0.shape[0], device=cuda)
    kw = dict(TILE=100, n_blocks=14, variant=variant, same_tile=same_tile)
    before = t_epi.run_epilogue.launches
    got = t_epi.run_epilogue(phi, feats, tmin, key0, **kw)
    assert t_epi.run_epilogue.launches == before + 1
    want = t_epi.run_epilogue_plain(phi, feats, tmin, key0, **kw)
    t_epi.check(got, want, variant, "P2")
    if same_tile:
        assert bool((got[100:] == 0).all())
    if variant in t_epi.ACCEPTING and seed_key == "finite":
        assert bool((want[:100] != key0[:100]).any())


@pytest.mark.parametrize("variant,G,SPB", t_block.CONFIGS
                         + (("contig_tbl", 16, 8),))
def test_block_probe_kernel_matches_plain(cuda, variant, G, SPB):
    """P4 on 37 blocks, one with cid -1, from a 300-subgroup table of 32
    clusters: key and lane bit for bit."""
    tbl, feats, gen = t_block.make_inputs(n_sub=300, K=32, device=cuda,
                                          seed=4)
    tbl = tbl[:, :G].contiguous()
    subs, cids = t_block.block_ids(37, SPB, 300, 32, gen)
    cids[5] = -1
    tblc = torch.randn((37, G * SPB, 16), generator=gen, device=cuda)
    before = t_block.run_block.launches
    got = t_block.run_block(variant, G, SPB, subs, cids, tbl, feats, tblc)
    assert t_block.run_block.launches == before + 1
    want = t_block.run_block_plain(variant, G, SPB, subs, cids, tbl, feats,
                                   tblc)
    check_equal(got, want, f"P4 {variant}")
    hits = want[0] != INT32_MAX
    assert bool(hits.any()) and (variant == "mm_only" or not hits.all())


@pytest.mark.parametrize("TILE", [100, 256, 512, 1000, 1024])
@pytest.mark.parametrize("variant", t_epi.VARIANTS)
def test_epilogue_probe_kernel_at_every_tile(cuda, variant, TILE):
    """P2 at TILE 256, 512 and 1024, and at 100 and 1000, which are not
    whole numbers of the 64 rows the kernel's register blocks cover: 3
    tiles, 7 blocks, the finite seed, against the plain version as
    ``epilogue_experiments.check`` allows."""
    phi, feats, tmin, _ = t_epi.make_inputs(TILE, n_tiles=3, device=cuda,
                                            seed=TILE)
    key0 = t_epi.finite_key0(phi.shape[0], device=cuda)
    kw = dict(TILE=TILE, n_blocks=7, variant=variant)
    got = t_epi.run_epilogue(phi, feats, tmin, key0, **kw)
    t_epi.check(got, t_epi.run_epilogue_plain(phi, feats, tmin, key0, **kw),
                variant, f"P2 TILE={TILE}")


@pytest.mark.parametrize("variant", t_epi.VARIANTS)
def test_epilogue_probe_kernel_across_the_grid(cuda, variant):
    """P2 on 300 blocks of 6 tiles of 100 rows, more than the persistent
    grid holds (one CTA an SM), so every CTA walks several blocks and its
    two stages alternate; the finite seed."""
    phi, feats, tmin, _ = t_epi.make_inputs(100, n_tiles=6, device=cuda,
                                            seed=9)
    key0 = t_epi.finite_key0(phi.shape[0], device=cuda)
    kw = dict(TILE=100, n_blocks=300, variant=variant)
    got = t_epi.run_epilogue(phi, feats, tmin, key0, **kw)
    t_epi.check(got, t_epi.run_epilogue_plain(phi, feats, tmin, key0, **kw),
                variant, "P2 across the grid")


@pytest.mark.parametrize("exponent", [-125, -100, -60, -1, 0, 1, 60, 100,
                                      124])
def test_epilogue_probe_fast_reciprocal_is_correctly_rounded(cuda, exponent):
    """The P2 kernel's branch-free reciprocal equals the correctly rounded
    one on every float32 of the exponent, both signs (2^24 values), across
    its range [2^-125, 2^125]."""
    assert t_epi.rcp_check(exponent, cuda) == (0, 2 ** 24)


@pytest.mark.parametrize("seed_key", ["tool", "finite"])
@pytest.mark.parametrize("variant", [v for v in t_epi.VARIANTS
                                     if v not in t_epi.APPROX])
def test_epilogue_probe_kernel_on_adversarial_dets(cuda, variant, seed_key):
    """P2 on tiles whose products sit on special dets (+-0, subnormal,
    2^+-126-scale, huge, +-inf, NaN) and on the u and v clauses' edges
    (``torch_adversarial.epilogue_probe_case``), 4 tiles of 96 rows, 8
    blocks: the exact variants bit for bit with the plain version. (The
    approximate reciprocal flushes subnormal dets, so those variants are
    held to ``check``'s bound on the tool's data only.)"""
    phi, feats = (torch.as_tensor(x, device=cuda)
                  for x in epilogue_probe_case(96, 4))
    tmin = torch.full((phi.shape[0], 1), -1.0, device=cuda)
    key0 = t_epi.make_inputs(96, n_tiles=4, device=cuda)[3] \
        if seed_key == "tool" else t_epi.finite_key0(phi.shape[0],
                                                      device=cuda)
    kw = dict(TILE=96, n_blocks=8, variant=variant)
    got = t_epi.run_epilogue(phi, feats, tmin, key0, **kw)
    t_epi.check(got, t_epi.run_epilogue_plain(phi, feats, tmin, key0, **kw),
                variant, "P2 adversarial")


# Blocks of the P4 card checks: more than the persistent grid holds (one
# CTA an SM), so every CTA walks several blocks and its cursors wrap.
BLOCK_PROBE_BLOCKS = 300


@pytest.mark.parametrize("G,SPB", [(16, 8), (16, 16), (16, 32), (32, 8),
                                   (32, 16), (32, 32), (12, 7), (31, 33),
                                   (1, 300)])
@pytest.mark.parametrize("variant", t_block.VARIANTS)
def test_block_probe_kernel_across_the_grid(cuda, variant, G, SPB):
    """P4 at G 16 and 32 with SPB 8, 16 and 32, and at 84, 1023 and 300
    rows (not whole numbers of the 64 rows the register blocks cover; at
    SPB 300 a block has more subgroups than its CTA has threads), on
    BLOCK_PROBE_BLOCKS blocks, some with cid -1: key and lane bit for
    bit."""
    n = BLOCK_PROBE_BLOCKS
    tbl, feats, gen = t_block.make_inputs(n_sub=400, K=32, device=cuda,
                                          seed=G * SPB)
    tbl = tbl[:, :G].contiguous()
    subs, cids = t_block.block_ids(n, SPB, 400, 32, gen)
    cids[::37] = -1
    tblc = torch.randn((n, G * SPB, 16), generator=gen, device=cuda) \
        if variant == "contig_tbl" else None
    args = (variant, G, SPB, subs, cids, tbl, feats, tblc)
    check_equal(t_block.run_block(*args), t_block.run_block_plain(*args),
                f"P4 {variant} G={G} SPB={SPB}")


@pytest.mark.parametrize("variant", t_block.VARIANTS)
def test_block_probe_kernel_on_adversarial_dets(cuda, variant):
    """P4 on tables whose dets are +-0, subnormal, 2^+-126-scale, huge,
    +-inf and NaN and whose quotients sit on the u and v clauses' edges
    (``torch_adversarial.block_probe_case``), BLOCK_PROBE_BLOCKS blocks:
    key and lane bit for bit with the plain version, so the kernel's
    division-free pre-test refuses no pair the exact clauses accept."""
    n = BLOCK_PROBE_BLOCKS
    tbl, feats = (torch.as_tensor(x, device=cuda)
                  for x in block_probe_case(K=16, n_sub=64, G=32))
    gen = torch.Generator(device=cuda).manual_seed(7)
    subs, cids = t_block.block_ids(n, 8, 64, 16, gen)
    cids[::37] = -1
    tblc = tbl[subs.long()].reshape(n, 256, 16).contiguous()
    args = (variant, 32, 8, subs, cids, tbl, feats, tblc)
    want = t_block.run_block_plain(*args)
    check_equal(t_block.run_block(*args), want, f"P4 {variant} adversarial")
    hits = want[0] != INT32_MAX
    assert bool(hits.any()) and (variant == "mm_only" or not hits.all())


def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """A CPU operand beside a CUDA one, a wrong dtype or a shape the
    kernel does not take raises; nothing falls back to the plain version."""
    a, b = t_mm.operands(128, 16, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        t_mm.run_matmul(a, b.cpu(), 2, "highest")
    with pytest.raises(TypeError):
        t_mm.run_matmul(a, b.to(torch.bfloat16), 2, "highest")
    with pytest.raises(TypeError):
        t_mm.run_matmul(a.double(), b.double(), 2, "highest")
    with pytest.raises(ValueError, match="shapes"):
        t_mm.run_matmul(a[:100].contiguous(), b, 2, "highest")
    idx, tbl = t_gather.make_inputs(64, 2, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        t_gather.run_gather(idx, tbl.cpu(), "loop")
    with pytest.raises(TypeError):
        t_gather.run_gather(idx.long(), tbl, "take")
    with pytest.raises(ValueError, match="NN % 16"):
        t_gather.run_gather(idx, tbl[:60].contiguous(), "onehot")
    phi, feats, tmin, key0 = t_epi.make_inputs(32, n_tiles=2, device=cuda)
    kw = dict(TILE=32, n_blocks=2, variant="full")
    with pytest.raises(ValueError, match="CUDA"):
        t_epi.run_epilogue(phi, feats.cpu(), tmin, key0, **kw)
    with pytest.raises(TypeError):
        t_epi.run_epilogue(phi, feats, tmin, key0.float(), **kw)
    with pytest.raises(ValueError, match="TILE"):
        t_epi.run_epilogue(phi, feats, tmin, key0, TILE=48, n_blocks=2,
                           variant="full")
    tbl, feats, gen = t_block.make_inputs(n_sub=16, K=4, device=cuda)
    subs, cids = t_block.block_ids(2, 8, 16, 4, gen)
    with pytest.raises(ValueError, match="CUDA"):
        t_block.run_block("full", 32, 8, subs.cpu(), cids, tbl, feats)
    with pytest.raises(TypeError):
        t_block.run_block("full", 32, 8, subs.long(), cids, tbl, feats)
    with pytest.raises(ValueError, match="missing"):
        t_block.run_block("contig_tbl", 32, 8, subs, cids, tbl, feats)
    with pytest.raises(ValueError, match="1024"):
        t_block.run_block("full", 32, 64, t_block.block_ids(
            2, 64, 16, 4, gen)[0], cids, tbl, feats)


def test_path_traced_frame_on_card_matches_cpu(cuda):
    """A 64x48 trace_paths_staged frame (2 bounces) on a displaced grid on
    the card against the same frame on the CPU, both drawing from a CPU
    generator seeded alike; the image rule (render/parity.py) at atol
    1e-5, every query recorded. Below 2^19 rays: K1, K3 and K4."""
    import dataclasses
    from raycore_tpu_torch.render import pathtracer as tp
    from raycore_tpu_torch.render.parity import (Recorder, check_images,
                                                 cpu_draws)
    cpu = torch.device("cpu")

    def frame(dev):
        mesh = rt.displaced_grid_mesh(n=64, device=dev)
        mesh = dataclasses.replace(mesh, metadata=(torch.arange(
            mesh.vertices.shape[0], device=dev) // 64) % 2)
        scene = rt.build_dense(mesh, cluster_size=128)
        mats = rt.Materials.create([[0.75, 0.72, 0.68], [0.9, 0.85, 0.8]],
                                   metallic=[0.0, 0.85],
                                   roughness=[0.8, 0.15], device=dev)
        lights = rt.PointLights.create([[2.5, -2.5, 4.0], [-2.0, 2.0, 3.5]],
                                       [[18.0, 17, 16], [6.0, 7, 9]],
                                       device=dev)
        cam = rt.Camera.create((0.0, -3.2, 2.4), (0.0, 0.0, 0.3),
                               fov_deg=55.0, device=dev)
        cfg = tp.PTConfig(width=64, height=48, spp=1, bounces=2,
                          tile_size=256)
        rec = Recorder()
        with cpu_draws(), rec.recording_port():
            img = tp.trace_paths_staged(scene, mats, lights, cam,
                                        torch.Generator().manual_seed(3),
                                        cfg)
        return img, rec

    ref, rec_c = frame(cpu)
    counts = (ops_dense.run_worklist.launches,
              ops_dense.run_occlusion.launches)
    got, rec_g = frame(cuda)
    assert got.device.type == "cuda"
    assert ops_dense.run_worklist.launches == counts[0] + 2
    assert ops_dense.run_occlusion.launches == counts[1] + 2
    out = check_images(ref, got, 1e-5, rec_c.queries, rec_g.queries)
    assert out["rows"] >= 64 * 48 and float(got.mean()) > 0.005
