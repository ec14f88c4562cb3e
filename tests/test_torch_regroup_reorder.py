"""The regrouped driver's octant order (``ops/regroup.py:_swept_batch``,
``octant_gate``) on the CPU: a batch whose subgroups of 32 consecutive
rays mix direction octants is swept in octant order and answered in the
caller's order.

The batch is a renderer's shadow query: from the surface under a Morton
grid of downward rays toward one of two lights drawn per ray (the lights
of ``cardbench/traffic/shadow2-1m.json``), so nearly every subgroup mixes
two octants. Answers are held to the JAX package (which sweeps the
caller's order): any_hit bit for bit in hit, prim_idx and instance_idx,
and its hit mask to the brute oracle's; closest hit bit for bit in hit,
prim_idx, instance_idx and triangle, in t and barycentrics to the engine
contract (the port's plain float32 finalize rounds them on its own), and
every field bit for bit to the port's own sweep in the caller's order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.accel.brute import closest_hit_brute as j_brute
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.scene import mesh as t_mesh
from torch_adversarial import morton_grid
from torch_parity import CPU, check_hits, jax_rays, np_, torch_rays

LIGHTS = np.array([[2.5, -2.5, 4.0], [-2.0, 2.0, 3.5]], np.float32)
TILE = 512
G = 32
SPB = 16
INSTANCES = 3
PACK = t_pr.pack_presorted_cluster_major
GATE = t_pr.octant_gate
FIELDS = ("hit", "t", "barycentric", "prim_idx", "instance_idx")
TRI_FIELDS = ("vertices", "normals", "tangents", "uv", "metadata")


def _meshes(kind):
    if kind == "grid":
        kw = dict(n=64, extent=2.0, amplitude=0.3)
        return (j_mesh.displaced_grid_mesh(**kw),
                t_mesh.displaced_grid_mesh(**kw, device=CPU), 128, 0.9)
    return (j_mesh.blobby_mesh(64, 64),
            t_mesh.blobby_mesh(64, 64, device=CPU), 64, 0.8)


def shadow_batch(scene, side, half, seed=1):
    """(o, d, t_max) float32 of the shadow rays from the surface points
    that a Morton grid of ``side``^2 downward rays over [-half, half]^2
    hits: each lifted 1e-3 along its face's normal turned toward its
    light, aimed at one of ``LIGHTS`` drawn per ray, with t_max the
    distance to it."""
    o, d = morton_grid(side, half)
    first = t_pr.closest_hit_regrouped(scene, torch_rays(o, d), tile=TILE)
    m = np_(first.hit)
    p = o + np_(first.t)[:, None] * d
    v = np_(first.triangle.vertices).astype(np.float64)
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    light = LIGHTS[np.random.default_rng(seed).integers(0, 2, o.shape[0])]
    n = np.where(((light - p) * n).sum(1, keepdims=True) < 0, -n, n)
    so = (p + 1e-3 * n).astype(np.float32)
    to = light - so
    dist = np.linalg.norm(to, axis=1)
    sd = (to / dist[:, None]).astype(np.float32)
    return so[m], sd[m], dist[m].astype(np.float32)


@pytest.fixture(scope="module", params=["grid", "blobby"])
def world(request):
    jm, tm, side, half = _meshes(request.param)
    inst = np.arange(tm.vertices.shape[0], dtype=np.int32) % INSTANCES
    js = j_dense.build_dense(jm, cluster_size=32, instance_of=inst)
    ts = rt.build_dense(tm, cluster_size=32, instance_of=inst)
    o, d, t_max = shadow_batch(ts, side, half)
    return dict(kind=request.param, js=js, ts=ts, o=o, d=d, t_max=t_max,
                jr=jax_rays(o, d, t_max=jnp.asarray(t_max)))


def rays_of(w, perm=None, d=None):
    """The world's shadow rays, in the order ``perm`` where given, with
    the directions ``d`` where given."""
    perm = np.arange(w["o"].shape[0]) if perm is None else perm
    d = w["d"] if d is None else d
    return torch_rays(w["o"][perm], d[perm],
                      t_max=torch.as_tensor(w["t_max"][perm]))


def octant_sorted(w):
    return np.argsort(octants(w["d"]), kind="stable")


@pytest.fixture
def counters(monkeypatch):
    for name in ("checked", "engaged", "boundaries"):
        monkeypatch.setattr(GATE, name, 0)
    monkeypatch.setattr(PACK, "filled", 0)


def caller_order(scene, rays, payload="full"):
    """The regrouped engine's answer with the rays swept in the caller's
    order (both stages called directly, past the gate), and the pairs its
    stage 1 kept."""
    o, d, t_min, t_max, R0, G_, TILE_ = t_pr._padded_batch(rays, TILE, G)
    bc, bs, tbl, counts = t_pr._stage1_cm_core(scene, o, d, t_min, t_max,
                                               TILE_, G_, SPB)
    res = t_pr._stage2_core(scene, bc, bs, tbl, o[:R0], d[:R0], G_, SPB,
                            o.shape[0], payload)
    return res, counts[1]


def assert_bitwise(ref, got, fields=FIELDS):
    for f in fields:
        assert np.array_equal(np_(getattr(ref, f)), np_(getattr(got, f))), f
    for f in TRI_FIELDS:
        assert np.array_equal(np_(getattr(ref.triangle, f)),
                              np_(getattr(got.triangle, f))), f


def octants(d):
    d = np.asarray(d)
    return ((d[:, 0] > 0) + 2 * (d[:, 1] > 0) + 4 * (d[:, 2] > 0)) \
        .astype(np.int64)


def mixed_groups(d, n=G):
    """The groups of n consecutive rays of ``d`` that mix octants."""
    k = octants(d)
    k = np.concatenate([k, np.full(-len(k) % n, k[-1])]).reshape(-1, n)
    return int((k != k[:, :1]).any(1).sum())


def boundaries(d):
    """The octant changes between neighbouring rays of ``d``."""
    k = octants(d)
    return int((k[1:] != k[:-1]).sum())


def test_any_hit_engages_and_matches_jax_and_oracle(world, counters):
    w = world
    got = t_pr.any_hit_regrouped(w["ts"], rays_of(w), tile=TILE)
    assert (GATE.checked, GATE.engaged) == (1, 1)
    assert GATE.boundaries == boundaries(w["d"])
    assert mixed_groups(w["d"]) > 0.9 * -(-len(w["d"]) // G)
    ref = j_pr.any_hit_regrouped(w["js"], w["jr"], tile=TILE)
    for f in ("hit", "prim_idx", "instance_idx"):
        assert np.array_equal(np_(getattr(ref, f)), np_(getattr(got, f))), f
    hit = np_(got.hit)
    assert 0 < hit.sum() < hit.size
    assert (np_(got.instance_idx)[hit]
            == np_(got.prim_idx)[hit] % INSTANCES).all()
    oracle = j_brute(w["js"].prims, w["jr"], ray_chunk=1024)
    assert np.array_equal(np_(oracle.hit), hit)


def test_closest_hit_engages_and_matches_jax(world, counters):
    w = world
    got = t_pr.closest_hit_regrouped(w["ts"], rays_of(w), tile=TILE)
    assert GATE.engaged == 1
    ref = j_pr.closest_hit_regrouped(w["js"], w["jr"], tile=TILE, passes=1)
    for f in ("hit", "prim_idx", "instance_idx"):
        assert np.array_equal(np_(getattr(ref, f)), np_(getattr(got, f))), f
    for f in ("vertices", "normals", "metadata"):
        assert np.array_equal(np_(getattr(ref.triangle, f)),
                              np_(getattr(got.triangle, f))), f
    check_hits(ref, got)
    assert 0 < np_(got.hit).sum() < got.hit.numel()
    plain, _ = caller_order(w["ts"], rays_of(w))
    assert_bitwise(plain, got)


def test_occlusion_equals_the_caller_order_sweep(world, counters):
    w = world
    got = t_pr.any_hit_regrouped(w["ts"], rays_of(w), tile=TILE)
    plain, _ = caller_order(w["ts"], rays_of(w), payload="occlusion")
    assert_bitwise(plain, got)


def test_the_order_cuts_the_swept_pairs_tenfold(world, counters):
    """The shadow batch in the caller's order keeps at least ten times the
    (subgroup, cluster) pairs of the same batch in octant order on the
    heightfield (each mixed subgroup's inverse-direction interval spans
    0; on blobby, whose shadow rays cross the whole blob, at least three
    times), and the query keeps exactly the octant-ordered count."""
    w = world
    t_pr.any_hit_regrouped(w["ts"], rays_of(w), tile=TILE)
    swept = PACK.filled
    _, mixed_pairs = caller_order(w["ts"], rays_of(w))
    _, sorted_pairs = caller_order(w["ts"], rays_of(w, octant_sorted(w)))
    assert swept == sorted_pairs
    assert mixed_pairs >= (10 if w["kind"] == "grid" else 3) * swept


def _spy_stage1(monkeypatch):
    seen = []
    orig = t_pr._stage1_cm_core

    def spy(scene, o, d, *a, **k):
        seen.append((o.clone(), d.clone()))
        return orig(scene, o, d, *a, **k)
    monkeypatch.setattr(t_pr, "_stage1_cm_core", spy)
    return seen


@pytest.mark.parametrize("batch", ["one-direction", "octant-sorted"])
def test_the_gate_stays_off_and_the_rays_untouched(monkeypatch, world,
                                                   counters, batch):
    """A batch in one octant or already in octant order changes octant at
    most 7 times: the gate stays off and stage 1 sees the caller's padded
    rays."""
    w = world
    if batch == "one-direction":
        toward = LIGHTS[0] / np.linalg.norm(LIGHTS[0])
        rays = rays_of(w, d=np.broadcast_to(toward, w["d"].shape)
                       .astype(np.float32))
    else:
        rays = rays_of(w, octant_sorted(w))
    seen = _spy_stage1(monkeypatch)
    got = t_pr.any_hit_regrouped(w["ts"], rays, tile=TILE)
    assert (GATE.checked, GATE.engaged) == (1, 0)
    assert GATE.boundaries == boundaries(np_(rays.d)) <= 7
    po, pd = t_pr._padded_batch(rays, TILE, G)[:2]
    assert torch.equal(seen[0][0], po) and torch.equal(seen[0][1], pd)
    plain, _ = caller_order(w["ts"], rays, payload="occlusion")
    assert_bitwise(plain, got)


def _eight_runs(starts, R):
    """Directions in the 8 octants, octant k on rays [starts[k],
    starts[k + 1])."""
    d = np.empty((R, 3), np.float32)
    bounds = list(starts) + [R]
    for k in range(8):
        sign = np.array([1 if k & 1 else -1, 1 if k & 2 else -1,
                         1 if k & 4 else -1], np.float32)
        d[bounds[k]:bounds[k + 1]] = sign * np.float32(0.5)
    return torch.as_tensor(d)


def test_the_gate_engages_past_seven_octant_changes(counters):
    """An octant-sorted batch changes octant 7 times and stays as it is;
    one ray out of place makes an eighth change and the batch is
    ordered. Zeros and -0 count as not positive."""
    R = 16 * G + 5
    starts = [0] + [G * k + 3 for k in range(1, 8)]
    d = _eight_runs(starts, R)
    gate = lambda d: t_pr.octant_gate(
        t_pr.octant_keys(d), torch.ones(d.shape[0], dtype=torch.bool))[0]
    assert np.array_equal(np_(t_pr.octant_keys(d)), octants(np_(d)))
    assert not gate(d)
    assert (GATE.checked, GATE.engaged, GATE.boundaries) == (1, 0, 7)
    d[-1] = -d[-1]
    assert gate(d)
    assert (GATE.checked, GATE.engaged, GATE.boundaries) == (2, 1, 15)
    zero = d.clone()
    zero[:, 0] = torch.where(zero[:, 0] < 0, -0.0, 0.0)
    zero[:, 1] = torch.where(zero[:, 1] < 0, 0.0, -0.0)
    assert not gate(zero)   # only z tells them apart: 2 changes


def test_pure_subgroups_in_mixed_tiles_are_ordered(counters):
    """A camera's rays in pixel order: rows of 64 rays, the left half
    toward -x, the right toward +x. No subgroup of 32 mixes octants but
    every tile of 256 does; the gate engages, and swept each tile holds
    one octant."""
    rows, width = 16, 64
    x = np.where(np.arange(width) < width // 2, -0.3, 0.3)
    d = np.stack([np.tile(x, rows), np.full(rows * width, 0.2),
                  np.full(rows * width, -0.9)], 1).astype(np.float32)
    assert mixed_groups(d) == 0 and mixed_groups(d, 256) == rows * width // 256
    rays = torch_rays(np.zeros_like(d), d)
    sd = t_pr._swept_batch(rays, 256, G)[1]
    assert GATE.engaged == 1 and GATE.boundaries == 2 * rows - 1
    assert mixed_groups(np_(sd), 256) == 0


def test_the_swept_order_is_stable_and_its_inverse_exact(counters):
    """``_swept_batch`` orders a batch whose octants are shuffled stably by
    octant, counting zeros and -0 as not positive, with the padding last;
    ``order`` puts every field back bit for bit. Sorted, the batch mixes
    octants in at most 7 subgroups."""
    R = 16 * G + 5
    d = _eight_runs([0] + [G * k + 3 for k in range(1, 8)], R)
    d = d[torch.as_tensor(np.random.default_rng(0).permutation(R))]
    d[:40, 0] = torch.where(d[:40, 0] < 0, -0.0, 0.0)
    o = torch.arange(R * 3, dtype=torch.float32).reshape(R, 3)
    t_max = torch.arange(R, dtype=torch.float32) + 1
    rays = torch_rays(np_(o), np_(d), t_max=t_max)
    po, pd, ptmin, ptmax, R0, G_, TILE_ = t_pr._padded_batch(rays, 256, G)
    so, sd, stmin, stmax, R1, G1, TILE1, order = t_pr._swept_batch(
        rays, 256, G)[:8]
    assert GATE.engaged == 1
    assert (R1, G1, TILE1) == (R0, G_, TILE_) and so.shape == po.shape
    perm = np.argsort(octants(np_(d)), kind="stable")
    assert np.array_equal(np_(order[:R]), perm)
    assert np.array_equal(np_(order[R:]), np.arange(R, po.shape[0]))
    assert mixed_groups(np_(sd)[:R]) <= 7
    for got, want in ((so, po), (sd, pd), (stmin, ptmin), (stmax, ptmax)):
        assert torch.equal(got, want[order])
        back = torch.empty_like(got).index_copy_(0, order, got)
        assert np.array_equal(np_(back), np_(want))


def test_stage_one_sees_the_octant_order(monkeypatch, world, counters):
    """Stage 1 sees the caller's rays stably sorted by octant, each octant
    in the caller's order, with the padding last; the answers come back
    in the caller's order (the tests above hold them bit for bit)."""
    w = world
    seen = _spy_stage1(monkeypatch)
    t_pr.any_hit_regrouped(w["ts"], rays_of(w), tile=TILE)
    R = w["o"].shape[0]
    perm = octant_sorted(w)
    po, pd = t_pr._padded_batch(rays_of(w), TILE, G)[:2]
    assert torch.equal(seen[0][0][:R], torch.as_tensor(w["o"][perm]))
    assert torch.equal(seen[0][1][:R], torch.as_tensor(w["d"][perm]))
    assert torch.equal(seen[0][0][R:], po[R:])
    assert torch.equal(seen[0][1][R:], pd[R:])
