"""The regrouped driver's dead-lane cut (``ops/regroup.py:_swept_batch``)
on the CPU: lanes that can accept no hit (t_max < t_min, or a NaN bound)
are not swept, and every answer stays bit for bit what the sweep of the
whole batch gives.

The batches are a renderer's: shadow rays from the heightfield's surface
toward one of two lights drawn per ray, and dead lanes shaped like a
frame's finished paths (from the origin toward a light, as a missed
lane's zero payload aims them). Layouts: dead lanes between the live
ones, a dead suffix after live lanes in octant order (a compacted
batch), every lane dead, one live lane, none dead. Each live lane's
answer is held bit for bit to the live lanes queried alone and to the
whole batch swept in the caller's order through both stages (the sweep
before the cut; with NaN bounds that sweep lost the live neighbours'
hits, see the test); each dead lane's to the miss; one layout to the
JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu_torch.accel import dispatch
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.render import pathtracer as tp
from raycore_tpu_torch.scene import mesh as t_mesh
from test_torch_regroup_reorder import (LIGHTS, TRI_FIELDS, assert_bitwise,
                                        octants, shadow_batch)
from torch_parity import CPU, check_hits, jax_rays, np_

TILE = 512
G = 32
SPB = 16
INSTANCES = 3
GATE = t_pr.octant_gate
PACK = t_pr.pack_presorted_cluster_major
LAYOUTS = ("interleaved", "suffix", "all-dead", "one-live")
ENCODINGS = ("minus-one", "-inf", "nan", "below-t_min")
CASES = [(lay, enc) for lay in LAYOUTS for enc in ENCODINGS] \
    + [("none-dead", None)]
# The dead lanes' (t_min, t_max) in each encoding. any_hit forces t_min
# to 0, so "below-t_min" lanes are live there.
BOUNDS = {"minus-one": (0.0, -1.0), "-inf": (0.0, -np.inf),
          "nan": (0.0, np.nan), "below-t_min": (2.0, 1.0)}


@pytest.fixture(scope="module")
def world():
    kw = dict(n=64, extent=2.0, amplitude=0.3)
    tm = t_mesh.displaced_grid_mesh(**kw, device=CPU)
    inst = np.arange(tm.vertices.shape[0], dtype=np.int32) % INSTANCES
    ts = rt.build_dense(tm, cluster_size=32, instance_of=inst)
    js = j_dense.build_dense(j_mesh.displaced_grid_mesh(**kw),
                             cluster_size=32, instance_of=inst)
    o, d, t_max = shadow_batch(ts, 48, 0.9)
    return dict(ts=ts, js=js, o=o, d=d, t_max=t_max)


def lanes(w, layout, encoding, payload):
    """(o, d, t_min, t_max) float32 of the layout's batch, and its live
    mask as the query sees it (any_hit's t_min is 0). One live lane has
    t_max == t_min (its light's distance; 0 for any_hit), and stays
    live."""
    n = w["o"].shape[0]
    rng = np.random.default_rng(7)
    light = LIGHTS[rng.integers(0, 2, n)]
    dead_o = np.zeros((n, 3), np.float32)
    dead_d = (light / np.linalg.norm(light, axis=1, keepdims=True)) \
        .astype(np.float32)
    lo, hi = BOUNDS[encoding] if encoding else (0.0, 0.0)
    live = np.concatenate([w["o"], w["d"], np.zeros((n, 1), np.float32),
                           w["t_max"][:, None]], 1)
    if layout == "suffix":
        live = live[np.argsort(octants(w["d"]), kind="stable")]
    dead = np.concatenate([dead_o, dead_d, np.full((n, 1), lo, np.float32),
                           np.full((n, 1), hi, np.float32)], 1)
    if layout == "interleaved":
        rows = np.stack([live, dead], 1).reshape(2 * n, 8)
    elif layout == "suffix":
        rows = np.concatenate([live, dead])
    elif layout == "all-dead":
        rows = dead
    elif layout == "one-live":
        rows = dead.copy()
        rows[n // 2] = live[n // 2]
    else:
        rows = live
    rows = rows.copy()
    t_min = rows[:, 6] if payload != "occlusion" else np.zeros(len(rows))
    alive = rows[:, 7] >= t_min
    if alive.any():
        k = int(np.flatnonzero(alive)[len(np.flatnonzero(alive)) // 3])
        rows[k, 6] = rows[k, 7] = 0.0 if payload == "occlusion" \
            else rows[k, 7]
    t_min = rows[:, 6] if payload != "occlusion" else np.zeros(len(rows))
    return rows, rows[:, 7] >= t_min


def ray_batch(rows):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    return rt.Ray.create(t(rows[:, 0:3]), t(rows[:, 3:6]),
                         t_min=t(rows[:, 6]), t_max=t(rows[:, 7]))


def query(scene, rows, payload):
    rays = ray_batch(rows)
    if payload == "occlusion":
        return t_pr.any_hit_regrouped(scene, rays, tile=TILE)
    return t_pr.closest_hit_regrouped(scene, rays, tile=TILE,
                                      payload=payload)


def whole_sweep(scene, rows, payload):
    """The batch swept whole in the caller's order, dead lanes included,
    through both stages (past the gate and the cut)."""
    rays = ray_batch(rows)
    if payload == "occlusion":
        rays = rt.Ray.create(rays.o, rays.d, t_max=rays.t_max)
    o, d, t_min, t_max, R0, G_, TILE_ = t_pr._padded_batch(rays, TILE, G)
    bc, bs, tbl, _ = t_pr._stage1_cm_core(scene, o, d, t_min, t_max, TILE_,
                                          G_, SPB)
    return t_pr._stage2_core(scene, bc, bs, tbl, o[:R0], d[:R0], G_, SPB,
                             o.shape[0], payload)


def take(res, m):
    return res.map(lambda a: a[torch.as_tensor(m)])


@pytest.fixture
def counters(monkeypatch):
    for name in ("checked", "engaged", "boundaries", "dead"):
        monkeypatch.setattr(GATE, name, 0)
    monkeypatch.setattr(PACK, "filled", 0)


@pytest.mark.parametrize("payload", ["full", "slim", "occlusion"])
@pytest.mark.parametrize("layout,encoding", CASES)
def test_dead_lanes_miss_and_live_lanes_answer_as_alone(world, counters,
                                                        payload, layout,
                                                        encoding):
    w = world
    rows, live = lanes(w, layout, encoding, payload)
    got = query(w["ts"], rows, payload)
    assert GATE.dead == int((~live).sum())
    whole = whole_sweep(w["ts"], rows, payload)
    if encoding == "nan":
        # Swept whole, a NaN t_max makes its subgroup's and its tile's
        # bundle bounds NaN, and the interval tests keep no cluster for
        # their live rays: cut, they answer as alone (below).
        assert_bitwise(take(whole, ~live), take(got, ~live))
    else:
        assert_bitwise(whole, got)
    dead = take(got, ~live)
    assert not np_(dead.hit).any()
    assert (np_(dead.prim_idx) == -1).all()
    assert (np_(dead.instance_idx) == -1).all()
    for f in ("t", "barycentric"):
        assert not np_(getattr(dead, f)).any(), f
    for f in TRI_FIELDS:
        assert not np_(getattr(dead.triangle, f)).any(), f
    if live.any():
        alone = query(w["ts"], rows[live], payload)
        assert_bitwise(alone, take(got, live))
        assert 0 < np_(alone.hit).sum() or layout == "one-live"
    if (layout, encoding) == ("interleaved", "minus-one"):
        jr = jax_rays(rows[:, 0:3], rows[:, 3:6],
                      t_min=jnp.asarray(rows[:, 6]),
                      t_max=jnp.asarray(rows[:, 7]))
        if payload == "occlusion":
            ref = j_pr.any_hit_regrouped(w["js"], jr, tile=TILE)
        else:
            ref = j_pr.closest_hit_regrouped(w["js"], jr, tile=TILE,
                                             passes=1, payload=payload)
        for f in ("hit", "prim_idx", "instance_idx"):
            assert np.array_equal(np_(getattr(ref, f)),
                                  np_(getattr(got, f))), f
        if payload == "full":
            for f in ("vertices", "normals", "metadata"):
                assert np.array_equal(np_(getattr(ref.triangle, f)),
                                      np_(getattr(got.triangle, f))), f
            check_hits(ref, got)


def _spy_stage1(monkeypatch):
    seen = []
    orig = t_pr._stage1_cm_core

    def spy(scene, o, d, t_min, t_max, TILE_, G_, *a, **k):
        seen.append(dict(rows=torch.cat([o, d, t_min[:, None],
                                         t_max[:, None]], 1).clone(),
                         TILE=TILE_, G=G_))
        return orig(scene, o, d, t_min, t_max, TILE_, G_, *a, **k)
    monkeypatch.setattr(t_pr, "_stage1_cm_core", spy)
    return seen


# The Tensor methods that read a value back to the host.
READBACKS = ("item", "tolist", "__bool__", "__int__", "__float__",
             "__index__", "nonzero", "cpu", "numpy")


def _count_readbacks(monkeypatch):
    """Counts the readbacks inside each ``_swept_batch`` call."""
    calls = []
    orig = t_pr._swept_batch

    def counted(*a, **k):
        calls.append(0)
        with monkeypatch.context() as m:
            for name in READBACKS:
                def wrap(self, *x, _f=getattr(torch.Tensor, name), **y):
                    calls[-1] += 1
                    return _f(self, *x, **y)
                m.setattr(torch.Tensor, name, wrap)
            return orig(*a, **k)
    monkeypatch.setattr(t_pr, "_swept_batch", counted)
    return calls


@pytest.mark.parametrize("layout,engaged", [
    ("interleaved", 1), ("suffix", 0), ("one-live", 1), ("all-dead", 0),
    ("none-dead", 1)])
def test_stage_one_sees_only_the_live_lanes(monkeypatch, world, counters,
                                            layout, engaged):
    """Stage 1 receives the live lanes alone, sorted by octant where the
    gate engages (a dead lane before a live one, or more than 7 octant
    changes between live lanes), else as given, padded to whole tiles of
    a G and TILE chosen from the live count; with every lane dead it is
    not called. The pack fills the same slots as for the live lanes
    queried alone; ``dead`` counts the cut lanes; ``_swept_batch`` reads
    back once a query."""
    w = world
    rows, live = lanes(w, layout, "minus-one", "occlusion")
    n = int(live.sum())
    seen = _spy_stage1(monkeypatch)
    reads = _count_readbacks(monkeypatch)
    t_pr.any_hit_regrouped(w["ts"], ray_batch(rows), tile=TILE)
    assert reads == [1]
    assert (GATE.checked, GATE.engaged) == (1, engaged)
    assert GATE.dead == len(rows) - n
    if n == 0:
        assert seen == [] and PACK.filled == 0
        return
    filled = PACK.filled
    want = rows[live]
    want[:, 6] = 0.0     # any_hit's t_min
    if engaged:
        want = want[np.argsort(octants(want[:, 3:6]), kind="stable")]
    G_, TILE_ = t_pr._tile_sizes(n, TILE, G)
    (got,) = seen
    assert (got["G"], got["TILE"]) == (G_, TILE_)
    assert got["rows"].shape[0] == -(-n // TILE_) * TILE_
    assert np.array_equal(np_(got["rows"][:n]), want)
    pad = np_(got["rows"][n:])
    assert (pad[:, 0:3] == 0).all() and (pad[:, 3:6] == 1).all()
    assert (pad[:, 6] == 0).all() and (pad[:, 7] == -np.inf).all()
    t_pr.any_hit_regrouped(w["ts"], ray_batch(rows[live]), tile=TILE)
    assert reads == [1, 1]
    assert PACK.filled == 2 * filled


def test_a_staged_frames_dead_lanes_are_counted_and_cut(monkeypatch):
    """A small staged frame with every query on the regrouped engine:
    ``dead`` counts the lanes submitted with t_max < t_min (the frame's
    lanes less the live closest and live occlusion lanes), and the image
    is bit for bit the one swept with every lane live."""
    monkeypatch.setattr(dispatch, "REGROUP_MIN_RAYS", 1)
    for name in ("rays", "live"):
        monkeypatch.setattr(tp._frames, name, 0)
    monkeypatch.setattr(GATE, "dead", 0)
    live_occlusion = []
    any_hit = dispatch.scene_any_hit

    def counted(scene, rays, **kw):
        live_occlusion.append(int((rays.t_max >= 0).sum()))
        return any_hit(scene, rays, **kw)
    monkeypatch.setattr(dispatch, "scene_any_hit", counted)
    scene = rt.build_dense(rt.displaced_grid_mesh(n=24, device=CPU),
                           cluster_size=64)
    state = (rt.Materials.create(base_color=np.full((2000, 3), 0.6,
                                                    np.float32), device=CPU),
             rt.PointLights.create(position=LIGHTS, intensity=np.full(
                 (2, 3), 20.0, np.float32), device=CPU),
             rt.Camera.create(position=(0, -3, 2.5), target=(0, 0, 0),
                              device=CPU))
    cfg = tp.PTConfig(width=32, height=24, spp=1, bounces=3, tile_size=256)
    frame = lambda: tp.trace_paths_staged(
        scene, *state, torch.Generator(device=CPU).manual_seed(1), cfg)
    img = frame()
    dead = tp._frames.rays - int(tp._frames.live) - sum(live_occlusion)
    assert len(live_occlusion) == 3
    assert GATE.dead == dead > tp._frames.rays // 4
    monkeypatch.setattr(t_pr, "live_lanes",
                        lambda t_min, t_max: torch.ones_like(t_max, dtype=bool))
    assert torch.equal(frame(), img)
    assert GATE.dead == dead
