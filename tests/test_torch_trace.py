"""The program's profiler spans and grid counters on the CPU
(``raycore_tpu_torch/utils/config.py:span``): with no profiler recording
no span is entered; under ``torch.profiler`` each query runs stage 1, the
sweep, the combine and the finalize once each, in that order, inside its
root span, and every host-sync span lies inside its stage; the subgroup
refine runs in a ``raycore.refine`` span inside stage 1; the regrouped
driver's octant gate (its readback in ``raycore.wait.octants``), with the
sort where it engages, runs in a ``raycore.reorder`` span before stage 1,
and the way back in one between the combine and the finalize; the block
grid's ``slots`` and ``filled`` counters equal stage 1's block and pair
counts, the refine's ``tested`` and ``kept`` its entries and the pairs it
keeps; each query's and the refresh's waits are the syncs that read data
or upload the transforms, none the upload of a constant. A path-traced
frame (``render/pathtracer.py``) runs in ``raycore.render``: its
primary, draws, nee, shade, compact and image stages in order around
its queries, no wait beyond its queries' own, no number uploaded from
the host in its glue, and its counters count what it submits."""
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu_torch.accel import dispatch
from raycore_tpu_torch.ops import dense as t_dense
from raycore_tpu_torch.ops import instanced as t_inst
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.render import pathtracer as t_pt
from raycore_tpu_torch.utils import config

CPU = torch.device("cpu")
STAGES = ["raycore.stage1", "raycore.sweep", "raycore.combine",
          "raycore.finalize"]
PACK = t_pr.pack_presorted_cluster_major
REORDER = "raycore.reorder"
REFINE = "raycore.refine"
REFINE_PAIRS = t_pr.refine_pairs


def grid_rays(side: int, half: float, z: float):
    """A downward side x side grid over [-half, half]^2 at height z."""
    xs = torch.linspace(-half, half, side)
    gx, gy = torch.meshgrid(xs, xs, indexing="xy")
    o = torch.stack([gx.reshape(-1), gy.reshape(-1),
                     torch.full((side * side,), z)], -1)
    d = torch.zeros_like(o)
    d[:, 2] = -1.0
    return rt.Ray.create(o, d)


@pytest.fixture(scope="module")
def dense():
    tris = rt.displaced_grid_mesh(n=32, extent=2.0, amplitude=0.3,
                                  device=CPU)
    return rt.build_dense(tris, cluster_size=64), grid_rays(48, 0.9, 3.0)


@pytest.fixture(scope="module")
def instanced():
    rng = np.random.default_rng(5)
    mgr = rt.TLAS(device=CPU)
    for _ in range(6):
        m = np.eye(3, 4, dtype=np.float32)
        m[:, 3] = rng.uniform(-2.0, 2.0, 3)
        mgr.push(rt.sphere_mesh(radius=0.6, n_theta=6, n_phi=8, device=CPU),
                 m)
    mgr.sync()
    return mgr, rt.bake_instanced(mgr, cluster_size=32), \
        grid_rays(32, 2.5, 6.0)


QUERIES = {
    "closest_hit_regrouped": lambda s, r: t_pr.closest_hit_regrouped(
        s, r, tile=256),
    "any_hit_regrouped": lambda s, r: t_pr.any_hit_regrouped(s, r,
                                                             tile=256),
    "closest_hit_dense_pallas_auto":
        lambda s, r: t_dense.closest_hit_dense_pallas_auto(s, r, tile=256),
    "closest_hit_instanced": lambda s, r: t_inst.closest_hit_instanced(
        s, r, tile=256),
}


def run_query(name, dense, instanced):
    if name == "closest_hit_instanced":
        _, scene, rays = instanced
    else:
        scene, rays = dense
    return QUERIES[name](scene, rays)


def spans_of(fn):
    """The ``raycore.*`` host events (name, start, end) recorded while
    ``fn`` runs, in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("raycore.")
           and e.device_type.name == "CPU"]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def inside(a, b) -> bool:
    return b[1] <= a[1] and a[2] <= b[2]


def test_span_is_shared_and_inert_with_no_profiler():
    assert config.span("raycore.a") is config.span("raycore.b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert config.span("raycore.a") is not config.span("raycore.a")


@pytest.mark.parametrize("route", ["regrouped", "any_hit", "worklist",
                                   "instanced", "refresh"])
def test_no_span_is_entered_with_no_profiler(monkeypatch, dense, instanced,
                                             route):
    def refuse(name):
        raise AssertionError(f"span {name} entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(dispatch, "REGROUP_MIN_RAYS", 1024)
    scene, rays = dense
    mgr, iscene, irays = instanced
    if route == "regrouped":
        res = rt.closest_hit(scene, rays)
    elif route == "any_hit":
        res = rt.any_hit(scene, rays)
    elif route == "worklist":
        monkeypatch.setattr(dispatch, "REGROUP_MIN_RAYS", 1 << 19)
        res = rt.closest_hit(scene, rays)
    elif route == "instanced":
        res = rt.closest_hit(iscene, irays)
    else:
        res = rt.closest_hit(rt.refresh_instances(iscene, mgr), irays)
    assert bool(res.hit.any())


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_each_stage_once_in_order_and_waits_inside(dense, instanced, name):
    spans = spans_of(lambda: run_query(name, dense, instanced))
    stages = [s for s in spans if s[0] in STAGES]
    assert [s[0] for s in stages] == STAGES
    for a, b in zip(stages, stages[1:]):
        assert a[2] <= b[1], (a, b)
    waits = [s for s in spans if s[0].startswith("raycore.wait.")]
    assert waits
    reorder = [s for s in spans if s[0] == REORDER]
    for w in waits:
        assert any(inside(w, s) for s in stages + reorder), w
    # The regrouped driver's octant gate (the grid's rays are in one
    # octant: no sort, no way back).
    assert len(reorder) == (1 if name.endswith("_regrouped") else 0)
    # The subgroup refine, in stage 1 of every query that refines (the
    # worklist does not).
    refine = [s for s in spans if s[0] == REFINE]
    assert len(refine) == (0 if name == "closest_hit_dense_pallas_auto"
                           else 1)
    assert all(inside(r, stages[0]) for r in refine)
    assert len(spans) == len(stages) + len(waits) + len(reorder) \
        + len(refine)


def test_the_wave_sweep_nests_in_stage_one(dense):
    scene, rays = dense
    spans = spans_of(lambda: t_pr.closest_hit_regrouped(scene, rays,
                                                        tile=256, passes=2))
    stage1 = [s for s in spans if s[0] == "raycore.stage1"]
    sweeps = [s for s in spans if s[0] == "raycore.sweep"]
    assert len(stage1) == 1 and len(sweeps) == 2
    assert inside(sweeps[0], stage1[0]) and not inside(sweeps[1],
                                                        stage1[0])
    names = {s[0] for s in spans if inside(s, stage1[0])}
    assert {"raycore.wait.wave", "raycore.wait.prune"} <= names


def tilted(rays):
    """The grid's rays tilted alternately toward +x+y and -x-y, so every
    subgroup of consecutive rays mixes two direction octants."""
    d = rays.d.clone()
    s = torch.where(torch.arange(d.shape[0]) % 2 == 0, 0.3, -0.3)
    d[:, 0], d[:, 1] = s, s
    return rt.Ray.create(rays.o, d / d.norm(dim=1, keepdim=True))


@pytest.mark.parametrize("mixed", [False, True], ids=["one-octant", "mixed"])
def test_the_octant_gate_reorders_only_a_mixed_batch(dense, mixed):
    """The gate's count and readback, and where it engages the sort and
    gathers, in a reorder span before stage 1; where it engages the
    winners back to the caller's order between the combine and the
    finalize."""
    scene, rays = dense
    rays = tilted(rays) if mixed else rays
    spans = spans_of(lambda: t_pr.any_hit_regrouped(scene, rays, tile=256))
    gate = [s for s in spans if s[0] == "raycore.wait.octants"]
    reorder = [s for s in spans if s[0] == REORDER]
    stages = [s for s in spans if s[0] in STAGES]
    assert [s[0] for s in stages] == STAGES and len(gate) == 1
    assert inside(gate[0], reorder[0]) and reorder[0][2] <= stages[0][1]
    assert len(reorder) == (2 if mixed else 1)
    if mixed:
        assert stages[2][2] <= reorder[1][1]
        assert reorder[1][2] <= stages[3][1]


@pytest.mark.parametrize("route", ["closest_hit", "any_hit", "instanced"])
def test_the_root_span_holds_the_query(monkeypatch, dense, instanced,
                                       route):
    monkeypatch.setattr(dispatch, "REGROUP_MIN_RAYS", 1024)
    scene, rays = dense
    if route == "instanced":
        _, scene, rays = instanced
    entry = rt.any_hit if route == "any_hit" else rt.closest_hit
    spans = spans_of(lambda: entry(scene, rays))
    root = f"raycore.{'any_hit' if route == 'any_hit' else 'closest_hit'}"
    assert spans[0][0] == root
    assert [s[0] for s in spans if s[0] in STAGES] == STAGES
    assert all(inside(s, spans[0]) for s in spans)


def test_refresh_runs_in_its_span(instanced):
    mgr, scene, _ = instanced
    spans = spans_of(lambda: rt.refresh_instances(scene, mgr))
    assert spans[0][0] == "raycore.refresh"
    assert [s[0] for s in spans[1:]] == ["raycore.wait.transforms"]
    assert all(inside(s, spans[0]) for s in spans[1:])


# Each query's and the refresh's host waits, in order: compactions, block
# counts, the octant gate's readback, the transforms' upload. Constants
# (safe_invdir's clamp, the interval test's infinity, the pairrow decode's
# sentinel, the combine's dummy subgroup, the box-corner pattern) are made
# on the device, so no wait uploads one.
WAITS = {
    "closest_hit_regrouped": ["octants", "worklist", "refine", "blocks"],
    "any_hit_regrouped": ["octants", "worklist", "refine", "blocks"],
    "closest_hit_dense_pallas_auto": ["worklist", "ranges"],
    "closest_hit_instanced": ["worklist", "refine", "candidates", "blocks"],
    "refresh": ["transforms"],
}


@pytest.mark.parametrize("route", sorted(WAITS))
def test_no_wait_uploads_a_constant(dense, instanced, route):
    if route == "refresh":
        mgr, scene, _ = instanced
        fn = lambda: rt.refresh_instances(scene, mgr)
    else:
        fn = lambda: run_query(route, dense, instanced)
    waits = [s[0] for s in spans_of(fn) if s[0].startswith("raycore.wait.")]
    assert waits == [f"raycore.wait.{w}" for w in WAITS[route]]


def test_grid_counters_match_stage_one(monkeypatch, dense):
    scene, rays = dense
    monkeypatch.setattr(PACK, "slots", 0)
    monkeypatch.setattr(PACK, "filled", 0)
    o, d, t_min, t_max, _, G, TILE = t_pr._padded_batch(rays, 256, 32)
    _, block_subs, _, (_, pairs, blocks) = t_pr._stage1_cm_core(
        scene, o, d, t_min, t_max, TILE, G, 16)
    assert pairs > 0 and blocks == block_subs.shape[0]
    assert PACK.filled == pairs
    assert PACK.slots == blocks * 16
    # Slots past a cluster's last subgroup hold the dummy subgroup.
    n_sub = o.shape[0] // G
    assert int((block_subs != n_sub).sum()) == pairs


def test_grid_counters_match_the_instanced_candidates(monkeypatch,
                                                      instanced):
    _, scene, rays = instanced
    monkeypatch.setattr(PACK, "slots", 0)
    monkeypatch.setattr(PACK, "filled", 0)
    _, s1 = t_inst._query(scene, rays, 256, 32, 16)
    _, _, candidates, blocks = s1.counts
    assert candidates > 0
    assert PACK.filled == candidates
    assert PACK.slots == blocks * 16


def test_refine_counters_match_stage_one(monkeypatch, dense):
    """``tested`` gains the coarse pairs times the subgroups a tile,
    ``kept`` the subgroup pairs stage 1 keeps."""
    scene, rays = dense
    monkeypatch.setattr(REFINE_PAIRS, "tested", 0)
    monkeypatch.setattr(REFINE_PAIRS, "kept", 0)
    o, d, t_min, t_max, _, G, TILE = t_pr._padded_batch(rays, 256, 32)
    _, _, _, (coarse, pairs, _) = t_pr._stage1_cm_core(
        scene, o, d, t_min, t_max, TILE, G, 16)
    assert 0 < pairs < coarse * (TILE // G)
    assert REFINE_PAIRS.tested == coarse * (TILE // G)
    assert REFINE_PAIRS.kept == pairs


def test_refine_counters_match_the_instanced_pairs(monkeypatch, instanced):
    _, scene, rays = instanced
    monkeypatch.setattr(REFINE_PAIRS, "tested", 0)
    monkeypatch.setattr(REFINE_PAIRS, "kept", 0)
    _, s1 = t_inst._query(scene, rays, 256, 32, 16)
    coarse, pairs, _, _ = s1.counts
    assert 0 < pairs <= coarse * (256 // 32)
    assert REFINE_PAIRS.tested == coarse * (256 // 32)
    assert REFINE_PAIRS.kept == pairs


@pytest.fixture(scope="module")
def frame_inputs():
    """A 16 x 12, 4-bounce frame's materials (a checker of 64-triangle
    runs over a matte and a metal), two lights and camera; the scene is
    the dense fixture's."""
    mats = rt.Materials.create(
        base_color=[[0.75, 0.72, 0.68], [0.9, 0.85, 0.8]],
        metallic=[0.0, 0.85], roughness=[0.8, 0.15], device=CPU)
    lights = rt.PointLights.create(
        position=[[2.5, -2.5, 4.0], [-2.0, 2.0, 3.5]],
        intensity=[[18.0, 17.0, 16.0], [6.0, 7.0, 9.0]], device=CPU)
    cam = rt.Camera.create(position=(0.0, -3.2, 2.4), target=(0.0, 0.0, 0.3),
                           fov_deg=55.0, device=CPU)
    cfg = t_pt.PTConfig(width=16, height=12, bounces=4, tile_size=256)
    return mats, lights, cam, cfg


def render(dense, frame_inputs, seed=7):
    mats, lights, cam, cfg = frame_inputs
    return t_pt.trace_paths_staged(dense[0], mats, lights, cam,
                                   torch.Generator().manual_seed(seed), cfg)


def recording(monkeypatch, into):
    """Keep (entry, rays) of every query through dispatch in ``into``."""
    for name in ("scene_closest_hit", "scene_any_hit"):
        def keep(scene, rays, *a, _fn=getattr(dispatch, name), _n=name,
                 **kw):
            into.append((_fn, rays))
            return _fn(scene, rays, *a, **kw)
        monkeypatch.setattr(dispatch, name, keep)


ROOTS = ("raycore.closest_hit", "raycore.any_hit")


def frame_stages(bounces):
    names = ["primary"]
    for b in range(bounces):
        names += ["draws", "nee", "shade"] + (["compact"]
                                              if b < bounces - 1 else [])
    return [f"raycore.render.{n}" for n in names + ["image"]]


@pytest.mark.parametrize("route", ["worklist", "regrouped"])
def test_a_frame_runs_its_stages_in_order_around_its_queries(
        monkeypatch, dense, frame_inputs, route):
    if route == "regrouped":
        monkeypatch.setattr(dispatch, "REGROUP_MIN_RAYS", 64)
    queries = []
    recording(monkeypatch, queries)
    spans = spans_of(lambda: render(dense, frame_inputs))
    assert spans[0][0] == "raycore.render"
    assert all(inside(s, spans[0]) for s in spans)
    B = frame_inputs[3].bounces
    stages = [s for s in spans if s[0].startswith("raycore.render.")]
    assert [s[0] for s in stages] == frame_stages(B)
    for a, b in zip(stages, stages[1:]):
        assert a[2] <= b[1], (a, b)
    # Each bounce: draws, its closest query, nee, its occlusion query,
    # shade.
    roots = [s for s in spans if s[0] in ROOTS]
    assert [s[0] for s in roots] == list(ROOTS) * B
    at = {n: [s for s in stages if s[0] == f"raycore.render.{n}"]
          for n in ("draws", "nee", "shade")}
    for b in range(B):
        closest, occl = roots[2 * b], roots[2 * b + 1]
        assert at["draws"][b][2] <= closest[1] and closest[2] \
            <= at["nee"][b][1]
        assert at["nee"][b][2] <= occl[1] and occl[2] <= at["shade"][b][1]
    # No wait outside a query, and the frame's waits are its queries' own:
    # the same queries run alone wait at the same sites.
    waits = [s for s in spans if s[0].startswith("raycore.wait.")]
    assert waits and all(any(inside(w, r) for r in roots) for w in waits)
    monkeypatch.undo()
    if route == "regrouped":
        monkeypatch.setattr(dispatch, "REGROUP_MIN_RAYS", 64)
    alone = []
    for fn, rays in queries:
        alone += [s[0] for s in spans_of(lambda: fn(dense[0], rays,
                                                    tile_size=256))
                  if s[0].startswith("raycore.wait.")]
    assert [w[0] for w in waits] == alone


def test_a_frame_enters_no_span_with_no_profiler(monkeypatch, dense,
                                                 frame_inputs):
    def refuse(name):
        raise AssertionError(f"span {name} entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    img = render(dense, frame_inputs)
    assert float(img.max()) > 0


def test_a_frames_glue_uploads_no_number_from_the_host(monkeypatch, dense,
                                                       frame_inputs):
    """Outside its queries a frame makes every tensor on the device: an
    upload of a host number (``torch.tensor`` or ``torch.as_tensor`` of
    one) would wait on the card for the work queued before it."""
    depth, uploads = [0], []
    for name in ("scene_closest_hit", "scene_any_hit"):
        def nested(*a, _fn=getattr(dispatch, name), **kw):
            depth[0] += 1
            try:
                return _fn(*a, **kw)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(dispatch, name, nested)
    for name in ("tensor", "as_tensor"):
        def made(data, *a, _fn=getattr(torch, name), _n=name, **kw):
            if depth[0] == 0 and not isinstance(data, torch.Tensor):
                uploads.append((_n, data))
            return _fn(data, *a, **kw)
        monkeypatch.setattr(torch, name, made)
    render(dense, frame_inputs)
    assert uploads == []


def test_a_frame_counts_what_it_submits(monkeypatch, dense, frame_inputs):
    for name in ("frames", "queries", "rays", "live"):
        monkeypatch.setattr(t_pt._frames, name, 0)
    queries = []
    recording(monkeypatch, queries)
    render(dense, frame_inputs)
    cfg = frame_inputs[3]
    R = cfg.width * cfg.height * cfg.spp
    assert t_pt._frames.frames == 1
    assert t_pt._frames.queries == len(queries) == 2 * cfg.bounces
    assert t_pt._frames.rays == sum(r.t_max.shape[0] for _, r in queries) \
        == 2 * cfg.bounces * R
    live = sum(int((r.t_max >= 0).sum()) for _, r in queries[0::2])
    assert isinstance(t_pt._frames.live, torch.Tensor)
    assert int(t_pt._frames.live) == live
    assert R < live < cfg.bounces * R
