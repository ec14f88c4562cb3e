"""The path tracer's glue against a plain float64 reference fed the
frame's own answers, on the CPU (``cardbench/reference/pathtracer.py``,
the reference the benchmark's check of the path-traced frame uses).

A 32 x 24, 3-bounce ``trace_paths_staged`` frame on a small heightfield
with the benchmark configuration's two materials (a checker of 64-
triangle runs), two lights and camera: every query's rays and answers
and every compaction key are recorded; each path is followed by id
through the bounces (its lane moves by the stable sort of the recorded
keys), and the reference derives from each bounce's rays and answers
and the frame's draws (drawn again from a generator seeded as the
frame's) the shadow rays, the next rays, their liveness and keys, and
each pixel's radiance. Tolerances:

- ``GLUE_TOL`` (1e-5, relative to the larger of the value and 1): each
  derived number is a few float32 operations on float32 inputs, each
  rounding by at most 6e-8 of its size; the largest growth is the cosine
  lift sqrt(1 - r^2) near the disk's rim (the frames here read at most
  about 4e-7); the reference in float16 misses by more than 1e-3.
- ``PIXEL_TOL`` (1e-5, relative to the larger of the pixel and 1e-3): a
  pixel sums at most two positive float32 terms a bounce; the same
  margin.
- keys: equal, but where the reference's origin lies within
  ``KEY_EDGE`` of a cell's edge (in the scene's box, [0, 1] an axis) or
  a direction component within it of 0, where float32 may round across.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu_torch.accel import dispatch
from raycore_tpu_torch.render import pathtracer as tp

CARDBENCH = Path(__file__).resolve().parents[1] / "cardbench"


def _load_reference():
    path = CARDBENCH / "reference" / "pathtracer.py"
    spec = importlib.util.spec_from_file_location("bench_pathtracer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


plain = _load_reference()
CPU = torch.device("cpu")
GLUE_TOL = 1e-5
PIXEL_TOL = 1e-5
PIXEL_FLOOR = 1e-3
KEY_EDGE = 1e-6
# The benchmark configuration's settings at a small size.
CONFIG = json.loads((CARDBENCH / "configs" / "heightfield-1m-pt.json")
                    .read_text())
CONFIG["render"].update(width=32, height=24, bounces=3, tile_size=256)


@pytest.fixture(scope="module")
def world():
    """The scene, its float64 triangles and the frame's inputs."""
    n = 24
    meta = (np.arange(2 * n * n) // CONFIG["materials"]["run"]) % 2
    mesh = rt.displaced_grid_mesh(n=n, metadata=meta, device=CPU)
    scene = rt.build_dense(mesh, cluster_size=64)
    m, li, c = CONFIG["materials"], CONFIG["lights"], CONFIG["camera"]
    mats = rt.Materials.create(base_color=m["base_color"],
                               metallic=m["metallic"],
                               roughness=m["roughness"], device=CPU)
    lights = rt.PointLights.create(position=li["position"],
                                   intensity=li["intensity"], device=CPU)
    cam = rt.Camera.create(position=c["position"], target=c["target"],
                           up=c["up"], fov_deg=c["fov_deg"], device=CPU)
    corners = mesh.vertices.double().reshape(-1, 3)
    return scene, mats, lights, cam, corners.amin(0), corners.amax(0)


def settings(spp):
    cfg = dict(CONFIG, render=dict(CONFIG["render"], spp=spp))
    r = cfg["render"]
    return cfg, tp.PTConfig(width=r["width"], height=r["height"], spp=spp,
                            bounces=r["bounces"], tile_size=r["tile_size"],
                            eps=r["eps"], background=tuple(r["background"]))


def recorded_frame(world, cfg, seed):
    """The frame's image, its queries in order (kind, rays, answers) and
    its compaction keys."""
    scene, mats, lights, cam = world[:4]
    queries, keys = [], []
    saved = dispatch.scene_closest_hit, dispatch.scene_any_hit, tp._sort_key

    def keep(fn, kind):
        def wrapped(scene, rays, *a, **kw):
            out = fn(scene, rays, *a, **kw)
            queries.append((kind, rays, out))
            return out
        return wrapped

    def keyed(*a, **kw):
        keys.append(saved[2](*a, **kw))
        return keys[-1]

    dispatch.scene_closest_hit = keep(saved[0], "closest")
    dispatch.scene_any_hit = keep(saved[1], "occlusion")
    tp._sort_key = keyed
    try:
        img = tp.trace_paths_staged(scene, mats, lights, cam,
                                    torch.Generator().manual_seed(seed), cfg)
    finally:
        dispatch.scene_closest_hit, dispatch.scene_any_hit, tp._sort_key = \
            saved
    return img, queries, keys


def followed(queries, keys):
    """Every path's inputs and what the frame derived for it
    (``plain.follow``; path id = lane at bounce 0)."""
    closest = [q[1:] for q in queries[0::2]]
    pid = torch.arange(closest[0][0].o.shape[0])
    return plain.follow(closest, [q[1:] for q in queries[1::2]], keys, pid)


def rel(a, b):
    a, b = a.double(), b.double()
    if a.dim() == 1:
        a, b = a[:, None], b[:, None]
    return ((a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1.0))


def reference(world, config, seed, data, dtype=torch.float64):
    r = config["render"]
    R = r["width"] * r["height"] * r["spp"]
    draws = plain.frame_draws(seed, R, r["height"], r["width"], r["spp"],
                              len(config["lights"]["position"]),
                              r["bounces"], CPU)
    return plain.derive(plain.setting(config, dtype, CPU), data, draws,
                        *world[4:])


def glue_errors(got, ref, lo, hi):
    """Per bounce: the widest relative gap of the shadow rays and of the
    next rays, the liveness and shadow-range disagreements, and the keys
    that differ away from a cell's edge."""
    out = [dict(primary=float(torch.maximum(rel(got["o"], ref["o"]),
                                            rel(got["d"], ref["d"])).max()))]
    for g, r in zip(got["bounces"], ref["bounces"]):
        e = {}
        hit = r["hit"]
        e["shadow"] = float(torch.stack([
            rel(g["so"], r["so"]), rel(g["wi"], r["wi"]),
            rel(g["st"], r["st"])]).amax(0)[hit].max())
        e["st_off"] = int((g["st"][~hit] != -1).sum())
        if "next_o" in r:
            alive = r["next_alive"]
            e["alive_off"] = int((g["next_alive"] != alive).sum())
            e["next"] = float(torch.maximum(
                rel(g["next_o"], r["next_o"]),
                rel(g["next_d"], r["next_d"]))[alive].max())
            x = plain.normalized(r["next_o"].double(), lo, hi)
            near = ((x * 512 - (x * 512).round()).abs() < KEY_EDGE * 512) \
                | (r["next_d"].double().abs() < KEY_EDGE)
            e["keys_off"] = int(((g["key"] != r["key"])
                                 & ~(alive[:, None] & near).any(1)).sum())
        out.append(e)
    return out


def pixel_error(img, ref_pixels):
    got = img.reshape(-1, 3).double()
    ref = ref_pixels.double()
    return float(((got - ref).abs() / ref.abs().clamp(min=PIXEL_FLOOR)).max())


@pytest.mark.parametrize("route,spp,seed", [("worklist", 1, 3),
                                            ("regrouped", 1, 4),
                                            ("worklist", 2, 5)])
def test_each_bounce_and_the_image_match_the_plain_reference(
        monkeypatch, world, route, spp, seed):
    if route == "regrouped":
        monkeypatch.setattr(dispatch, "REGROUP_MIN_RAYS", 256)
    config, cfg = settings(spp)
    img, queries, keys = recorded_frame(world, cfg, seed)
    assert [q[0] for q in queries] == ["closest", "occlusion"] * 3
    assert len(keys) == 2
    data, got = followed(queries, keys)
    ref = reference(world, config, seed, data)
    errors = glue_errors(got, ref, *world[4:])
    assert errors[0]["primary"] <= GLUE_TOL, errors
    for e in errors[1:]:
        assert e["shadow"] <= GLUE_TOL and e["st_off"] == 0, errors
        assert e.get("next", 0.0) <= GLUE_TOL, errors
        assert e.get("alive_off", 0) == e.get("keys_off", 0) == 0, errors
    # The frame has hits, misses, both materials and occluded shadow rays.
    first = data["bounces"][0]
    assert bool(first["hit"].any()) and not bool(first["hit"].all())
    assert set(first["meta"][first["hit"]].tolist()) == {0, 1}
    assert bool(first["occ"].any())
    assert pixel_error(img, plain.pixels(ref["radiance"], spp)) <= PIXEL_TOL


def test_the_reference_in_float16_misses_the_frame(monkeypatch, world):
    """Computing the glue below float32 fails both tolerances."""
    config, cfg = settings(1)
    _, queries, keys = recorded_frame(world, cfg, 3)
    data, _ = followed(queries, keys)
    ref = reference(world, config, 3, data)
    low = reference(world, config, 3, data, torch.float16)
    errors = glue_errors(low, ref, *world[4:])
    assert max(max(v for k, v in e.items() if not k.endswith("_off"))
               for e in errors) > 10 * GLUE_TOL
    assert pixel_error(plain.pixels(low["radiance"], 1),
                       plain.pixels(ref["radiance"], 1)) > 10 * PIXEL_TOL


def _wrong_lights(fn):
    return lambda *a, **kw: fn(*a, **dict(kw, n_lights=1))


def _not_unpermuted(fn):
    return lambda radiance, order, *a: fn(radiance,
                                          torch.arange(order.numel()), *a)


def _no_eps(fn):
    def wrapped(*a, **kw):
        a = list(a)
        a[11] = 0.0              # _pt_prep_nee's eps
        return fn(*a, **kw)
    return wrapped


@pytest.mark.parametrize("name,fault,where", [
    ("_pt_shade_and_sample", _wrong_lights, "pixel"),
    ("_image", _not_unpermuted, "pixel"),
    ("_pt_prep_nee", _no_eps, "shadow")],
    ids=["n_lights_dropped", "unpermute_skipped", "eps_zero"])
def test_a_planted_glue_fault_misses_the_reference(monkeypatch, world, name,
                                                   fault, where):
    config, cfg = settings(1)
    monkeypatch.setattr(tp, name, fault(getattr(tp, name)))
    img, queries, keys = recorded_frame(world, cfg, 3)
    data, got = followed(queries, keys)
    ref = reference(world, config, 3, data)
    if where == "pixel":
        assert pixel_error(img, plain.pixels(ref["radiance"], 1)) \
            > 100 * PIXEL_TOL
    else:
        assert glue_errors(got, ref, *world[4:])[1]["shadow"] > 10 * GLUE_TOL
