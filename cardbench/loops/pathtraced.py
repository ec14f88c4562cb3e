"""A closed loop of path-traced frames: set-up builds the configuration's
scene (``build_triangles`` with each triangle's material, ``build_dense``)
and its materials, lights and camera; frame k renders one whole image
through ``render/pathtracer.py:trace_paths_staged`` with a generator
seeded by the traffic's set k mod the cycle. Each frame runs 2 x
``bounces`` queries of width x height x spp rays through
``accel/dispatch.py``. The image of each checked set's latest frame is
kept.

The check renders each checked set again with the dispatch entry points
(and the compaction's key, ``_sort_key``, which no query shows) wrapped,
keeping every query's rays and answers, and holds:

- the re-rendered image to the kept one, bit for bit (``rerender_gap``,
  the largest difference), which ties what is judged to the timed path;
- from each bounce, a seeded sample of live lanes and up to
  ``DEAD_PER_QUERY`` dead ones: the closest queries' as closest hits,
  the occlusion queries' as occlusion answers (``core/judge.py``); a dead
  lane (t_max -1) must report no hit (``dead_hits``, a count);
- the glue, for a seeded sample of pixels followed through every bounce
  by path id, against the plain float64 reference of
  ``cardbench/reference/pathtracer.py`` fed the frame's own rays and
  answers: ``glue_gap``, the widest relative gap of the frame's primary
  rays, its shadow rays, its next bounces' rays and liveness and its
  compaction keys; ``pixel_gap``, the widest relative gap of the image
  at the sampled pixels.

With ``control`` the reference in float16 takes the frame's place in
``glue_gap`` and ``pixel_gap``, and the tracer at TF32 its answers on
the dead lanes.
"""
from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from cardbench.core import judge, work
from cardbench.reference import pathtracer as plain
from cardbench.reference import tracer

DEAD_PER_QUERY = 16
# The darkest reference value a pixel's gap is relative to: below it the
# gap is absolute (an 8-bit display step is 1/255).
PIXEL_FLOOR = 1e-3
# A discrete disagreement (liveness, a shadow ray left alive, a dead
# bit) reads as this gap.
MISMATCH = 1.0


def rel(a, b) -> torch.Tensor:
    """(S,) largest component difference of ``a`` from ``b``, relative to
    the larger of b's largest component and 1 (the scene's unit: its
    heightfield spans 2 units, a direction is a unit vector)."""
    a, b = a.double(), b.double()
    if a.dim() == 1:
        a, b = a[:, None], b[:, None]
    return (a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1.0)


def key_gap(key, o, d, alive, lo, hi) -> torch.Tensor:
    """(S,) how far compaction keys ``key`` lie from the reference's
    float64 next rays: ``MISMATCH`` where the dead bit disagrees with
    ``alive``; for a live path the widest of the distance from the
    origin's position in the scene's box ([0, 1] an axis) to the cell the
    key names, and |d| along an axis whose octant bit disagrees."""
    dead, octant, cell = plain.decode_key(key)
    x = plain.normalized(o.double(), lo.double(), hi.double())
    c = cell.double()
    outside = torch.maximum(c / 512 - x, x - (c + 1) / 512).clamp(min=0.0)
    d = d.double()
    wrong = torch.where(octant != (d > 0), d.abs(), 0.0)
    gap = torch.where(alive, torch.maximum(outside.amax(1), wrong.amax(1)),
                      0.0)
    return torch.where(dead == alive, MISMATCH, gap)


def glue_gap(got: dict, ref: dict, lo, hi) -> float:
    """The widest gap of a frame's derived rays (``got``) from the
    reference's (``ref``), in the layout of ``plain.derive``."""
    gaps = [rel(got["o"], ref["o"]), rel(got["d"], ref["d"])]
    for g, r in zip(got["bounces"], ref["bounces"]):
        hit = r["hit"]
        shadow = torch.stack([rel(g["so"], r["so"]), rel(g["wi"], r["wi"]),
                              rel(g["st"], r["st"])]).amax(0)
        gaps.append(torch.where(hit, shadow, torch.where(
            g["st"].double() == -1.0, 0.0, MISMATCH)))
        if "next_o" not in r:
            continue
        alive = r["next_alive"]
        nxt = torch.maximum(rel(g["next_o"], r["next_o"]),
                            rel(g["next_d"], r["next_d"]))
        gaps.append(torch.where(g["next_alive"] != alive, MISMATCH,
                                torch.where(alive, nxt, 0.0)))
        gaps.append(key_gap(g["key"], r["next_o"], r["next_d"], alive, lo,
                            hi))
    return judge.widest(torch.cat(gaps))


def pixel_gap(got, ref) -> float:
    """The widest gap of pixels ``got`` from the reference's, relative to
    the reference's value or ``PIXEL_FLOOR``."""
    got, ref = got.double(), ref.double()
    return judge.widest(((got - ref).abs()
                         / ref.abs().clamp(min=PIXEL_FLOOR)).amax(1))


class Loop:
    occlusion = False

    def __init__(self, ctx):
        self.ctx = ctx
        rt, dev, cfg = ctx.program, ctx.device, ctx.config
        self.pt = importlib.import_module(
            f"{rt.__name__}.render.pathtracer")
        self.dispatch = importlib.import_module(
            f"{rt.__name__}.accel.dispatch")
        scene = ctx.module("scenes", cfg["scene"]["generator"]).generate(
            cfg["scene"]["params"])
        self.verts, self.faces = scene["verts"], scene["faces"]
        mats = cfg["materials"]
        n_faces = self.faces.shape[0]
        meta = (np.arange(n_faces) // mats["run"]) % len(mats["base_color"])
        tris = rt.build_triangles(self.verts, self.faces,
                                  normals=scene["normals"], metadata=meta,
                                  device=dev)
        if tris.vertices.shape[0] != n_faces:
            raise ValueError("the scene has degenerate faces: the program "
                             "would drop them and renumber the rest")
        build = cfg["build"]
        self.scene = rt.build_dense(tris, cluster_size=build["cluster_size"],
                                    sub_chunks=build["sub_chunks"])
        del tris
        self.materials = rt.Materials.create(
            base_color=mats["base_color"], metallic=mats["metallic"],
            roughness=mats["roughness"], device=dev)
        li, cam, r = cfg["lights"], cfg["camera"], cfg["render"]
        self.lights = rt.PointLights.create(position=li["position"],
                                            intensity=li["intensity"],
                                            device=dev)
        self.camera = rt.Camera.create(
            position=cam["position"], target=cam["target"], up=cam["up"],
            fov_deg=cam["fov_deg"], device=dev)
        self.cfg = self.pt.PTConfig(
            width=r["width"], height=r["height"], spp=r["spp"],
            bounces=r["bounces"], tile_size=r["tile_size"], eps=r["eps"],
            background=tuple(r["background"]), compact=r["compact"])
        self.seeds = ctx.module("traffic", ctx.traffic["generator"]).generate(
            ctx.traffic["params"], ctx.seed, scene, dev)
        self.R = r["width"] * r["height"] * r["spp"]
        self.rays_per_call = 2 * r["bounces"] * self.R
        self.work_bytes = r["bounces"] * (
            work.query_bytes(n_faces, self.R, work.CLOSEST_FULL_BYTES)
            + work.query_bytes(n_faces, self.R, work.OCCLUSION_BYTES))
        self.kept = {}
        self.check_sets = set()

    def choose(self, rng, n_check: int) -> None:
        """The sets whose frames the check will compare."""
        self.check_sets = set(rng.choice(len(self.seeds), n_check,
                                         replace=False).tolist())

    def frame(self, s: int):
        gen = torch.Generator(device=self.ctx.device).manual_seed(
            self.seeds[s])
        return self.pt.trace_paths_staged(self.scene, self.materials,
                                          self.lights, self.camera, gen,
                                          self.cfg)

    def call(self, k: int):
        return self.frame(k % len(self.seeds))

    def keep(self, k: int, img) -> None:
        s = k % len(self.seeds)
        if s in self.check_sets:
            self.kept[s] = img

    def complete(self) -> bool:
        return set(self.kept) == self.check_sets

    @contextlib.contextmanager
    def recording(self):
        """Inside the block every query through dispatch's entry points is
        kept in order (kind, rays, answers), and every compaction key."""
        queries, keys = [], []
        d, pt = self.dispatch, self.pt
        saved = d.scene_closest_hit, d.scene_any_hit, pt._sort_key

        def keep(fn, kind):
            def wrapped(scene, rays, *a, **kw):
                out = fn(scene, rays, *a, **kw)
                queries.append((kind, rays, out))
                return out
            return wrapped

        def sort_key(*a, **kw):
            keys.append(saved[2](*a, **kw))
            return keys[-1]

        d.scene_closest_hit = keep(saved[0], "closest")
        d.scene_any_hit = keep(saved[1], "occlusion")
        pt._sort_key = sort_key
        try:
            yield queries, keys
        finally:
            d.scene_closest_hit, d.scene_any_hit, pt._sort_key = saved

    def samples(self, rng, per_slot: int) -> list:
        """For each kept frame: a closest-hit sample and an occlusion
        sample, ``per_slot / bounces`` live lanes and up to
        ``DEAD_PER_QUERY`` dead ones of each of its queries of that kind,
        and, on the closest-hit sample, the glue of ``per_slot`` pixels'
        paths (module docstring)."""
        B = self.cfg.bounces
        v9 = self.triangles(None).reshape(-1, 9)
        out = []
        for s in sorted(self.kept):
            timed = self.kept[s]
            with self.recording() as (queries, keys):
                img = self.frame(s)
            if [q[0] for q in queries] != ["closest", "occlusion"] * B or \
                    len(keys) != B - 1:
                raise RuntimeError(f"a frame made {[q[0] for q in queries]}"
                                   f" queries and {len(keys)} compactions")
            again = judge.widest((img - timed).abs().reshape(-1))
            closest, occl = queries[0::2], queries[1::2]
            parts = {"closest": [], "occlusion": []}
            for kind, rays, res in queries:
                parts[kind].append(self._lanes(rng, rays, res, kind,
                                               per_slot // B, v9))
            cat = lambda ds: {k: torch.cat([x[k] for x in ds]) for k in ds[0]}
            for kind in ("closest", "occlusion"):
                rays, got, dead = (cat([p[i] for p in parts[kind]])
                                   for i in range(3))
                sample = dict(key=s, occlusion=kind == "occlusion",
                              rays=rays, got=got, dead=dead["dead"],
                              rerender_gap=again)
                if kind == "closest":
                    sample["glue"] = self._glue(rng, s, per_slot, closest,
                                                occl, keys, timed)
                out.append(sample)
            del queries, keys, closest, occl, img
        return out

    def _lanes(self, rng, rays, res, kind, n_live, v9):
        """A sample of ``n_live`` live and up to ``DEAD_PER_QUERY`` dead
        lanes of one query: (rays, answers, {"dead": mask})."""
        live = rays.t_max >= 0
        rows = []
        for mask, n in ((live, n_live), (~live, DEAD_PER_QUERY)):
            idx = torch.nonzero(mask).squeeze(1)
            n = min(n, idx.numel())
            if n:
                rows.append(idx[torch.as_tensor(rng.choice(
                    idx.numel(), n, replace=False), device=idx.device)])
        rows = torch.cat(rows)
        hit = res.hit[rows]
        got = dict(hit=hit, idx=torch.where(hit, res.prim_idx[rows].long(),
                                            -1))
        if kind == "closest":
            got["t"] = res.t[rows]
            got["bary"] = res.barycentric[rows][:, 1:]
            got["payload"] = res.triangle.vertices[rows].reshape(-1, 9)
            ok = (got["idx"] >= 0) & (got["idx"] < v9.shape[0])
            got["want"] = torch.where(
                ok[:, None], v9[got["idx"].clamp(0, v9.shape[0] - 1)],
                float("nan"))
        batch = dict(o=rays.o[rows], d=rays.d[rows], t_min=rays.t_min[rows],
                     t_max=rays.t_max[rows])
        return batch, got, dict(dead=~live[rows])

    def _glue(self, rng, s, n_pixels, closest, occl, keys, timed) -> dict:
        """The frame's inputs and what it derived at the lanes of
        ``n_pixels`` sampled pixels' paths, bounce by bounce
        (``plain.follow``), and the timed image at those pixels."""
        spp = self.cfg.spp
        dev = self.ctx.device
        pix = torch.as_tensor(rng.choice(self.R // spp, n_pixels,
                                         replace=False), device=dev)
        pid = (pix[:, None] * spp + torch.arange(spp, device=dev)).reshape(-1)
        data, got = plain.follow([q[1:] for q in closest],
                                 [q[1:] for q in occl], keys, pid)
        got["pixel"] = timed.reshape(-1, 3)[pix]
        return dict(seed=self.seeds[s], data=data, got=got)

    def judge(self, sample, v, control=False) -> dict:
        """The loop's own numbers of a sample (module docstring)."""
        dead = sample["dead"]
        r = {k: x[dead] for k, x in sample["rays"].items()}
        if not control:
            hits = sample["got"]["hit"][dead]
        elif r["o"].shape[0]:
            hits = tracer.trace(v, r["o"], r["d"], r["t_min"], r["t_max"],
                                occlusion=sample["occlusion"],
                                precision="tf32")["hit"]
        else:
            hits = dead[dead]
        own = dict(dead_hits=float(hits.sum()),
                   rerender_gap=0.0 if control else sample["rerender_gap"])
        if "glue" not in sample:
            return own
        g = sample["glue"]
        c = self.ctx.config
        r = c["render"]
        draws = plain.frame_draws(g["seed"], self.R, r["height"], r["width"],
                                  r["spp"], len(c["lights"]["position"]),
                                  r["bounces"], self.ctx.device)
        corners = v.reshape(-1, 3)
        lo, hi = corners.amin(0), corners.amax(0)
        ref = plain.derive(plain.setting(c, torch.float64, self.ctx.device),
                           g["data"], draws, lo, hi)
        if control:
            got = plain.derive(plain.setting(c, torch.float16,
                                             self.ctx.device),
                               g["data"], draws, lo, hi)
            pixels = plain.pixels(got["radiance"], r["spp"])
        else:
            got, pixels = g["got"], g["got"]["pixel"]
        own["glue_gap"] = glue_gap(got, ref, lo, hi)
        own["pixel_gap"] = pixel_gap(pixels,
                                     plain.pixels(ref["radiance"], r["spp"]))
        return own

    def release(self) -> None:
        self.scene = self.kept = self.materials = self.lights = None
        self.camera = None

    def triangles(self, key) -> torch.Tensor:
        v = torch.as_tensor(self.verts, dtype=torch.float64,
                            device=self.ctx.device)
        return v[torch.as_tensor(self.faces, device=self.ctx.device)]
