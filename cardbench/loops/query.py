"""A closed loop of queries on one static scene: the scene's triangles go
to the program through ``build_triangles`` and ``build_dense``, the
traffic's ray batches through ``Ray.create``, and call k runs the cell's
entry (``closest_hit`` or ``any_hit``) on batch k mod the cycle. The
result of each batch's latest call is kept for the check."""
from __future__ import annotations

import torch

from cardbench.core import work

RESULT_BYTES = {"closest_hit": work.CLOSEST_FULL_BYTES,
                "any_hit": work.OCCLUSION_BYTES}


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        rt, dev, cfg = ctx.program, ctx.device, ctx.config
        self.entry = ctx.cell["entry"]
        self.occlusion = self.entry == "any_hit"
        scene = ctx.module("scenes", cfg["scene"]["generator"]).generate(
            cfg["scene"]["params"])
        self.verts, self.faces = scene["verts"], scene["faces"]
        tris = rt.build_triangles(self.verts, self.faces,
                                  normals=scene["normals"], device=dev)
        if tris.vertices.shape[0] != self.faces.shape[0]:
            raise ValueError("the scene has degenerate faces: the program "
                             "would drop them and renumber the rest")
        build = cfg["build"]
        self.scene = rt.build_dense(tris, cluster_size=build["cluster_size"],
                                    sub_chunks=build["sub_chunks"])
        del tris
        traffic = ctx.traffic
        self.batches = ctx.module("traffic", traffic["generator"]).generate(
            traffic["params"], ctx.seed, scene, dev)
        self.rays = [rt.Ray.create(b["o"], b["d"], t_min=b["t_min"],
                                   t_max=b["t_max"]) for b in self.batches]
        self.rays_per_call = self.batches[0]["o"].shape[0]
        self.work_bytes = work.query_bytes(
            self.faces.shape[0], self.rays_per_call, RESULT_BYTES[self.entry])
        self.kept = {}

    def call(self, k: int):
        entry = getattr(self.ctx.program, self.entry)
        return entry(self.scene, self.rays[k % len(self.rays)])

    def keep(self, k: int, res) -> None:
        self.kept[k % len(self.rays)] = res

    def complete(self) -> bool:
        return len(self.kept) == len(self.rays)

    def samples(self, rng, per_slot: int) -> list:
        """One check of ``per_slot`` rays drawn from ``rng`` in each kept
        batch, all against the one scene."""
        parts = []
        for slot in sorted(self.kept):
            res, batch = self.kept[slot], self.batches[slot]
            rows = torch.as_tensor(rng.choice(
                self.rays_per_call, per_slot, replace=False),
                device=batch["o"].device)
            got = dict(hit=res.hit[rows], idx=res.prim_idx[rows].long(),
                       t=res.t[rows])
            got["idx"] = torch.where(got["hit"], got["idx"], -1)
            if not self.occlusion:
                got["bary"] = res.barycentric[rows][:, 1:]
                got["payload"] = res.triangle.vertices[rows].reshape(-1, 9)
                got["want"] = self.named_vertices(got["idx"])
            parts.append((dict((k, v[rows]) for k, v in batch.items()), got))
        cat = lambda ds: {k: torch.cat([d[k] for d in ds]) for k in ds[0]}
        return [dict(key=None, rays=cat([p[0] for p in parts]),
                     got=cat([p[1] for p in parts]))]

    def named_vertices(self, idx) -> torch.Tensor:
        """(S, 9) float64 generated vertices of triangles ``idx``, NaN
        where ``idx`` names none. (The scene's normals are flat: the
        program may recompute them, so they are not compared.)"""
        v = self.triangles(None).reshape(-1, 9)
        ok = (idx >= 0) & (idx < v.shape[0])
        return torch.where(ok[:, None], v[idx.clamp(0, v.shape[0] - 1)],
                           float("nan"))

    def release(self) -> None:
        self.scene = self.rays = self.kept = None

    def triangles(self, key) -> torch.Tensor:
        v = torch.as_tensor(self.verts, dtype=torch.float64,
                            device=self.ctx.device)
        return v[torch.as_tensor(self.faces, device=self.ctx.device)]
