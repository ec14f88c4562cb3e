"""A closed loop of frames of a moving instanced scene: set-up pushes
each instance's base mesh (``build_triangles``) with its resting pose
into a ``TLAS``, syncs it and bakes it (``bake_instanced``); frame k
sets every instance's transform to the traffic's set k mod the cycle
(``TLAS.update_transform``), follows them (``refresh_instances``) and
runs ``closest_hit`` on the traffic's rays. The result of the latest
frame of each checked set is kept for the check."""
from __future__ import annotations

import numpy as np
import torch

from cardbench.core import work
from cardbench.core.trace import REFRESH_SPAN


class Loop:
    occlusion = False

    def __init__(self, ctx):
        self.ctx = ctx
        rt, dev, cfg = ctx.program, ctx.device, ctx.config
        mod = ctx.module("scenes", cfg["scene"]["generator"])
        self.scene_data = mod.generate(cfg["scene"]["params"])
        self.world_triangles = mod.world_triangles
        traffic = ctx.module("traffic", ctx.traffic["generator"]).generate(
            ctx.traffic["params"], ctx.seed, self.scene_data, dev)
        self.transforms = traffic["transforms"]
        bases = []
        for v, f, n in self.scene_data["bases"]:
            tris = rt.build_triangles(v, f, normals=n, device=dev)
            if tris.vertices.shape[0] != f.shape[0]:
                raise ValueError("a base mesh has degenerate faces")
            bases.append(tris)
        self.mgr = rt.TLAS(device=dev)
        self.handles = [self.mgr.push(bases[b], traffic["initial"][i])
                        for i, b in enumerate(self.scene_data["base_of"])]
        self.mgr.sync()
        self.scene = rt.bake_instanced(
            self.mgr, cluster_size=cfg["build"]["cluster_size"])
        b = traffic["rays"]
        self.batch = b
        self.rays = rt.Ray.create(b["o"], b["d"], t_min=b["t_min"],
                                  t_max=b["t_max"])
        self.rays_per_call = b["o"].shape[0]
        n_tris = sum(v[1].shape[0] for v in self.scene_data["bases"])
        self.work_bytes = work.frame_bytes(
            n_tris, len(self.handles), self.rays_per_call,
            work.CLOSEST_FULL_BYTES)
        self.kept = {}
        self.check_sets = set()

    def choose(self, rng, n_check: int) -> None:
        """The sets whose frames the check will compare."""
        self.check_sets = set(rng.choice(len(self.transforms), n_check,
                                         replace=False).tolist())

    def call(self, k: int):
        rt = self.ctx.program
        s = k % len(self.transforms)
        with self.ctx.span(REFRESH_SPAN):
            for h, m in zip(self.handles, self.transforms[s]):
                self.mgr.update_transform(h, m)
            self.scene = rt.refresh_instances(self.scene, self.mgr)
            self.ctx.traced_sync()
        return rt.closest_hit(self.scene, self.rays)

    def keep(self, k: int, res) -> None:
        s = k % len(self.transforms)
        if s in self.check_sets:
            self.kept[s] = res

    def complete(self) -> bool:
        return set(self.kept) == self.check_sets

    def samples(self, rng, per_slot: int) -> list:
        """``per_slot`` rays drawn from ``rng`` in each kept frame, each
        against its own set's world triangles. A hit names the row
        ``first[instance] + metadata`` of ``world_triangles`` (-1, no
        triangle, where instance or metadata lie out of range)."""
        _, first = self.world_triangles(self.scene_data, self.transforms[0])
        dev = self.ctx.device
        first = torch.as_tensor(first, device=dev)
        count = torch.as_tensor([self.scene_data["bases"][b][1].shape[0]
                                 for b in self.scene_data["base_of"]],
                                device=dev)
        out = []
        for s in sorted(self.kept):
            res = self.kept[s]
            rows = torch.as_tensor(rng.choice(
                self.rays_per_call, per_slot, replace=False),
                device=self.ctx.device)
            hit = res.hit[rows]
            inst = res.instance_idx[rows].long()
            meta = res.triangle.metadata[rows].long()
            i = inst.clamp(0, first.numel() - 1)
            ok = (hit & (inst == i) & (meta >= 0) & (meta < count[i]))
            idx = torch.where(ok, first[i] + meta, -1)
            tri = res.triangle
            payload = torch.cat([tri.vertices[rows].reshape(-1, 9),
                                 tri.normals[rows].reshape(-1, 9)], 1)
            want, has_n = self.named_local(idx)
            payload[:, 9:] = torch.where(has_n[:, None], payload[:, 9:], 0.0)
            out.append(dict(key=s, rays={k: v[rows]
                                         for k, v in self.batch.items()},
                            got=dict(hit=hit, idx=idx, t=res.t[rows],
                                     bary=res.barycentric[rows][:, 1:],
                                     payload=payload, want=want)))
        return out

    def named_local(self, idx):
        """For world rows ``idx``: (S, 18) float64 generated vertices and
        normals of the named face in its base mesh's space, where the
        program returns them (NaN where ``idx`` names none; normals 0
        where the base mesh has none, since the program may recompute
        flat ones), and (S,) whether normals are compared."""
        rows, has = [], []
        for b in self.scene_data["base_of"]:
            v, f, n = self.scene_data["bases"][b]
            rows.append(np.concatenate(
                [v[f].reshape(-1, 9),
                 (n[f] if n is not None else np.zeros_like(v[f]))
                 .reshape(-1, 9)], 1))
            has.append(np.full(f.shape[0], n is not None))
        table = torch.as_tensor(np.concatenate(rows), dtype=torch.float64,
                                device=idx.device)
        has = torch.as_tensor(np.concatenate(has), device=idx.device)
        ok = (idx >= 0) & (idx < table.shape[0])
        i = idx.clamp(0, table.shape[0] - 1)
        return (torch.where(ok[:, None], table[i], float("nan")),
                has[i] & ok)

    def release(self) -> None:
        self.scene = self.rays = self.kept = self.mgr = self.handles = None

    def triangles(self, key) -> torch.Tensor:
        v, _ = self.world_triangles(self.scene_data, self.transforms[key])
        return torch.as_tensor(v, device=self.ctx.device)
