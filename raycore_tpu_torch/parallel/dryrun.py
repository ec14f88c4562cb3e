"""Run the sharded queries in gloo ranks on one host (the torch twin of the
JAX package's ``__graft_entry__.py:dryrun_multichip``).

    python -m raycore_tpu_torch.parallel.dryrun --ranks 4 --device cpu
    python -m raycore_tpu_torch.parallel.dryrun --ranks 2 --device cuda \\
        --workdir DIR --cases DIR/cases.json

``dryrun_multichip(n)`` spawns n ranks that run the JAX dry run's three
steps on tiny shapes: ``distributed_illumination`` and
``distributed_closest_hit`` on a two-instance TLAS, then
``distributed_closest_hit_dense`` on a small heightfield, which must hit
with every ray. ``run_cases`` spawns ranks that run a list of cases,
each a sharded query on a scene and rays that the caller names, and
returns what every rank saved: the full results, each rank's kernel
launches and its times. Every rank joins a gloo group through a file in
the work directory, so no port is taken.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import sharding as sh

CASE_FNS = ("closest_hit", "closest_hit_dense", "illumination", "rounds")


def small_scene(device):
    """The JAX dry run's scene: a sphere and a box moved 3 along x."""
    from ..scene.mesh import box_mesh, sphere_mesh
    from ..scene.tlas import TLAS
    mgr = TLAS(device=device)
    mgr.push(sphere_mesh(radius=1.0, n_theta=12, n_phi=24, device=device),
             None)
    tr = np.eye(3, 4, dtype=np.float32)
    tr[0, 3] = 3.0
    mgr.push(box_mesh(device=device), tr)
    return mgr.sync()


def _scene(spec: dict, device):
    """A scene from its spec: {"small_tlas": true}, or {"dense": mesh
    name, "kw": mesh arguments, "cluster_size": C} built with
    build_dense."""
    if spec.get("small_tlas"):
        return small_scene(device)
    from ..accel.dense import build_dense
    from ..scene import mesh
    tris = getattr(mesh, spec["dense"])(**spec.get("kw", {}), device=device)
    return build_dense(tris, cluster_size=spec["cluster_size"])


def _rays(path: str, device):
    """Rays from an .npz with ``o`` and ``d`` (and optional ``t_min``,
    ``t_max``)."""
    from ..core.ray import Ray
    z = np.load(path)
    get = lambda k, fill: torch.as_tensor(
        z[k] if k in z else np.full(len(z["o"]), fill, np.float32),
        device=device)
    return Ray.create(get("o", 0.0), get("d", 0.0),
                      t_min=get("t_min", 0.0),
                      t_max=get("t_max", float("inf")))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counters():
    from ..ops import dense as ops_dense
    from ..ops import regroup as ops_regroup
    return {"phase_a": ops_dense.phase_a,
            "regroup_sweep": ops_regroup.run_regrouped}


def _run_case(case: dict, mesh: sh.RayMesh) -> dict:
    """One case on this rank: the sharded call ``reps`` times (default
    1), each after a barrier and timed to the device's end. The first
    call replicates the scene itself, as a caller's first query does; the
    scene is then replicated once more on its own (timed) and the other
    calls take it with ``replicate=False``. Returns the last call's full
    result as NumPy arrays, the launches of K1 and K2 over the first
    call, and the milliseconds of every call and of the replication."""
    from ..accel.dense import closest_hit_dense
    dev = mesh.device
    scene = _scene(case["scene"], dev)
    rays = _rays(case["rays"], dev)
    kw = dict(case.get("kwargs", {}))
    fn = case["fn"]
    if fn not in CASE_FNS:
        raise ValueError(f"unknown case fn {fn!r}; one of {CASE_FNS}")

    def call(scene, replicate):
        if fn == "closest_hit":
            return sh.distributed_closest_hit(
                scene, rays, mesh, replicate=replicate, **kw), None
        if fn == "closest_hit_dense":
            return sh.distributed_closest_hit_dense(
                scene, rays, mesh, replicate=replicate, **kw), None
        if fn == "illumination":
            return sh.distributed_illumination(
                scene, rays, mesh, replicate=replicate, **kw)
        if replicate:
            scene = sh.replicate_scene(scene, mesh)
        local = sh.shard_rays(sh.pad_rays_to(rays, mesh.size), mesh)
        return sh.gather_hits(closest_hit_dense(scene, local, **kw),
                              mesh), None

    def timed(fn, *a):
        dist.barrier(group=mesh.group)
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*a)
        _sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    (res, extra), first_ms = timed(call, scene, True)
    launches = {k: c.launches for k, c in counters.items()}
    scene, replicate_ms = timed(sh.replicate_scene, scene, mesh)
    ms = [first_ms]
    for _ in range(case.get("reps", 1) - 1):
        (res, extra), t = timed(call, scene, False)
        ms.append(t)
    host = lambda a: a.detach().cpu().numpy()
    if fn == "illumination":
        out = {"t": host(res), "hist": host(extra)}
    else:
        out = {k: host(getattr(res, k)) for k in
               ("hit", "t", "prim_idx", "instance_idx", "barycentric")}
        out["metadata"] = host(res.triangle.metadata)
    out.update(launches=launches, ms=ms, replicate_ms=replicate_ms,
               rank=mesh.rank, size=mesh.size, device=str(dev))
    return out


def _rank_main(rank: int, world: int, workdir: str, device: str,
               cases: list) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=world)
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        mesh = sh.make_mesh(device=device)
        outs = {c["name"]: _run_case(c, mesh) for c in cases}
        torch.save(outs, f"{workdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_cases(cases: list, n_ranks: int, device: str = "cpu",
              workdir: str | None = None) -> list:
    """Spawn ``n_ranks`` gloo ranks that each run ``cases`` (dicts with
    ``name``, ``fn`` in CASE_FNS, ``scene`` and ``rays`` specs, optional
    ``kwargs`` and ``reps``) and return each rank's outputs, in rank
    order: {case name: {result arrays, launches, ms, ...}}."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mp.spawn(_rank_main, args=(n_ranks, tmp, device, cases),
                 nprocs=n_ranks, join=True)
        return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                for r in range(n_ranks)]


def dryrun_multichip(n_devices: int, device: str = "cpu",
                     workdir: str | None = None) -> None:
    """The JAX dry run's three steps in ``n_devices`` gloo ranks on tiny
    shapes; raises if a step fails on any rank."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        n_rays = 64 * n_devices
        rng = np.random.default_rng(0)
        o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
        o[:, 2] = -4.0
        d = np.broadcast_to(np.float32([0, 0, 1]), o.shape)
        np.savez(f"{tmp}/rays.npz", o=o, d=np.ascontiguousarray(d))
        xs = np.linspace(-0.9, 0.9, 16, dtype=np.float32)
        X, Y = np.meshgrid(xs, xs, indexing="ij")
        o2 = np.stack([X, Y, np.full_like(X, 2.0)], -1).reshape(-1, 3)
        d2 = np.broadcast_to(np.float32([0, 0, -1]), o2.shape)
        np.savez(f"{tmp}/rays2.npz", o=o2, d=np.ascontiguousarray(d2))
        tlas = {"small_tlas": True}
        n_bins = int(small_scene("cpu").prims.metadata.shape[0])
        cases = [
            dict(name="illumination", fn="illumination", scene=tlas,
                 rays=f"{tmp}/rays.npz",
                 kwargs=dict(n_bins=n_bins, tile_size=64)),
            dict(name="closest_hit", fn="closest_hit", scene=tlas,
                 rays=f"{tmp}/rays.npz", kwargs=dict(tile_size=64)),
            dict(name="dense", fn="closest_hit_dense",
                 scene={"dense": "displaced_grid_mesh",
                        "kw": dict(n=16, extent=2.0, amplitude=0.3),
                        "cluster_size": 32},
                 rays=f"{tmp}/rays2.npz",
                 kwargs=dict(tile=32, subgroup=8, spb=16))]
        outs = run_cases(cases, n_devices, device, tmp)
    for out in outs:
        hist = out["illumination"]["hist"]
        assert hist.shape == (n_bins,) and float(hist.sum()) >= 0.0
        assert out["closest_hit"]["t"].shape[0] % n_devices == 0
        assert out["dense"]["hit"].all(), "dense sharded dryrun must hit"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cases", default=None,
                    help="a JSON list of cases (see run_cases); the "
                         "outputs go to WORKDIR/outputs.pt")
    a = ap.parse_args(argv)
    if a.cases is None:
        dryrun_multichip(a.ranks, a.device, a.workdir)
        print(f"dryrun_multichip({a.ranks}) on {a.device} ok")
        return
    outs = run_cases(json.loads(Path(a.cases).read_text()), a.ranks,
                     a.device, a.workdir)
    dest = Path(a.workdir or ".") / "outputs.pt"
    torch.save(outs, dest)
    print(f"{len(outs)} ranks ran {a.cases}; outputs in {os.fspath(dest)}")


if __name__ == "__main__":
    main()
