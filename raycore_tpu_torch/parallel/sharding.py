"""Data-parallel ray sharding over ``torch.distributed`` (counterpart of
``raycore_tpu/parallel/sharding.py``).

The frozen scene is replicated on every rank, the ray batch is split
along its rows, and each rank queries its slice. The JAX package's API is
single-controller, so here every rank calls the distributed functions
with the same full batch, and every rank gets the full result back:
results by an all-gather, the illumination histogram by an all-reduce.

The caller starts the process group (``init_process_group`` with its
address, world size and rank) and passes a ``RayMesh`` from
``make_mesh``. Each distributed query replicates the scene first, as the
JAX package's does; ``replicate=False`` skips that broadcast for a scene
that ``replicate_scene`` already returned. Over gloo the collectives run on host copies, since gloo
gathers only CPU tensors; over NCCL they run on the card.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..accel import dispatch as _disp
from ..core.device import default_device
from ..core.ray import Ray


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A process group over which rays are sharded: this process's rank
    in it, the group's size and the device this rank queries on."""

    group: object           # a ProcessGroup, or None for the default group
    rank: int
    size: int
    device: torch.device

    @property
    def staged(self) -> bool:
        """Whether collectives go through host copies (gloo)."""
        return dist.get_backend(self.group) == "gloo"


def make_mesh(group=None, device=None) -> RayMesh:
    """The mesh of an initialized process group (the default group when
    None); ``device`` defaults to the CUDA card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized;"
                           " call init_process_group first")
    return RayMesh(group=group, rank=dist.get_rank(group),
                   size=dist.get_world_size(group),
                   device=default_device(device))


def _src(mesh: RayMesh) -> int:
    """Global rank of the group's rank 0."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def _broadcast(t, mesh: RayMesh):
    """Rank 0's values of ``t`` on every rank (same shape and dtype on
    each), on ``t``'s device."""
    buf = t.detach().cpu().clone() if mesh.staged else t.detach().clone()
    dist.broadcast(buf, src=_src(mesh), group=mesh.group)
    return buf.to(t.device)


def _map_tensors(obj, fn):
    """A copy of a dataclass tree with ``fn`` applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: _map_tensors(getattr(obj, f.name), fn)
                   for f in dataclasses.fields(obj) if f.init}
        return dataclasses.replace(obj, **changes)
    return obj


def replicate_scene(scene, mesh: RayMesh):
    """The scene with every tensor set to rank 0's, on this rank's
    device. Each rank passes a scene of the same structure (the same
    build); a tensor of another shape on some rank fails the
    broadcast."""
    return _map_tensors(scene, lambda t: _broadcast(t.to(mesh.device),
                                                    mesh))


def _flat(rays: Ray) -> Ray:
    nb = len(rays.batch_shape)
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[nb:]))
    return Ray(o=flat(rays.o), d=flat(rays.d), t_min=flat(rays.t_min),
               t_max=flat(rays.t_max), time=flat(rays.time))


def pad_rays_to(rays: Ray, multiple: int) -> Ray:
    """A flat batch padded to a multiple of ``multiple`` rows with rays
    that never hit (o = 0, d = 1, t_min = 0, t_max = -1, time 0)."""
    n = rays.o.shape[0]
    pad = -n % multiple
    if pad == 0:
        return rays

    def ext(a, fill):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    return Ray(o=ext(rays.o, 0.0), d=ext(rays.d, 1.0),
               t_min=ext(rays.t_min, 0.0), t_max=ext(rays.t_max, -1.0),
               time=ext(rays.time, 0.0))


def shard_rays(rays: Ray, mesh: RayMesh) -> Ray:
    """This rank's contiguous slice of a flat batch, on its device. The
    row count must be a multiple of the mesh size (``pad_rays_to``)."""
    n = rays.o.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_rays: {n} rays do not divide over "
                         f"{mesh.size} ranks; pad with pad_rays_to")
    per = n // mesh.size
    s = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return Ray(**{f.name: getattr(rays, f.name)[s].to(mesh.device)
                  for f in dataclasses.fields(rays)})


def _all_gather(t, mesh: RayMesh):
    """Every rank's ``t`` concatenated along rows, in rank order."""
    x = t.detach()
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    if mesh.staged:
        x = x.cpu()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.cat(parts).to(t.device)
    return out.to(torch.bool) if is_bool else out


def gather_hits(res, mesh: RayMesh):
    """The full HitResult from every rank's slice, on every rank."""
    return res.map(lambda a: _all_gather(a, mesh))


def distributed_closest_hit(scene, rays: Ray, mesh: RayMesh,
                            tile_size: int = 16384, *,
                            replicate: bool = True):
    """``closest_hit`` (``accel/dispatch.py``) with the scene replicated
    and the rays sharded; returns the full result, padded to a multiple of
    the mesh size as the rays were."""
    if replicate:
        scene = replicate_scene(scene, mesh)
    rays = shard_rays(pad_rays_to(_flat(rays), mesh.size), mesh)
    res = _disp.scene_closest_hit(scene, rays, tile_size=tile_size)
    return gather_hits(res, mesh)


def distributed_closest_hit_dense(scene, rays: Ray, mesh: RayMesh, *,
                                  tile: int = 2048, subgroup: int = 32,
                                  spb: int = 16, pairs_per_tile: int = 48,
                                  replicate: bool = True):
    """Exact closest hit on a replicated DenseScene with the rays sharded:
    each rank runs the regrouped engine (``closest_hit_regrouped`` at
    passes=1: K1 and K2 on the card) on its slice, padded to whole tiles
    as the JAX package pads it, and the results are gathered and cut to
    the caller's rows.

    The JAX package runs its sort driver per shard and sizes static
    capacity buckets from a cross-shard maximum; the port sizes every
    query from its data, so ``pairs_per_tile`` is taken and unused."""
    from ..ops.regroup import closest_hit_regrouped
    if getattr(scene, "sub_chunks", 1) != 1:
        raise ValueError("sharded regroup requires sub_chunks=1 scenes")
    rays = _flat(rays)
    R0 = rays.o.shape[0]
    per = max(R0 // mesh.size, 1)
    G = min(subgroup, max(8, 1 << (per - 1).bit_length()))
    TILE = -(-min(tile, max(per, G)) // G) * G
    if replicate:
        scene = replicate_scene(scene, mesh)
    local = shard_rays(pad_rays_to(rays, mesh.size * TILE), mesh)
    res = closest_hit_regrouped(scene, local, tile=tile, subgroup=subgroup,
                                spb=spb, passes=1)
    return gather_hits(res, mesh).map(lambda a: a[:R0])


def distributed_illumination(scene, rays: Ray, mesh: RayMesh, n_bins: int,
                             tile_size: int = 16384, *,
                             replicate: bool = True):
    """The sharded analysis step: each rank traces its slice, counts hits
    per metadata bin (clamped to [0, n_bins)), and the histograms are
    summed over the ranks. Returns (the full t, padded as the rays were,
    and the (n_bins,) float32 histogram), both on every rank."""
    if replicate:
        scene = replicate_scene(scene, mesh)
    rays = shard_rays(pad_rays_to(_flat(rays), mesh.size), mesh)
    res = _disp.scene_closest_hit(scene, rays, tile_size=tile_size)
    idx = res.triangle.metadata.to(torch.int32).clamp(0, n_bins - 1).long()
    hist = torch.zeros(n_bins, dtype=torch.float32, device=res.t.device)
    hist.index_add_(0, idx, res.hit.to(torch.float32))
    buf = hist.cpu() if mesh.staged else hist
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return _all_gather(res.t, mesh), buf.to(hist.device)
