"""The AbstractAccel contract (counterpart of
``raycore_tpu/accel/protocol.py``).

Any acceleration structure exposes the same mutation, lifecycle and query
protocol: push, delete and update_transform, ``sync`` as the one owner of
the frozen form, closest_hit and any_hit, world_bound, n_instances and
n_geometries, wait_for_gpu. Two implementations: ``TLASAccel``, the
mutable TLAS with the BVH traversal, and ``BruteAccel``, exhaustive
intersection over the world-space triangles, the semantic oracle of the
contract tests. Both keep their tensors on one device, the CUDA card
unless the caller passes another.
"""
from __future__ import annotations

import abc
from typing import Any

import numpy as np
import torch

from ..core.device import default_device
from ..core.ray import Ray
from ..core.triangle import Triangle
from .brute import HitResult


class AbstractAccel(abc.ABC):
    """Scene-level acceleration structure protocol."""

    # -- mutation -----------------------------------------------------
    @abc.abstractmethod
    def push(self, tris, transform=None, *, instance_id: int = 0,
             transforms=None): ...

    @abc.abstractmethod
    def delete(self, handle) -> None: ...

    @abc.abstractmethod
    def update_transform(self, handle, transform) -> None: ...

    @abc.abstractmethod
    def sync(self) -> Any:
        """Commit mutations; returns (and owns) the frozen form."""

    # -- queries ------------------------------------------------------
    @abc.abstractmethod
    def closest_hit(self, rays: Ray) -> HitResult: ...

    @abc.abstractmethod
    def any_hit(self, rays: Ray) -> HitResult: ...

    @abc.abstractmethod
    def world_bound(self) -> np.ndarray: ...

    @property
    @abc.abstractmethod
    def n_instances(self) -> int: ...

    @property
    @abc.abstractmethod
    def n_geometries(self) -> int: ...

    def wait_for_gpu(self):
        """Block until device work finishes; chainable."""
        return self


class TLASAccel(AbstractAccel):
    """The production implementation: the mutable TLAS manager
    (``scene/tlas.py``) and the BVH traversal."""

    def __init__(self, device=None):
        from ..scene.tlas import TLAS
        self._tlas = TLAS(device=device)

    def push(self, tris, transform=None, *, instance_id=0, transforms=None):
        return self._tlas.push(tris, transform, instance_id=instance_id,
                               transforms=transforms)

    def delete(self, handle):
        self._tlas.delete(handle)

    def update_transform(self, handle, transform):
        self._tlas.update_transform(handle, transform)

    def sync(self):
        return self._tlas.sync()

    def closest_hit(self, rays: Ray) -> HitResult:
        from . import traversal
        return traversal.closest_hit(self._tlas.sync(), rays)

    def any_hit(self, rays: Ray) -> HitResult:
        from . import traversal
        return traversal.any_hit(self._tlas.sync(), rays)

    def world_bound(self):
        return self._tlas.world_bound()

    @property
    def n_instances(self):
        return self._tlas.n_instances

    @property
    def n_geometries(self):
        return self._tlas.n_geometries

    def wait_for_gpu(self):
        """Synchronize the device that holds the synced scene's nodes."""
        static = self._tlas._static
        if static is not None and static.unified_nodes.is_cuda:
            torch.cuda.synchronize(static.unified_nodes.device)
        return self


class BruteAccel(AbstractAccel):
    """The second implementation: exhaustive intersection over the
    world-space triangles, with no BVH. ``sync`` transforms the vertices
    on the host in NumPy float32 (``v @ m[:, :3].T + m[:, 3]``, as the
    JAX package does) and moves them to the device."""

    def __init__(self, device=None):
        self.device = default_device(device)
        self._groups = {}     # handle id -> [tris, [transforms], instance_id]
        self._next = 1
        self._world = None

    def push(self, tris, transform=None, *, instance_id=0, transforms=None):
        from ..scene.tlas import TLASHandle
        mats = transforms if transforms is not None else [transform]
        mats = [np.eye(3, 4, dtype=np.float32) if m is None
                else np.asarray(m, np.float32)[:3, :4] for m in mats]
        hid = self._next
        self._next += 1
        self._groups[hid] = [tris, mats, instance_id]
        self._world = None
        return TLASHandle(hid)

    def delete(self, handle):
        del self._groups[handle.id]
        self._world = None

    def update_transform(self, handle, transform):
        m = np.asarray(transform, np.float32)[:3, :4]
        self._groups[handle.id][1] = [m] * len(self._groups[handle.id][1])
        self._world = None

    def sync(self):
        """(world Triangle, (T,) int32 instance of each triangle)."""
        if self._world is not None:
            return self._world
        parts, inst_of = [], []
        inst = 0
        for tris, mats, _ in self._groups.values():
            host = lambda a: a.cpu().numpy()
            for m in mats:
                v = host(tris.vertices) @ m[:, :3].T + m[:, 3]
                parts.append((v, host(tris.normals), host(tris.uv),
                              host(tris.metadata)))
                inst_of.append(np.full(len(v), inst, np.int32))
                inst += 1
        dev = self.device
        cat = lambda k: torch.as_tensor(
            np.concatenate([p[k] for p in parts]), device=dev)
        v = cat(0)
        self._world = (Triangle(vertices=v, normals=cat(1),
                                tangents=torch.zeros_like(v), uv=cat(2),
                                metadata=cat(3)),
                       torch.as_tensor(np.concatenate(inst_of), device=dev))
        return self._world

    def _instances(self, res: HitResult, inst_of) -> HitResult:
        res.instance_idx = torch.where(
            res.hit, inst_of[res.prim_idx.clamp_min(0).long()], -1)
        return res

    def closest_hit(self, rays: Ray) -> HitResult:
        from .brute import closest_hit_brute
        tris, inst_of = self.sync()
        return self._instances(closest_hit_brute(tris, rays), inst_of)

    def any_hit(self, rays: Ray) -> HitResult:
        from .brute import any_hit_brute
        tris, inst_of = self.sync()
        return self._instances(any_hit_brute(tris, rays), inst_of)

    def world_bound(self):
        v = self.sync()[0].vertices.cpu().numpy()
        return np.stack([v.min((0, 1)), v.max((0, 1))])

    @property
    def n_instances(self):
        return sum(len(m) for _, m, _ in self._groups.values())

    @property
    def n_geometries(self):
        return len(self._groups)

    def wait_for_gpu(self):
        """Synchronize the accel's device when it is a card."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
