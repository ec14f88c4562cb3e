"""The mutable TLAS scene manager (counterpart of
``raycore_tpu/scene/tlas.py``).

Handle-based push, delete and update on the host, with ``sync()`` as the
one commit boundary that returns the frozen ``StaticTLAS``. ``sync``
rebuilds the flat BLAS arrays and the TLAS when instances were added or
removed or geometry swapped, and only the TLAS node matrix over the
cached flat arrays when only transforms changed (the refit).

The manager's tensors live on one device: ``TLAS(device=None)`` means the
CUDA card (``core/device.py``), and a mesh pushed from another device
raises instead of being moved.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..accel.lbvh import build_blas
from ..accel.tlas_build import build_tlas_nodes
from ..accel.types import BLAS, Instances, StaticTLAS, next_pow2
from ..core.device import default_device
from ..core.transforms import mat3x4_inverse
from ..core.triangle import Triangle

INVALID_HANDLE = -1


@dataclasses.dataclass(frozen=True)
class TLASHandle:
    """Opaque handle of a pushed geometry and its instances (one push with
    several transforms owns several instances)."""
    id: int


@dataclasses.dataclass
class _InstanceRec:
    handle_id: int
    blas_slot: int
    transform: np.ndarray     # (3, 4) float32 row-major
    instance_id: int          # 0 = inherit from the triangle metadata
    sbt_offset: int = 0       # shader-binding-table offset, carried along


def _assemble_instances(transforms, blas_index, instance_ids, mask):
    """Instances with inverses computed as the JAX package's compiled
    ``sync`` computes them (fused chains)."""
    return Instances(transform=transforms,
                     inv_transform=mat3x4_inverse(transforms, fused=True),
                     blas_index=blas_index, instance_id=instance_ids,
                     mask=mask)


class TLAS:
    """Mutable scene container, orchestrated on the host:

        tlas = TLAS()
        h = tlas.push(mesh_triangles, transform)   # BLAS + instance
        tlas.update_transform(h, new_transform)
        tlas.delete(h)
        scene = tlas.sync()                        # frozen StaticTLAS
    """

    def __init__(self, device=None):
        self.device = default_device(device)
        self._blas: List[Optional[BLAS]] = []
        self._blas_refcount: List[int] = []
        self._instances: List[_InstanceRec] = []
        self._handles: Dict[int, List[int]] = {}   # handle id -> instances
        self._deleted_handles: set[int] = set()
        self._next_handle = 1
        self._dirty = True
        self._transforms_dirty = False
        self._static: Optional[StaticTLAS] = None
        self._flat_cache = None
        self.revision = 0

    # -- queries -----------------------------------------------------------
    @property
    def n_instances(self) -> int:
        return len(self._instances)

    @property
    def n_total_instances(self) -> int:
        return len(self._instances)

    @property
    def n_geometries(self) -> int:
        return sum(1 for b in self._blas if b is not None)

    def is_valid(self, handle: TLASHandle) -> bool:
        return handle.id in self._handles

    @property
    def static_tlas(self) -> StaticTLAS:
        if self._static is None or self._dirty or self._transforms_dirty:
            self.sync()
        return self._static

    def world_bound(self) -> np.ndarray:
        return self.static_tlas.root_aabb.cpu().numpy()

    # -- mutation ----------------------------------------------------------
    def _as_mat3x4(self, transform) -> np.ndarray:
        if isinstance(transform, torch.Tensor):
            transform = transform.cpu().numpy()
        t = (np.asarray(transform, np.float32) if transform is not None
             else np.eye(3, 4, dtype=np.float32))
        if t.shape == (4, 4):
            t = t[:3, :4]
        assert t.shape == (3, 4), f"transform must be 3x4 or 4x4, got {t.shape}"
        return t.astype(np.float32)

    def _check_device(self, tris: Triangle) -> None:
        if tris.device != self.device:
            raise ValueError(
                f"mesh on {tris.device}, TLAS on {self.device}: move the mesh "
                f"to the TLAS's device first")

    def _add_blas(self, tris: Triangle) -> int:
        self._check_device(tris)
        blas = build_blas(tris)
        for slot, b in enumerate(self._blas):
            if b is None:
                self._blas[slot] = blas
                self._blas_refcount[slot] = 0
                return slot
        self._blas.append(blas)
        self._blas_refcount.append(0)
        return len(self._blas) - 1

    def push(self, tris: Triangle, transform=None, *, instance_id: int = 0,
             sbt_offset: int = 0, transforms: Optional[Sequence] = None,
             instance_ids: Optional[Sequence[int]] = None) -> TLASHandle:
        """Add geometry with one transform, or with many transforms that
        share one BLAS build (``transforms``, optionally ``instance_ids``
        one each)."""
        slot = self._add_blas(tris)
        hid = self._next_handle
        self._next_handle += 1
        mats = ([self._as_mat3x4(transform)] if transforms is None
                else [self._as_mat3x4(t) for t in transforms])
        ids = ([int(instance_id)] * len(mats) if instance_ids is None
               else [int(i) for i in instance_ids])
        assert len(ids) == len(mats)
        idxs = []
        for m, iid in zip(mats, ids):
            idxs.append(len(self._instances))
            self._instances.append(
                _InstanceRec(hid, slot, m, iid, int(sbt_offset)))
            self._blas_refcount[slot] += 1
        self._handles[hid] = idxs
        self._dirty = True
        return TLASHandle(hid)

    def _require(self, handle: TLASHandle) -> List[int]:
        if handle.id not in self._handles:
            raise KeyError(f"invalid or deleted handle {handle.id}")
        return self._handles[handle.id]

    def delete(self, handle: TLASHandle) -> None:
        """Remove a handle's instances now; the flat arrays compact at the
        next sync."""
        idxs = set(self._require(handle))
        for i in sorted(idxs):
            slot = self._instances[i].blas_slot
            self._blas_refcount[slot] -= 1
            if self._blas_refcount[slot] == 0:
                self._blas[slot] = None
        remap, j = {}, 0
        for i in range(len(self._instances)):
            if i not in idxs:
                remap[i] = j
                j += 1
        self._instances = [r for i, r in enumerate(self._instances)
                           if i not in idxs]
        del self._handles[handle.id]
        self._handles = {h: [remap[i] for i in ii]
                         for h, ii in self._handles.items()}
        self._deleted_handles.add(handle.id)
        self._dirty = True

    def update_transform(self, handle: TLASHandle, transform) -> None:
        """Set the transform of a handle's instances; the next sync
        refits."""
        for i in self._require(handle):
            self._instances[i].transform = self._as_mat3x4(transform)
        self._transforms_dirty = True

    def update_transforms(self, handle: TLASHandle, transforms) -> None:
        """One transform for each of a multi-transform handle's
        instances."""
        idxs = self._require(handle)
        transforms = list(transforms)
        assert len(transforms) == len(idxs)
        for i, t in zip(idxs, transforms):
            self._instances[i].transform = self._as_mat3x4(t)
        self._transforms_dirty = True

    def update(self, handle: TLASHandle, tris: Triangle) -> None:
        """Swap the geometry behind a handle: its own slot when no other
        handle shares it, else a new slot."""
        idxs = self._require(handle)
        old_slot = self._instances[idxs[0]].blas_slot
        self._check_device(tris)
        new_blas = build_blas(tris)
        if self._blas_refcount[old_slot] == len(idxs):
            self._blas[old_slot] = new_blas
        else:
            self._blas_refcount[old_slot] -= len(idxs)
            slot = self._add_blas(tris)
            self._blas[slot] = new_blas
            for i in idxs:
                self._instances[i].blas_slot = slot
            self._blas_refcount[slot] += len(idxs)
        self._dirty = True

    def instance_buffer(self, handle: TLASHandle) -> np.ndarray:
        """Writable (n, 3, 4) float32 host buffer of a multi-instance
        handle's transforms: each instance record holds a view of one row,
        so writes into it are the new transforms. Commit them with
        ``refit_tlas`` (or ``sync``). A single-instance handle raises
        ValueError."""
        idxs = self._require(handle)
        if len(idxs) < 2:
            raise ValueError(
                f"handle {handle.id} is a single-instance push, not an "
                "instance batch; use update_transform instead")
        buf = np.stack([self._instances[i].transform for i in idxs]) \
            .astype(np.float32)
        for k, i in enumerate(idxs):
            self._instances[i].transform = buf[k]
        self._transforms_dirty = True
        return buf

    def refit_tlas(self) -> StaticTLAS:
        """Commit in-place transform edits and refit the TLAS."""
        self._transforms_dirty = True
        return self.sync()

    def get_instance(self, handle: TLASHandle):
        recs = [self._instances[i] for i in self._require(handle)]
        return recs[0] if len(recs) == 1 else recs

    def get_instances(self, handle: TLASHandle):
        return [self._instances[i] for i in self._require(handle)]

    # -- commit boundary -----------------------------------------------------
    def _live_blas_slots(self) -> List[int]:
        return [s for s, b in enumerate(self._blas) if b is not None]

    def _rebuild_flat(self):
        """The live BLASes' nodes and prims concatenated, with offsets."""
        slots = self._live_blas_slots()
        if not slots:
            raise ValueError("sync() on an empty TLAS")
        slot_to_dense = {s: k for k, s in enumerate(slots)}
        blas = [self._blas[s] for s in slots]
        nodes = torch.cat([b.nodes for b in blas])
        prims = Triangle(**{
            f.name: torch.cat([getattr(b.prims, f.name) for b in blas])
            for f in dataclasses.fields(Triangle)})
        node_counts = np.array([b.n_nodes for b in blas])
        prim_counts = np.array([b.capacity for b in blas])
        node_off = np.concatenate([[0], np.cumsum(node_counts)[:-1]])
        prim_off = np.concatenate([[0], np.cumsum(prim_counts)[:-1]])
        roots = torch.stack([b.root_aabb for b in blas])
        return slot_to_dense, nodes, prims, node_off, prim_off, roots

    def _instance_arrays(self, slot_to_dense, icap):
        tf = np.zeros((icap, 3, 4), np.float32)
        tf[:, :, :3] = np.eye(3)        # padding gets the identity
        bi = np.zeros((icap,), np.int32)
        iid = np.zeros((icap,), np.int64)
        mask = np.zeros((icap,), bool)
        for i, rec in enumerate(self._instances):
            tf[i] = rec.transform
            bi[i] = slot_to_dense[rec.blas_slot]
            iid[i] = rec.instance_id
            mask[i] = True
        dev = self.device
        return (torch.as_tensor(tf, device=dev),
                torch.as_tensor(bi, device=dev),
                torch.as_tensor(iid, device=dev),
                torch.as_tensor(mask, device=dev))

    def sync(self) -> StaticTLAS:
        """Commit every pending mutation and return the frozen scene; a
        clean manager returns its cached StaticTLAS."""
        if self._static is not None and not self._dirty \
                and not self._transforms_dirty:
            return self._static
        if self._dirty or self._flat_cache is None:
            self._flat_cache = self._rebuild_flat()
        slot_to_dense, flat_nodes, flat_prims, node_off, prim_off, roots = \
            self._flat_cache
        n = len(self._instances)
        if n == 0:
            raise ValueError("sync() with zero instances")
        icap = next_pow2(n)
        instances = _assemble_instances(
            *self._instance_arrays(slot_to_dense, icap))
        tlas_nodes, root_aabb = build_tlas_nodes(instances, roots)
        n_tlas_nodes = 2 * icap - 1
        dev = self.device
        self._static = StaticTLAS(
            unified_nodes=torch.cat([tlas_nodes, flat_nodes]),
            instances=instances, prims=flat_prims,
            blas_nodes_offset=torch.as_tensor(node_off + n_tlas_nodes,
                                              dtype=torch.int32, device=dev),
            blas_prims_offset=torch.as_tensor(prim_off, dtype=torch.int32,
                                              device=dev),
            blas_root_aabb=roots, root_aabb=root_aabb, n_instances=n,
            instance_capacity=icap, n_blas=roots.shape[0])
        self._dirty = False
        self._transforms_dirty = False
        self.revision += 1
        return self._static

    def free(self) -> None:
        """Drop every tensor reference."""
        self._blas = []
        self._blas_refcount = []
        self._instances = []
        self._handles = {}
        self._static = None
        self._flat_cache = None
        self._dirty = True

    # -- convenience constructors -------------------------------------------
    @classmethod
    def from_primitives(cls, meshes: Sequence[Triangle], metadata_fn=None,
                        transforms=None, device=None):
        """One BLAS and instance per mesh, with the metadata of triangle
        ti of mesh mi set to ``metadata_fn(mi, ti)`` (a uint32) when given.
        Returns (tlas, handles); ``device`` defaults to the first mesh's."""
        t = cls(device=meshes[0].device if device is None and meshes
                else device)
        transforms = transforms or [None] * len(meshes)
        handles = []
        for mi, (m, tr) in enumerate(zip(meshes, transforms)):
            if metadata_fn is not None:
                n = m.vertices.shape[0]
                meta = np.asarray([metadata_fn(mi, ti) for ti in range(n)],
                                  np.uint32).astype(np.int64)
                m = dataclasses.replace(
                    m, metadata=torch.as_tensor(meta, device=m.device))
            handles.append(t.push(m, tr))
        return t, handles

    @classmethod
    def from_meshes(cls, meshes: Sequence[Triangle], transforms=None,
                    device=None):
        """One BLAS and instance per mesh; returns (tlas, handles)."""
        t = cls(device=meshes[0].device if device is None and meshes
                else device)
        transforms = transforms or [None] * len(meshes)
        handles = [t.push(m, tr) for m, tr in zip(meshes, transforms)]
        return t, handles


def blas_to_static_tlas(blas: BLAS) -> StaticTLAS:
    """A one-instance StaticTLAS (identity transform) over one BLAS."""
    t = TLAS(device=blas.nodes.device)
    t._blas = [blas]
    t._blas_refcount = [1]
    t._instances = [_InstanceRec(0, 0, np.eye(3, 4, dtype=np.float32), 0)]
    t._handles = {0: [0]}
    return t.sync()


def instance_buffer(tlas: TLAS, handle: TLASHandle) -> np.ndarray:
    """``TLAS.instance_buffer`` as a function."""
    return tlas.instance_buffer(handle)


def refit_tlas(tlas: TLAS) -> StaticTLAS:
    """``TLAS.refit_tlas`` as a function."""
    return tlas.refit_tlas()
