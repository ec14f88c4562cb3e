"""Scene serialization (counterpart of ``raycore_tpu/scene/io.py``): a
frozen ``StaticTLAS`` or ``DenseScene`` to an ``.npz`` file and back.

The file has the JAX package's field names, dtypes and ``statics``, so a
file written by either package loads in the other: float tables as
float32, node rows, offsets and hot rows as int32, triangle metadata and
instance ids as uint32 (int64 tensors here hold their values), the
instance mask as bool.
"""
from __future__ import annotations

import numpy as np
import torch

from ..accel.dense import DenseScene, pack_prims_hot
from ..accel.types import Instances, StaticTLAS
from ..core.device import default_device
from ..core.triangle import Triangle


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def _u32(a) -> np.ndarray:
    """uint32 values held in an int64 tensor, as the file holds them."""
    return (_host(a).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


def _tri_arrays(prefix, t: Triangle) -> dict:
    return {f"{prefix}vertices": _host(t.vertices),
            f"{prefix}normals": _host(t.normals),
            f"{prefix}tangents": _host(t.tangents),
            f"{prefix}uv": _host(t.uv),
            f"{prefix}metadata": _u32(t.metadata)}


def save_scene(path: str, scene) -> None:
    """Write a StaticTLAS or a DenseScene to an .npz file."""
    if isinstance(scene, StaticTLAS):
        inst = scene.instances
        arrs = dict(
            kind=np.asarray("StaticTLAS"),
            unified_nodes=_host(scene.unified_nodes),
            inst_transform=_host(inst.transform),
            inst_inv_transform=_host(inst.inv_transform),
            inst_blas_index=_host(inst.blas_index),
            inst_instance_id=_u32(inst.instance_id),
            inst_mask=_host(inst.mask),
            blas_nodes_offset=_host(scene.blas_nodes_offset),
            blas_prims_offset=_host(scene.blas_prims_offset),
            blas_root_aabb=_host(scene.blas_root_aabb),
            root_aabb=_host(scene.root_aabb),
            statics=np.asarray([scene.n_instances, scene.instance_capacity,
                                scene.n_blas]),
            **_tri_arrays("prims_", scene.prims))
    elif isinstance(scene, DenseScene):
        arrs = dict(
            kind=np.asarray("DenseScene"),
            tri_feats=_host(scene.tri_feats),
            cluster_min=_host(scene.cluster_min),
            cluster_max=_host(scene.cluster_max),
            sub_bounds=_host(scene.sub_bounds),
            prims_hot=_host(scene.prims_hot),
            root_aabb=_host(scene.root_aabb),
            statics=np.asarray([scene.n_prims, scene.cluster_size,
                                scene.sub_chunks, scene.payload_mask]),
            **_tri_arrays("prims_", scene.prims))
        if scene.instance_of_prim is not None:
            arrs["instance_of_prim"] = _host(scene.instance_of_prim)
    else:
        raise TypeError(f"cannot serialize {type(scene)}")
    np.savez_compressed(path, **arrs)


def load_scene(path: str, device=None):
    """Load a scene written by ``save_scene`` of either package onto
    ``device`` (the CUDA card by default). Older DenseScene files load
    too: float32 hot rows (their bits are the int32 rows), 10-column hot
    rows (the original index is the row index) and files with no hot rows
    (packed from the prims)."""
    dev = default_device(device)
    z = np.load(path, allow_pickle=False)
    f32 = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=dev)
    i32 = lambda k: torch.as_tensor(np.asarray(z[k]).astype(np.int32),
                                    device=dev)
    i64 = lambda k: torch.as_tensor(np.asarray(z[k]).astype(np.int64),
                                    device=dev)
    prims = Triangle(vertices=f32("prims_vertices"),
                     normals=f32("prims_normals"),
                     tangents=f32("prims_tangents"), uv=f32("prims_uv"),
                     metadata=i64("prims_metadata"))
    kind = str(z["kind"])
    s = [int(x) for x in z["statics"]]
    if kind == "StaticTLAS":
        return StaticTLAS(
            unified_nodes=i32("unified_nodes"),
            instances=Instances(
                transform=f32("inst_transform"),
                inv_transform=f32("inst_inv_transform"),
                blas_index=i32("inst_blas_index"),
                instance_id=i64("inst_instance_id"),
                mask=torch.as_tensor(np.asarray(z["inst_mask"], bool),
                                     device=dev)),
            prims=prims,
            blas_nodes_offset=i32("blas_nodes_offset"),
            blas_prims_offset=i32("blas_prims_offset"),
            blas_root_aabb=f32("blas_root_aabb"), root_aabb=f32("root_aabb"),
            n_instances=s[0], instance_capacity=s[1], n_blas=s[2])
    if kind == "DenseScene":
        if "prims_hot" in z:
            hot = np.asarray(z["prims_hot"])
            if hot.dtype.kind == "f":
                hot = hot.astype(np.float32).view(np.int32)
            if hot.shape[1] == 10:
                idx = np.arange(hot.shape[0], dtype=np.int32)
                hot = np.concatenate([hot, idx[:, None]], axis=1)
            hot = torch.as_tensor(hot.astype(np.int32), device=dev)
        else:
            hot = pack_prims_hot(prims)
        return DenseScene(
            tri_feats=f32("tri_feats"), cluster_min=f32("cluster_min"),
            cluster_max=f32("cluster_max"), sub_bounds=f32("sub_bounds"),
            prims=prims, prims_hot=hot, root_aabb=f32("root_aabb"),
            n_prims=s[0], cluster_size=s[1],
            sub_chunks=s[2] if len(s) > 2 else 4,
            payload_mask=s[3] if len(s) > 3 else 0b111,
            instance_of_prim=(i32("instance_of_prim")
                              if "instance_of_prim" in z else None))
    raise ValueError(f"unknown scene kind {kind!r}")
