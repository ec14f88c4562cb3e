"""Carry rays, triangles, boxes, transforms, built scenes and the
renderers' state (materials, lights, camera, texture pool, a static
MultiTypeSet) across as NumPy arrays.

The dict form of a scene is what ``np.asarray`` gives for each field of a
``DenseScene``, ``BLAS``, ``BLAS4``, ``StaticTLAS`` or
``DenseInstancedScene`` from either package (the fields of its ``prims``
and ``instances`` flattened into the same dict), so a scene built by one
package can be queried by the other. Every function puts its tensors on
``device``, the CUDA card by default.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.dense import DenseScene
from .accel.types import BLAS, Instances, StaticTLAS
from .accel.wide import BLAS4
from .collections.multitypeset import StaticMultiTypeSet, TexturePool
from .core.bounds import Bounds2, Bounds3
from .core.device import default_device
from .core.ray import Ray
from .core.transforms import Transformation
from .core.triangle import Triangle
from .render.wavefront import Camera, Materials, PointLights
from .scene.instanced import DenseInstancedScene

_SCENE_ARRAYS = ("tri_feats", "cluster_min", "cluster_max", "sub_bounds",
                 "prims_hot", "root_aabb")
_PRIM_FIELDS = ("vertices", "normals", "tangents", "uv", "metadata")
_INSTANCE_FIELDS = ("transform", "inv_transform", "blas_index",
                    "instance_id", "mask")
_INSTANCED_ARRAYS = ("tri_feats", "cluster_min", "cluster_max", "prims_hot",
                     "inst_inv", "inst_blas", "inst_cbase", "inst_ncl",
                     "inst_aabb_min", "inst_aabb_max", "inst_local_min",
                     "inst_local_max", "root_aabb")


def _tensor(a, device, dtype=None):
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def triangle_from_numpy(vertices, normals, tangents, uv, metadata,
                        device=None) -> Triangle:
    device = default_device(device)
    f32 = lambda a: _tensor(np.asarray(a, np.float32), device)
    return Triangle(vertices=f32(vertices), normals=f32(normals),
                    tangents=f32(tangents), uv=f32(uv),
                    metadata=_tensor(np.asarray(metadata).astype(np.int64),
                                     device))


def ray_from_numpy(o, d, t_min, t_max, time=None, device=None) -> Ray:
    device = default_device(device)
    o = np.asarray(o, np.float32)
    return Ray.create(_tensor(o, device), _tensor(np.asarray(d, np.float32),
                                                  device),
                      t_min=_tensor(np.asarray(t_min, np.float32), device),
                      t_max=_tensor(np.asarray(t_max, np.float32), device),
                      time=(0.0 if time is None else
                            _tensor(np.asarray(time, np.float32), device)),
                      device=device)


def bounds_from_numpy(p_min, p_max, device=None):
    """``Bounds3`` from (..., 3) corners, ``Bounds2`` from (..., 2)."""
    device = default_device(device)
    p_min = _tensor(np.asarray(p_min, np.float32), device)
    p_max = _tensor(np.asarray(p_max, np.float32), device)
    cls = Bounds2 if p_min.shape[-1] == 2 else Bounds3
    return cls(p_min=p_min, p_max=p_max)


def transformation_from_numpy(m, m_inv, device=None) -> Transformation:
    """``Transformation`` from a (..., 4, 4) matrix and its inverse, as the
    JAX package's ``Transformation`` holds them."""
    device = default_device(device)
    return Transformation(m=_tensor(np.asarray(m, np.float32), device),
                          m_inv=_tensor(np.asarray(m_inv, np.float32),
                                        device))


def dense_scene_from_numpy(d: dict, device=None) -> DenseScene:
    """DenseScene from a dict of NumPy arrays: ``tri_feats``,
    ``cluster_min``, ``cluster_max``, ``sub_bounds``, ``prims_hot``,
    ``root_aabb``, the five ``prims`` fields (``vertices``, ``normals``,
    ``tangents``, ``uv``, ``metadata``) and the ints ``n_prims``,
    ``cluster_size``, ``sub_chunks`` and ``payload_mask``."""
    device = default_device(device)
    arrays = {k: _tensor(np.asarray(d[k]), device) for k in _SCENE_ARRAYS}
    arrays["prims_hot"] = arrays["prims_hot"].to(torch.int32)
    prims = triangle_from_numpy(*(d[k] for k in _PRIM_FIELDS), device=device)
    return DenseScene(prims=prims, n_prims=int(d["n_prims"]),
                      cluster_size=int(d["cluster_size"]),
                      sub_chunks=int(d["sub_chunks"]),
                      payload_mask=int(d["payload_mask"]), **arrays)


def _prims(d: dict, device) -> Triangle:
    return triangle_from_numpy(*(d[k] for k in _PRIM_FIELDS), device=device)


def blas_from_numpy(d: dict, device=None) -> BLAS:
    """BLAS from a dict of NumPy arrays: ``nodes`` (int32), ``root_aabb``,
    the five prim fields and the ints ``n_prims`` and ``capacity``."""
    device = default_device(device)
    return BLAS(nodes=_tensor(np.asarray(d["nodes"], np.int32), device),
                prims=_prims(d, device),
                root_aabb=_tensor(np.asarray(d["root_aabb"], np.float32),
                                  device),
                n_prims=int(d["n_prims"]), capacity=int(d["capacity"]))


def blas4_from_numpy(d: dict, device=None) -> BLAS4:
    """BLAS4 from a dict of NumPy arrays: ``nodes4`` (int32),
    ``root_aabb``, the five prim fields and the ints ``n_prims`` and
    ``capacity``."""
    device = default_device(device)
    return BLAS4(nodes4=_tensor(np.asarray(d["nodes4"], np.int32), device),
                 prims=_prims(d, device),
                 root_aabb=_tensor(np.asarray(d["root_aabb"], np.float32),
                                   device),
                 n_prims=int(d["n_prims"]), capacity=int(d["capacity"]))


def static_tlas_from_numpy(d: dict, device=None) -> StaticTLAS:
    """StaticTLAS from a dict of NumPy arrays: ``unified_nodes``,
    ``blas_nodes_offset``, ``blas_prims_offset`` (int32),
    ``blas_root_aabb``, ``root_aabb``, the five prim fields, the five
    instance fields (``transform``, ``inv_transform``, ``blas_index``,
    ``instance_id``, ``mask``) and the ints ``n_instances``,
    ``instance_capacity`` and ``n_blas``."""
    device = default_device(device)
    i32 = lambda k: _tensor(np.asarray(d[k], np.int32), device)
    f32 = lambda k: _tensor(np.asarray(d[k], np.float32), device)
    inst = Instances(transform=f32("transform"),
                     inv_transform=f32("inv_transform"),
                     blas_index=i32("blas_index"),
                     instance_id=_tensor(np.asarray(d["instance_id"])
                                         .astype(np.int64), device),
                     mask=_tensor(np.asarray(d["mask"], bool), device))
    return StaticTLAS(unified_nodes=i32("unified_nodes"), instances=inst,
                      prims=_prims(d, device),
                      blas_nodes_offset=i32("blas_nodes_offset"),
                      blas_prims_offset=i32("blas_prims_offset"),
                      blas_root_aabb=f32("blas_root_aabb"),
                      root_aabb=f32("root_aabb"),
                      n_instances=int(d["n_instances"]),
                      instance_capacity=int(d["instance_capacity"]),
                      n_blas=int(d["n_blas"]))


def instanced_scene_from_numpy(d: dict, device=None) -> DenseInstancedScene:
    """DenseInstancedScene from a dict of NumPy arrays: ``tri_feats``,
    ``cluster_min``, ``cluster_max``, ``prims_hot``, ``inst_inv``,
    ``inst_blas``, ``inst_cbase``, ``inst_ncl``, ``inst_aabb_min``,
    ``inst_aabb_max``, ``inst_local_min``, ``inst_local_max``,
    ``root_aabb``, the five prim fields and the ints ``n_instances``,
    ``cluster_size``, ``max_clusters_per_blas`` and ``payload_mask``."""
    device = default_device(device)
    arrays = {}
    for k in _INSTANCED_ARRAYS:
        a = np.asarray(d[k])
        a = a.astype(np.int32) if a.dtype.kind in "iu" else a.astype(
            np.float32)
        arrays[k] = _tensor(a, device)
    return DenseInstancedScene(
        prims=_prims(d, device),
        inst_blas_host=np.asarray(d["inst_blas"], np.int32),
        n_instances=int(d["n_instances"]),
        cluster_size=int(d["cluster_size"]),
        max_clusters_per_blas=int(d["max_clusters_per_blas"]),
        payload_mask=int(d["payload_mask"]), **arrays)


def _f32(a, device):
    return _tensor(np.asarray(a, np.float32), device)


def materials_from_numpy(base_color, metallic, roughness, ior, transmission,
                         device=None) -> Materials:
    """``Materials`` from its five columns: (M, 3) and four (M,)."""
    device = default_device(device)
    return Materials(base_color=_f32(base_color, device),
                     metallic=_f32(metallic, device),
                     roughness=_f32(roughness, device),
                     ior=_f32(ior, device),
                     transmission=_f32(transmission, device))


def point_lights_from_numpy(position, intensity, device=None) -> PointLights:
    """``PointLights`` from (L, 3) positions and intensities."""
    device = default_device(device)
    return PointLights(position=_f32(position, device),
                       intensity=_f32(intensity, device))


def camera_from_numpy(position, target, up, fov_deg, device=None) -> Camera:
    device = default_device(device)
    return Camera(position=_f32(position, device),
                  target=_f32(target, device), up=_f32(up, device),
                  fov_deg=_f32(fov_deg, device))


def texture_pool_from_numpy(data, records, device=None) -> TexturePool:
    """``TexturePool`` from its flat float32 data and (n, 4) int32
    records."""
    device = default_device(device)
    return TexturePool(data=_f32(data, device),
                       records=_tensor(np.asarray(records, np.int32),
                                       device))


def static_multitypeset_from_numpy(tables, counts, data, records,
                                   device=None) -> StaticMultiTypeSet:
    """``StaticMultiTypeSet`` from its per-type tables (a sequence of
    dicts of arrays; float columns as float32, the others as int32), its
    (n_types,) counts and its texture pool's data and records."""
    device = default_device(device)

    def column(a):
        a = np.asarray(a)
        return _tensor(a.astype(np.float32 if a.dtype.kind == "f"
                                else np.int32), device)

    return StaticMultiTypeSet(
        tables=tuple({k: column(v) for k, v in t.items()} for t in tables),
        counts=_tensor(np.asarray(counts, np.int32), device),
        textures=texture_pool_from_numpy(data, records, device))
