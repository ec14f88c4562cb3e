"""Carry rays, triangles, boxes, transforms and built scenes across as
NumPy arrays.

The dict form of a scene is what ``np.asarray`` gives for each field of a
``DenseScene`` from either package, so a scene built by one package can be
queried by the other. Every function puts its tensors on ``device``, the
CUDA card by default.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.dense import DenseScene
from .core.bounds import Bounds2, Bounds3
from .core.device import default_device
from .core.ray import Ray
from .core.transforms import Transformation
from .core.triangle import Triangle

_SCENE_ARRAYS = ("tri_feats", "cluster_min", "cluster_max", "sub_bounds",
                 "prims_hot", "root_aabb")
_PRIM_FIELDS = ("vertices", "normals", "tangents", "uv", "metadata")


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
