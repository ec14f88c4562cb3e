"""Carry rays, triangles and built scenes across as NumPy arrays.

The dict form of a scene is what ``np.asarray`` gives for each field of a
``DenseScene`` from either package, so a scene built by one package can be
queried by the other. Every function puts its tensors on ``device``, the
CUDA card by default.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.dense import DenseScene
from .core.device import default_device
from .core.ray import Ray
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
