"""Bake an instanced TLAS into one world-space triangle soup (counterpart
of ``raycore_tpu/scene/bake.py``).

``bake_dense`` transforms every live instance's triangles by its 3x4
transform and builds a ``DenseScene`` over the soup, the static fast
path: geometry is duplicated per instance, hits report the owning
instance through the scene's ``instance_of_prim`` side array, and a
transform change needs a new bake (``refresh_instances`` of
``scene/instanced.py`` serves per-frame dynamics).
"""
from __future__ import annotations

import numpy as np
import torch

from ..accel.dense import DenseScene, build_dense
from ..core.transforms import _apply_mat3
from ..core.triangle import Triangle


def flatten_world_triangles(mgr) -> tuple[Triangle, torch.Tensor]:
    """(world-space Triangle soup, int32 instance index per triangle) of
    a TLAS manager's instances, in instance order, each instance's real
    BLAS prims in their Morton order. Vertices go through R and t and
    normals through the inverse transpose of R (from NumPy), in plain
    float32, as the JAX package's eager calls compute them."""
    parts, inst_of = [], []
    dev = mgr.device
    for idx, rec in enumerate(mgr._instances):
        blas = mgr._blas[rec.blas_slot]
        n = blas.n_prims
        tris = blas.prims
        m = torch.as_tensor(rec.transform, device=dev)
        v = _apply_mat3(m[:, :3], tris.vertices[:n]) + m[:, 3]
        R = np.asarray(rec.transform)[:, :3]
        r_it = torch.as_tensor(np.linalg.inv(R).T.astype(np.float32),
                               device=dev)
        parts.append(Triangle(vertices=v,
                              normals=_apply_mat3(r_it, tris.normals[:n]),
                              tangents=tris.tangents[:n], uv=tris.uv[:n],
                              metadata=tris.metadata[:n]))
        inst_of.append(torch.full((n,), idx, dtype=torch.int32, device=dev))
    soup = Triangle(**{name: torch.cat([getattr(p, name) for p in parts])
                       for name in ("vertices", "normals", "tangents", "uv",
                                    "metadata")})
    return soup, torch.cat(inst_of)


def bake_dense(mgr, cluster_size: int = 128) -> DenseScene:
    """A DenseScene over the manager's world-space soup; hits report the
    owning instance slot, as the traversal's instance_idx does."""
    soup, inst_of = flatten_world_triangles(mgr)
    return build_dense(soup, cluster_size=cluster_size, instance_of=inst_of)
