"""The dense instanced scene, the fast path for dynamic instanced scenes
(counterpart of ``raycore_tpu/scene/instanced.py``).

Per-BLAS clustered feature tables in LOCAL space, built once per
geometry, plus per-instance transforms and world AABBs that
``refresh_instances`` recomputes each frame. Queries sweep (ray
subgroup, instance, cluster) triples (``ops/instanced.py``).
Möller–Trumbore in instance-local space gives the world-space t (an
affine map keeps the ray parameter), so hit keys compare across
instances.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.dense import build_dense
from ..accel.tlas_build import transformed_aabbs
from ..core.transforms import mat3x4_inverse
from ..core.triangle import Triangle
from ..ops.affine import refresh_tables
from ..utils.config import span

_PRIM_FIELDS = ("vertices", "normals", "tangents", "uv", "metadata")


@dataclasses.dataclass
class DenseInstancedScene:
    """Concatenated per-BLAS cluster tables (local space, cluster-major)
    and per-instance transforms and bounds."""

    tri_feats: torch.Tensor     # (K_total, FEAT, 4*C) float32
    cluster_min: torch.Tensor   # (K_total, 3) local AABBs
    cluster_max: torch.Tensor   # (K_total, 3)
    prims: Triangle             # concatenated per-BLAS local prims, each
                                # BLAS's real prims in its Morton order
    prims_hot: torch.Tensor     # (K_total*C, 11) int32 sorted hot rows;
                                # col 10 indexes ``prims`` (rebased)
    inst_inv: torch.Tensor      # (I, 3, 4) world -> local
    inst_blas: torch.Tensor     # (I,) int32 dense BLAS slot
    inst_cbase: torch.Tensor    # (I,) int32 first cluster row of its BLAS
    inst_ncl: torch.Tensor      # (I,) int32 cluster count of its BLAS
    inst_aabb_min: torch.Tensor  # (I, 3) world AABBs
    inst_aabb_max: torch.Tensor  # (I, 3)
    inst_local_min: torch.Tensor  # (I, 3) local root AABB of its BLAS
    inst_local_max: torch.Tensor  # (I, 3)
    root_aabb: torch.Tensor     # (2, 3) world
    inst_blas_host: np.ndarray  # (I,) int32, inst_blas on the host
    n_instances: int
    cluster_size: int
    max_clusters_per_blas: int
    payload_mask: int = 0b111

    @property
    def n_clusters(self) -> int:
        return self.tri_feats.shape[0]


def _gather_instance_arrays(mgr):
    slots = sorted({rec.blas_slot for rec in mgr._instances})
    slot_to_dense = {s: i for i, s in enumerate(slots)}
    transforms = np.stack([rec.transform for rec in mgr._instances]) \
        .astype(np.float32)
    blas_idx = np.asarray([slot_to_dense[rec.blas_slot]
                           for rec in mgr._instances], np.int32)
    return slots, transforms, blas_idx


def bake_instanced(mgr, cluster_size: int = 128,
                   layout: str = "morton") -> DenseInstancedScene:
    """A DenseInstancedScene from a TLAS manager, on its device: one
    dense build per distinct BLAS (local space) and per instance the
    transform's inverse and world AABB. For transform-only dynamics call
    ``refresh_instances`` each frame instead of baking again.

    The inverses are computed as the JAX package's eager bake computes
    them (fused cross products, plain determinant and translation;
    ``mat3x4_inverse``), so the tables equal its tables bit for bit."""
    assert mgr._instances, "empty scene"
    dev = mgr.device
    slots, transforms, blas_idx = _gather_instance_arrays(mgr)
    per = []
    for s in slots:
        blas = mgr._blas[s]
        n = blas.n_prims
        tris = Triangle(**{f: getattr(blas.prims, f)[:n]
                           for f in _PRIM_FIELDS})
        per.append(build_dense(tris, cluster_size=cluster_size,
                               layout=layout))
    ncl = np.asarray([p.n_clusters for p in per], np.int32)
    cbase = np.concatenate([[0], np.cumsum(ncl)[:-1]]).astype(np.int32)
    local_min = torch.stack([p.root_aabb[0] for p in per])
    local_max = torch.stack([p.root_aabb[1] for p in per])
    cat = lambda f: torch.cat([f(p) for p in per])
    prims = Triangle(**{f: cat(lambda p: getattr(p.prims, f))
                        for f in _PRIM_FIELDS})
    # Rebase each BLAS's hot original-index column (local, possibly at
    # padding) onto its rows of the concatenated prims.
    prim_base = np.concatenate(
        [[0], np.cumsum([p.prims.vertices.shape[0] for p in per])[:-1]])
    hot_parts = []
    for base, p in zip(prim_base, per):
        h = p.prims_hot.clone()
        h[:, 10] = h[:, 10].clamp(0, p.prims.vertices.shape[0] - 1) \
            + int(base)
        hot_parts.append(h)

    tf = torch.as_tensor(transforms, device=dev)
    bi = torch.as_tensor(blas_idx, device=dev)
    lmin, lmax = local_min[bi.long()], local_max[bi.long()]
    wmin, wmax = transformed_aabbs(tf, lmin, lmax)
    pm = 0
    for p in per:
        pm |= p.payload_mask & 0b111
    # Bit 8 (flat-shaded: the finalize recomputes face normals) holds
    # scene-wide only if every member mesh is flat-shaded.
    if per and all((p.payload_mask & 0b1001) == 0b1001 for p in per):
        pm |= 8
    return DenseInstancedScene(
        tri_feats=cat(lambda p: p.tri_feats),
        cluster_min=cat(lambda p: p.cluster_min),
        cluster_max=cat(lambda p: p.cluster_max),
        prims=prims, prims_hot=torch.cat(hot_parts),
        inst_inv=mat3x4_inverse(tf), inst_blas=bi,
        inst_cbase=torch.as_tensor(cbase, device=dev)[bi.long()],
        inst_ncl=torch.as_tensor(ncl, device=dev)[bi.long()],
        inst_aabb_min=wmin, inst_aabb_max=wmax,
        inst_local_min=lmin, inst_local_max=lmax,
        root_aabb=torch.stack([wmin.amin(0), wmax.amax(0)]),
        inst_blas_host=blas_idx, n_instances=len(mgr._instances),
        cluster_size=cluster_size, max_clusters_per_blas=int(ncl.max()),
        payload_mask=pm)


def refresh_instances(scene: DenseInstancedScene,
                      mgr) -> DenseInstancedScene:
    """Per-frame transform refresh: new inverses (fused, as the JAX
    package's compiled refresh) and world AABBs only, in one launch of
    kernel K8 on the card (``ops/affine.py:refresh_tables``); geometry
    tables and shapes stay. The instance set must be the one baked: a changed count,
    or a delete and push that changes which BLAS an instance slot
    references, raises ValueError (re-bake with ``bake_instanced``). Runs
    in a ``raycore.refresh`` span, the upload of the transforms (a host
    sync) in ``raycore.wait.transforms`` (``utils/config.py:span``)."""
    with span("raycore.refresh"):
        _, transforms, blas_idx = _gather_instance_arrays(mgr)
        if transforms.shape[0] != scene.n_instances:
            raise ValueError(
                "instance set changed; re-bake with bake_instanced")
        if not np.array_equal(blas_idx, scene.inst_blas_host):
            raise ValueError(
                "instance->BLAS assignment changed since bake_instanced "
                "(delete+push cycle?); re-bake with bake_instanced")
        with span("raycore.wait.transforms"):
            tf = torch.as_tensor(transforms, device=scene.inst_inv.device)
        inv, wmin, wmax = refresh_tables(tf, scene.inst_local_min,
                                         scene.inst_local_max)
        return dataclasses.replace(
            scene, inst_inv=inv, inst_aabb_min=wmin, inst_aabb_max=wmax,
            root_aabb=torch.stack([wmin.amin(0), wmax.amax(0)]))
