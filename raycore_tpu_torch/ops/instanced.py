"""Regrouped sweep over a dense instanced scene, the dynamic fast path
(counterpart of ``raycore_tpu/ops/pallas_instanced.py``).

  1. Phase A (kernel K1) culls (ray tile, instance) pairs against the
     per-instance world AABBs.
  2. Each pair is refined to its G-ray subgroups (world space), and the
     surviving (subgroup, instance) pairs are compacted.
  3. Per pair, the subgroup's rays go into the instance's local space
     (o_l = R^-1 o + t, d_l = R^-1 d, then -0 -> +0) and become one row of
     the ray-feature table. Möller–Trumbore's t does not change under the
     affine map, so keys compare across instances.
  4. Each pair expands over its BLAS's clusters (a local-space interval
     test) into (pair, cluster row) candidates, packed cluster-major into
     blocks of SPB pairs.
  5. Kernel K2 in its pairrow mode sweeps the blocks against the local
     per-BLAS tables; its payload names the block row and lane, from
     which the instance is recovered.
  6. A grouped segment min per ray, then the exact scalar Möller–Trumbore
     in the winning instance's local space.

Every grid is sized from the data, with one host sync on each count. The
JAX package's predict-then-validate capacities (``_CAP_CACHE``,
``P_cap``/``Q_cap`` doubling with ``pairs_per_tile``, the fused warm
path) are not ported (ROADMAP.md, "What is not ported").

Tracing (``utils/config.py:span``): stage 1 runs in a ``raycore.stage1``
span, K2 in ``raycore.sweep``, the combine and the decode in
``raycore.combine``, the local finalize in ``raycore.finalize``, and each
host sync (the compactions, the block count, the small uploads) in a
``raycore.wait.<site>`` span.

The local rays' dots are fused multiply-add chains, as the JAX package's
compiled stage 1 computes them, so the candidates equal its candidates;
the ray features (``o_l x d_l``) and the finalize run in plain float32, as
in the dense engines.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.brute import HitResult
from ..accel.dense import FEAT, gather_hit_payload, ray_features
from ..core.transforms import _apply_mat3_fused
from ..core.triangle import safe_invdir
from ..utils.config import span
from .dense import (_t_from_keys, build_worklist, compact_indices,
                    interval_entry, phase_a_entry_bounds)
from .regroup import (COL_TMAX, COL_TMIN, _padded_batch, combine_rows_grouped,
                      group_flat_cluster_major, refine_pairs, run_regrouped,
                      subgroup_stats)


def _bundle_entry_vs_bounds(olo, ohi, ilo, ihi, tlo, thi, bmin, bmax):
    """Conservative ray-bundle vs AABB entry bound, +inf where no ray of
    the bundle can enter: ``interval_entry`` on stats assembled from the
    bundle's (..., 3) origin and inverse-direction ranges and (...,) t
    range. The JAX package's loop, in the same order."""
    st = torch.cat([olo, ohi, ilo, ihi, tlo[..., None], thi[..., None]],
                   dim=-1)
    return interval_entry(st, bmin, bmax)


def _local_rays(inv, o, d):
    """Rays (..., 3) into local space through inverses (..., 3, 4)
    broadcast against them: o_l = R o + t, d_l = R d with the fused dots
    of the JAX package's compiled code."""
    R = inv[..., :3]
    return _apply_mat3_fused(R, o) + inv[..., 3], _apply_mat3_fused(R, d)


@dataclasses.dataclass
class InstancedStage1:
    """What stage 1 hands stage 2: the pairrow block grid, the local ray
    table (Q pair rows and a dummy row Q with t_max = -inf), each pair's
    subgroup and instance, the coarse pair count and the candidate count
    (a device scalar: reading it is a host sync the query does not
    need)."""

    block_cid: torch.Tensor    # (B,) int32 cluster row
    block_subs: torch.Tensor   # (B, SPB) int32 pair ids, Q = dummy
    tbl: torch.Tensor          # (Q + 1, G, FEAT) float32
    qsub: torch.Tensor         # (Q,) int32 ray subgroup of each pair
    qinst: torch.Tensor        # (Q,) int32 instance of each pair
    coarse: int
    candidates: torch.Tensor   # () int64

    @property
    def counts(self) -> tuple:
        """(coarse (tile, instance) pairs, (subgroup, instance) pairs Q,
        (pair, cluster) candidates, blocks)."""
        return (self.coarse, self.qsub.shape[0], int(self.candidates),
                self.block_cid.shape[0])


def _stage1_inst_core(scene, o, d, t_min, t_max, TILE: int, G: int,
                      SPB: int) -> InstancedStage1:
    """Stage 1 on padded rays (a whole number of TILE-ray tiles)."""
    with span("raycore.stage1"):
        S = scene.max_clusters_per_blas
        SPT = TILE // G
        dev = o.device
        n_tiles = o.shape[0] // TILE
        n_sub = o.shape[0] // G

        # 1) (tile, instance) culling: kernel K1 on the instance AABBs.
        entry = phase_a_entry_bounds(scene.inst_aabb_min, scene.inst_aabb_max,
                                     o, d, t_min, t_max, n_tiles, TILE)
        tids, iids = build_worklist(entry)
        P = tids.shape[0]

        # 2) Subgroup refinement in world space.
        stats = subgroup_stats(o, d, t_min, t_max, G)
        fine = refine_pairs(stats, tids, iids, scene.inst_aabb_min,
                            scene.inst_aabb_max, SPT, n_tiles)     # (P, SPT)
        spt = torch.arange(SPT, dtype=torch.int32, device=dev)
        with span("raycore.wait.refine"):
            sel = compact_indices(torch.isfinite(fine).reshape(-1))
        refine_pairs.kept += sel.shape[0]
        qsub = (tids[:, None] * SPT + spt).reshape(-1)[sel]
        qinst = iids[:, None].expand(P, SPT).reshape(-1)[sel]
        Q = qsub.shape[0]

        # 3) Local-space rays and their feature table, one row of G a pair.
        qs, qi = qsub.long(), qinst.long()
        inv = scene.inst_inv[qi][:, None]                        # (Q, 1, 3, 4)
        o_l, d_l = _local_rays(inv, o.reshape(n_sub, G, 3)[qs],
                               d.reshape(n_sub, G, 3)[qs])
        d_l = torch.where(d_l == 0.0, 0.0, d_l)                 # -0 -> +0
        tmin_g = t_min.reshape(n_sub, G)[qs]
        tmax_g = t_max.reshape(n_sub, G)[qs]
        phi = ray_features(o_l.reshape(-1, 3), d_l.reshape(-1, 3)) \
            .reshape(Q, G, FEAT)
        phi[:, :, COL_TMIN] = tmin_g
        phi[:, :, COL_TMAX] = tmax_g
        dummy = torch.zeros((1, G, FEAT), dtype=torch.float32, device=dev)
        dummy[:, :, COL_TMAX] = -float("inf")
        tbl = torch.cat([phi, dummy])

        # 4) Cluster expansion in local space: S slots a pair, one per
        # cluster of its BLAS.
        ncl = scene.inst_ncl[qi]
        slots = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        crow = scene.inst_cbase[qi][:, None] \
            + torch.minimum(slots, ncl[:, None] - 1)
        cvalid = slots < ncl[:, None]                             # (Q, S)
        invd_l = safe_invdir(d_l)
        cr = crow.long()
        e2 = _bundle_entry_vs_bounds(
            o_l.amin(1)[:, None], o_l.amax(1)[:, None],
            invd_l.amin(1)[:, None], invd_l.amax(1)[:, None],
            tmin_g.amin(1)[:, None], tmax_g.amax(1)[:, None],
            scene.cluster_min[cr], scene.cluster_max[cr])        # (Q, S)
        tvalid = (cvalid & torch.isfinite(e2)).reshape(-1)
        pair_ids = torch.arange(Q, dtype=torch.int32, device=dev)[:, None] \
            .expand(Q, S).reshape(-1)
        block_cid, block_subs = group_flat_cluster_major(
            pair_ids, crow.reshape(-1), tvalid, SPB=SPB, n_sub=Q)
        return InstancedStage1(block_cid, block_subs, tbl, qsub, qinst, P,
                               tvalid.sum())


def decode_pairrow(pair, block_cid, block_subs, qinst, C: int, SPB: int):
    """(prim, inst) of pairrow winners (-1 on a miss): pair row = pair //
    C, lane = pair % C, block = pair row // SPB, prim = block_cid[block]*C
    + lane (a row of the scene's hot table), inst = qinst of the pair in
    that block row."""
    hit = pair >= 0
    safe = pair.clamp_min(0).long()
    pair_row = safe // C

    # A trailing sentinel keeps the lookups in range on an empty grid.
    def ext(a, v):
        with span("raycore.wait.sentinel"):
            tail = torch.tensor([v], dtype=torch.int64, device=a.device)
        return torch.cat([a.reshape(-1).long(), tail])

    cid = ext(block_cid, 0)[(pair_row // SPB).clamp(max=block_cid.numel())]
    row_pair = ext(block_subs, 0)[pair_row.clamp(max=block_subs.numel())]
    inst = ext(qinst, 0)[row_pair.clamp(0, qinst.numel())]
    prim = torch.where(hit, cid * C + safe % C, -1)
    return prim, torch.where(hit, inst, -1)


def _stage2_inst_core(scene, s1: InstancedStage1, o, d, G: int, SPB: int,
                      R_pad: int) -> HitResult:
    """K2 (pairrow), the grouped combine, the decode and the finalize.
    ``o``/``d`` are the unpadded rays."""
    C = scene.cluster_size
    n_sub = R_pad // G
    R = o.shape[0]
    with span("raycore.sweep"):
        key, pair = run_regrouped(s1.block_subs, s1.block_cid, s1.tbl,
                                  scene.tri_feats, G=G, SPB=SPB, C=C,
                                  payload="pairrow")
    with span("raycore.combine"):
        # The combine groups rows by ray subgroup: each block row's pair
        # maps to its subgroup, the dummy pair to the dummy subgroup n_sub.
        with span("raycore.wait.dummy"):
            dummy = torch.tensor([n_sub], dtype=torch.int32, device=o.device)
        subs_m = torch.cat([s1.qsub, dummy])[s1.block_subs.long()]
        out_key, out_pair = combine_rows_grouped(key, pair, subs_m, G, SPB,
                                                 n_sub)
        prim, inst = decode_pairrow(out_pair[:R], s1.block_cid,
                                    s1.block_subs, s1.qinst, C, SPB)
    with span("raycore.finalize"):
        inv = scene.inst_inv[inst.clamp_min(0)]
        o_l, d_l = _local_rays(inv, o, d)
        return _finalize_local(scene, prim, inst,
                               _t_from_keys(out_key[:R], 0), o_l, d_l)


def _finalize_local(scene, prim, inst, t_approx, o_l, d_l) -> HitResult:
    """Exact scalar Möller–Trumbore of each winner in its instance's local
    space (t, u and v do not change under the transform); barycentrics
    clamp into the simplex."""
    hit = (prim >= 0) & torch.isfinite(t_approx)
    tri, orig = gather_hit_payload(scene, prim.clamp_min(0), hit)
    v0, v1, v2 = tri.vertices[:, 0], tri.vertices[:, 1], tri.vertices[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    cross = torch.linalg.cross
    dot = lambda a, b: (a * b).sum(-1)
    s1 = cross(d_l, e2)
    det = dot(s1, e1)
    nz = det != 0.0
    r = torch.where(nz, 1.0 / torch.where(nz, det, 1.0), 0.0)
    dvec = o_l - v0
    u = dot(dvec, s1) * r
    s2 = cross(dvec, e1)
    v = dot(d_l, s2) * r
    t = torch.where(nz, dot(e2, s2) * r, t_approx)
    u = u.clamp(0.0, 1.0)
    v = torch.minimum(v.clamp_min(0.0), 1.0 - u)
    bary = torch.where(hit[:, None], torch.stack([1 - u - v, u, v], -1), 0.0)
    return HitResult(hit=hit, triangle=tri, t=torch.where(hit, t, 0.0),
                     barycentric=bary, prim_idx=orig.to(torch.int32),
                     instance_idx=torch.where(hit, inst, -1)
                     .to(torch.int32))


def _query(scene, rays, tile: int, subgroup: int, spb: int):
    """Both stages on the flattened, padded batch. Returns (result with
    the batch shape, the stage-1 handoff)."""
    batch = rays.batch_shape
    o, d, t_min, t_max, R0, G, TILE = _padded_batch(rays, tile, subgroup)
    s1 = _stage1_inst_core(scene, o, d, t_min, t_max, TILE, G, spb)
    res = _stage2_inst_core(scene, s1, o[:R0], d[:R0], G, spb, o.shape[0])
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:]))), s1


def closest_hit_instanced(scene, rays, *, tile: int = 2048,
                          subgroup: int = 32, spb: int = 16,
                          pairs_per_tile: int = 64,
                          with_checksum: bool = False):
    """Exact closest hit over a DenseInstancedScene. Every grid is sized
    from the data (a host sync on each count), so results are never
    truncated; ``pairs_per_tile``, the JAX package's first capacity
    guess, is taken and not needed. ``with_checksum=True`` returns
    ``(result, None)``: the JAX package's checksum rides its fused warm
    path, which is not ported, and it returns None off that path too."""
    res, _ = _query(scene, rays, tile, subgroup, spb)
    return (res, None) if with_checksum else res


def instanced_capacity_hint(scene, n_rays: int, *, tile: int = 2048,
                            subgroup: int = 32, spb: int = 16,
                            headroom: float = 1.5):
    """(p_cap, q_cap, nb) for ``closest_hit_instanced_static``. The port
    keeps no capacity cache (each query sizes its grids from its data), so
    this returns the capacities no query of ``n_rays`` rays can exceed:
    every (tile, instance) pair, every (subgroup, instance) pair, and the
    blocks those pairs could fill (the JAX package's hard maxima).
    ``headroom`` is taken and not needed."""
    G = min(subgroup, max(8, 1 << (max(n_rays, 1) - 1).bit_length()))
    TILE = -(-min(tile, max(n_rays, G)) // G) * G
    padded = n_rays + (-n_rays) % TILE
    p_cap = padded // TILE * scene.n_instances
    q_cap = padded // G * scene.n_instances
    nb = q_cap * scene.max_clusters_per_blas // spb + scene.n_clusters + 1
    return p_cap, q_cap, nb


def closest_hit_instanced_static(scene, rays, *, p_cap: int, q_cap: int,
                                 nb: int, tile: int = 2048,
                                 subgroup: int = 32, spb: int = 16):
    """``closest_hit_instanced`` with the JAX package's static-capacity
    signature. Returns ``(result, totals)``, totals the int32 tensor of
    the query's true (coarse pairs, subgroup pairs, blocks). The result is
    exact whatever the capacities: the grids are sized from the data, and
    ``totals <= (p_cap, q_cap, nb)`` says whether the JAX package's
    static query would have fitted."""
    res, s1 = _query(scene, rays, tile, subgroup, spb)
    coarse, pairs, _, blocks = s1.counts
    totals = torch.tensor([coarse, pairs, blocks], dtype=torch.int32,
                          device=res.t.device)
    return res, totals


def any_hit_instanced(scene, rays, **kw):
    """Occlusion over a DenseInstancedScene: the closest hit with t_min
    forced to 0. Only hit and the occluder's ids are the contract."""
    rays0 = dataclasses.replace(rays, t_min=torch.zeros_like(rays.t_min))
    return closest_hit_instanced(scene, rays0, **kw)
