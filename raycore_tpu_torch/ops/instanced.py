"""Regrouped sweep over a dense instanced scene, the dynamic fast path
(counterpart of ``raycore_tpu/ops/pallas_instanced.py``).

  1. Phase A (kernel K1) culls (ray tile, instance) pairs against the
     per-instance world AABBs.
  2. Each pair is refined to its G-ray subgroups (world space, kernel
     K7), and the surviving (subgroup, instance) pairs are compacted
     (``ops/regroup.py:refine_worklist``, as in the dense engines).
  3. Per pair, the subgroup's rays go into the instance's local space
     (o_l = R^-1 o + t, d_l = R^-1 d, then -0 -> +0; kernel K8's pair
     mode) and become one row of the ray-feature table. Möller–Trumbore's t does not change under the
     affine map, so keys compare across instances.
  4. Each pair expands over its BLAS's clusters (a local-space interval
     test) into (pair, cluster row) candidates, packed cluster-major into
     blocks of SPB pairs.
  5. Kernel K2 in its pairrow mode sweeps the blocks against the local
     per-BLAS tables; its payload names the block row and lane, from
     which the instance is recovered.
  6. A grouped segment min per ray, then the exact scalar Möller–Trumbore
     in the winning instance's local space (the rays through K8's ray
     mode).

Every grid is sized from the data, with one host sync on each count. The
JAX package's predict-then-validate capacities (``_CAP_CACHE``,
``P_cap``/``Q_cap`` doubling with ``pairs_per_tile``, the fused warm
path) are not ported (ROADMAP.md, "What is not ported").

Tracing (``utils/config.py:span``): stage 1 runs in a ``raycore.stage1``
span, K2 in ``raycore.sweep``, the combine and the decode in
``raycore.combine``, the local finalize in ``raycore.finalize``, and each
host sync (the compactions and the block count) in a
``raycore.wait.<site>`` span.

The local rays' dots are fused multiply-add chains, as the JAX package's
compiled stage 1 computes them, so the candidates equal its candidates;
on the card both local-ray steps (stage 1's pair rows and the finalize's
rays) are one launch each of kernel K8 (``ops/affine.py:local_rays``).
The ray features (``o_l x d_l``) and the finalize's test run in plain
float32, as in the dense engines.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.brute import HitResult
from ..accel.dense import exact_t_bary, gather_hit_payload
from ..core.triangle import safe_invdir
from ..utils.config import span
from .affine import local_rays
from .dense import (_t_from_keys, build_worklist, bundle_stats,
                    interval_entry, phase_a_entry)
from .regroup import (_padded_batch, combine_rows_grouped,
                      group_flat_cluster_major, ray_table, refine_worklist,
                      run_regrouped, table_invd)


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
        dev = o.device

        # 1) (tile, instance) culling (K1) on the instance AABBs, and 2)
        # the subgroup refine (K7) in world space, tile-major.
        invd = safe_invdir(d)
        bmin, bmax = scene.inst_aabb_min, scene.inst_aabb_max
        tids, iids = build_worklist(
            phase_a_entry(o, invd, t_min, t_max, bmin, bmax, TILE))
        qsub, qinst, _ = refine_worklist(
            bundle_stats(o, invd, t_min, t_max, G), tids, iids, bmin, bmax,
            TILE // G, o.shape[0] // TILE)
        P, Q = tids.shape[0], qsub.shape[0]

        # 3) Local-space rays (-0 directions turned into +0) and their
        # table, one subgroup of G a pair (K8 on the card).
        o_l, d_l, tmin_l, tmax_l = local_rays(
            scene.inst_inv, qinst, o, d, pairs=(qsub, t_min, t_max, G))
        tbl = ray_table(o_l, d_l, tmin_l, tmax_l, G)

        # 4) Cluster expansion in local space: S slots a pair, one per
        # cluster of its BLAS.
        qi = qinst.long()
        ncl = scene.inst_ncl[qi]
        slots = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        crow = scene.inst_cbase[qi][:, None] \
            + torch.minimum(slots, ncl[:, None] - 1)
        cvalid = slots < ncl[:, None]                             # (Q, S)
        cr = crow.long()
        st = bundle_stats(o_l, table_invd(tbl), tmin_l, tmax_l, G)
        e2 = interval_entry(st[:, None], scene.cluster_min[cr],
                            scene.cluster_max[cr])               # (Q, S)
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
    ext = lambda a, v: torch.nn.functional.pad(a.reshape(-1).long(), (0, 1),
                                               value=v)

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
        subs_m = torch.nn.functional.pad(s1.qsub, (0, 1), value=n_sub)[
            s1.block_subs.long()]
        out_key, out_pair = combine_rows_grouped(key, pair, subs_m, G, SPB,
                                                 n_sub)
        prim, inst = decode_pairrow(out_pair[:R], s1.block_cid,
                                    s1.block_subs, s1.qinst, C, SPB)
    with span("raycore.finalize"):
        # The exact test in the winner's instance's local space: t, u and
        # v do not change under the transform.
        t_approx = _t_from_keys(out_key[:R], 0)
        hit = (prim >= 0) & torch.isfinite(t_approx)
        tri, orig = gather_hit_payload(scene, prim.clamp_min(0), hit)
        o_l, d_l = local_rays(scene.inst_inv, inst, o, d)
        t, bary = exact_t_bary(tri, hit, t_approx, o_l, d_l)
        return HitResult(hit=hit, triangle=tri, t=t, barycentric=bary,
                         prim_idx=orig.to(torch.int32),
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
