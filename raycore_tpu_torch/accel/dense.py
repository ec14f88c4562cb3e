"""Dense clustered scene: the build, the finalizes and the rounds engine
(counterpart of ``raycore_tpu/accel/dense.py``): ``DenseScene``,
``build_dense``, ``gather_hit_payload``, ``finalize_hits``,
``finalize_hits_exact`` (its arithmetic ``exact_t_bary``, which the
instanced engine shares), ``depth_layers``, ``closest_hit_dense``,
``any_hit_dense`` and ``morton_sort_rays``, plus ``prim_only_hits``, the
payload-free result of the occlusion and slim queries.

Build: triangles are sorted spatially and cut into clusters of C
consecutive triangles. Each triangle is *featurized*: every Möller–Trumbore
quantity is a bilinear form in ray features and triangle features,

    det   = d · (e2 x e1) = -d · n    n  = e1 x e2
    u*det = (o x d) · e2  - d · (e2 x v0)
    v*det = -(o x d) · e1 - d · (v0 x e1)
    t*det = o · n - v0 · n

so with ray features phi = [d, o x d, o, 1, ...] (16 wide) and a (16, 4C)
per-cluster triangle matrix, all four quantities for a block of rays
against one cluster are one small matrix product (ops/regroup.py).

The rounds engine (``closest_hit_dense``) is the reference's plain-XLA
query: phase A's (tile, cluster) entry matrix from kernel K1
(``ops/dense.py:phase_a_entry``), then rounds that each pick the S
untested clusters of smallest entry per tile, test the tile's rays
against them in one ``torch.bmm`` per group of tiles, and keep each ray's
nearest hit, until no untested cluster can beat a tile's farthest best.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.triangle import Triangle, cross, dot3, safe_invdir
from .brute import HitResult
from .types import (PAD_COORD, f32_as_i32, flush_denormals, i32_as_f32,
                    next_pow2)

FEAT = 16
# ray_features' columns of the inverse direction, safe_invdir(d).
INVD_COLS = slice(10, 13)
EDGE_EPS = 1e-5   # barycentric acceptance slack of the featurized test
# The rounds engine's product per group of tiles: at most this many
# float32 elements (512 MiB). Tiles are independent, so the group size
# bounds memory and never changes a result.
ROUND_GROUP_ELEMS = 1 << 27


@dataclasses.dataclass
class DenseScene:
    """Clustered, featurized triangle soup (world space).

    ``tri_feats`` columns are sub-chunk-major: for each of the SUB
    sub-chunks of CS = C/SUB consecutive triangles, the four quantity
    blocks [det | u*det | v*det | t*det] x CS are contiguous."""

    tri_feats: torch.Tensor    # (K, FEAT, 4*C) float32, sub-chunk-major
    cluster_min: torch.Tensor  # (K, 3)
    cluster_max: torch.Tensor  # (K, 3)
    sub_bounds: torch.Tensor   # (K, 1, 128) float32; cols [s*6:(s+1)*6]
                               # hold sub-chunk s's [min xyz, max xyz]
    prims: Triangle            # caller's original order, unpadded
    prims_hot: torch.Tensor    # (K*C, 11) int32, sorted cluster-major:
                               # [vertex float32 bits (9), metadata,
                               # original index]
    root_aabb: torch.Tensor    # (2, 3) over real triangles only
    n_prims: int
    cluster_size: int
    sub_chunks: int = 4
    payload_mask: int = 0b111
    # payload_mask bits: 1 = normals nonzero, 2 = tangents nonzero,
    # 4 = uv nonzero, 8 = flat-shaded (normals are the face normals).
    instance_of_prim: torch.Tensor | None = None
    # int32 instance slot per original-order triangle, or None when every
    # hit reports instance 0.
    _depth_layers: float | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # depth_layers' value for this scene, computed at first use.
    # ``dataclasses.replace`` makes a new scene without it.

    @property
    def n_clusters(self) -> int:
        return self.tri_feats.shape[0]


def pack_prims_hot(tris: Triangle, orig_idx=None) -> torch.Tensor:
    """(T, 11) int32 hot rows [vertex float32 bits (9), metadata, original
    index]; ``orig_idx`` defaults to row order."""
    T = tris.vertices.shape[0]
    if orig_idx is None:
        orig_idx = torch.arange(T, dtype=torch.int32, device=tris.device)
    return torch.cat([
        f32_as_i32(tris.vertices.reshape(T, 9).contiguous()),
        tris.metadata.to(torch.int32)[:, None],
        orig_idx.to(torch.int32)[:, None]], dim=1)


def _face_normals(v):
    """Unit face normal per triangle, normalize(cross(v1-v0, v2-v0)), with a
    zero-length normal left at 0, in plain float32. The probe and the
    finalize use this same formula.

    The length is a ``vector_norm`` reduction, not ``torch.sqrt``: on the
    CPU, ``torch.sqrt`` of float32 goes through MKL's vector math library,
    which in a fresh worker thread has been seen to return x * rsqrt(x)
    from the 12-bit reciprocal square root estimate (relative error up to
    3.7e-4) for one thread's share of the rows, then exact results on the
    next call (ROADMAP queue 3, F3). The reduction takes its square root
    per row in the C library."""
    fn = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = torch.linalg.vector_norm(fn, dim=-1, keepdim=True)
    return fn / torch.where(ln > 0, ln, 1.0)


def gather_hit_payload(scene: DenseScene, idx, hit):
    """(Triangle, original index) for winning rows: one hot-row gather plus
    per-field gathers of the cold fields that ``payload_mask`` marks
    nonzero. ``idx`` is in sorted (table) space; cold fields are looked up
    by the hot row's original index. Misses get original index -1."""
    R = idx.shape[0]
    dev = idx.device
    rows = scene.prims_hot[idx]                                # (R, 11)
    rows = torch.where(hit[:, None], rows, 0)
    meta = torch.where(hit, rows[:, 9].to(torch.int64) & 0xFFFFFFFF, 0)
    n_cold = scene.prims.vertices.shape[0]
    orig = torch.where(hit, rows[:, 10], -1)
    cidx = orig.clamp(0, n_cold - 1)

    def cold(field, ncols, bit):
        if scene.payload_mask & bit:
            g = field.reshape(-1, ncols)[cidx]
            return torch.where(hit[:, None], g, 0.0)
        return torch.zeros((R, ncols), dtype=torch.float32, device=dev)

    verts = i32_as_f32(rows[:, 0:9].contiguous()).reshape(R, 3, 3)
    if scene.payload_mask & 8:
        # Flat-shaded mesh: the face normal is recomputed from the
        # gathered vertices instead of a second payload gather.
        fn = torch.where(hit[:, None], _face_normals(verts), 0.0)
        normals = fn[:, None, :].expand(R, 3, 3)
    else:
        normals = cold(scene.prims.normals, 9, 1).reshape(R, 3, 3)
    tri = Triangle(vertices=verts, normals=normals,
                   tangents=cold(scene.prims.tangents, 9, 2).reshape(R, 3, 3),
                   uv=cold(scene.prims.uv, 6, 4).reshape(R, 3, 2),
                   metadata=meta)
    return tri, orig


def _featurize_tris(v0, v1, v2):
    """(T, FEAT, 4) per-triangle feature matrix; the quantity columns are
    [det, u*det, v*det, t*det]. Rows 10-15 stay zero. The products use the
    reference's fused multiply-add chains (core/triangle.py), and a
    denormal result is flushed to a zero of its sign, as the reference's
    float32 arithmetic flushes them (XLA on the CPU and the TPU), so the
    one-time build gives the reference's tables. Near-degenerate
    triangles and small coordinates give such entries (a cross product
    below 2^-126, e.g. in a small local-space BLAS)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    T = v0.shape[0]
    psi = torch.zeros((T, FEAT, 4), dtype=torch.float32, device=v0.device)
    psi[:, 0:3, 0] = -n                      # det = -d . n
    psi[:, 0:3, 1] = -cross(e2, v0)          # u*det
    psi[:, 3:6, 1] = e2
    psi[:, 0:3, 2] = -cross(v0, e1)          # v*det
    psi[:, 3:6, 2] = -e1
    psi[:, 6:9, 3] = n                       # t*det = o . n - v0 . n
    psi[:, 9, 3] = -dot3(v0, n)
    return flush_denormals(psi)


def ray_features(o, d):
    """(R, FEAT) ray feature rows: [d, o x d, o, 1, safe_invdir(d), 0...],
    in plain float32. The triangle feature rows under cols 10:16 are
    zero."""
    R = o.shape[0]
    phi = torch.zeros((R, FEAT), dtype=torch.float32, device=o.device)
    phi[:, 0:3] = d
    phi[:, 3:6] = torch.linalg.cross(o, d)
    phi[:, 6:9] = o
    phi[:, 9] = 1.0
    phi[:, INVD_COLS] = safe_invdir(d)
    return phi


def _dense_tables_from_hot(hot, cluster_size: int, sub_chunks: int):
    """Feature blocks and bounds from sorted int32 hot rows."""
    T = hot.shape[0]
    C = cluster_size
    SUB = sub_chunks
    CS = C // SUB
    K = T // C
    v = i32_as_f32(hot[:, :9].contiguous()).reshape(T, 3, 3)
    psi = _featurize_tris(v[:, 0], v[:, 1], v[:, 2])          # (T, 16, 4)
    blocks = psi.reshape(K, SUB, CS, FEAT, 4) \
        .permute(0, 3, 1, 4, 2).reshape(K, FEAT, 4 * C).contiguous()
    vk = v.reshape(K, SUB, CS, 3, 3)
    smin = vk.amin(dim=(2, 3))                                 # (K, SUB, 3)
    smax = vk.amax(dim=(2, 3))
    sb = torch.cat([smin, smax], dim=2).reshape(K, SUB * 6)
    sub_bounds = torch.zeros((K, 1, 128), dtype=torch.float32,
                             device=hot.device)
    sub_bounds[:, 0, :SUB * 6] = sb
    cmin = smin.amin(dim=1)
    cmax = smax.amax(dim=1)
    # Root AABB over real triangles only: padding sits at PAD_COORD and
    # sorts into the tail clusters. Cluster and sub-chunk bounds keep the
    # sentinel spans.
    inf = torch.tensor(float("inf"), device=hot.device)
    tvalid = (v.abs() < PAD_COORD * 0.5).all(dim=2).all(dim=1)   # (T,)
    vmin = torch.where(tvalid[:, None], v.amin(dim=1), inf)
    vmax = torch.where(tvalid[:, None], v.amax(dim=1), -inf)
    root = torch.stack([vmin.amin(0), vmax.amax(0)])
    return blocks, cmin, cmax, sub_bounds, root


def _pack_hot_padded(v, meta, cap: int):
    """(cap, 11) int32 original-order hot rows with vertex sentinels on
    the padding."""
    n = v.shape[0]
    dev = v.device
    v9 = torch.cat([v.reshape(n, 9).to(torch.float32),
                    torch.full((cap - n, 9), PAD_COORD, dtype=torch.float32,
                               device=dev)])
    mi = torch.cat([meta.to(torch.int32),
                    torch.zeros(cap - n, dtype=torch.int32, device=dev)])
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    return torch.cat([f32_as_i32(v9), mi[:, None], idx[:, None]], dim=1)


def _probe_mesh(tris: Triangle):
    """(lohi ndarray(6), payload_mask int) for a mesh, with one readback.

    Flat-shaded detection: when every stored vertex normal equals the face
    normal within 1e-6, the winner's normals are recomputed from its
    gathered vertices at finalize instead of gathered."""
    v, n = tris.vertices, tris.normals
    vr = v.reshape(-1, 3)
    fn = _face_normals(v)[:, None, :]
    flat = ((n - fn).abs() <= 1e-6).all() & (n != 0).any()
    flags = torch.stack([(n != 0).any(), (tris.tangents != 0).any(),
                         (tris.uv != 0).any(), flat]).to(torch.float32)
    host = torch.cat([vr.amin(0), vr.amax(0), flags]).cpu().numpy()
    f = host[6:].astype(bool)
    mask = int(1 * f[0] + 2 * f[1] + 4 * f[2] + 8 * f[3])
    return host[:6], mask


def build_dense(tris: Triangle, cluster_size: int = 256,
                sub_chunks: int = 1, layout: str = "tiles",
                instance_of=None) -> DenseScene:
    """Cluster and featurize a triangle soup on the triangles' device.

    Triangles are sorted spatially, and the capacity is padded to a power
    of two (at least one cluster) with far-away sentinels. Only the hot
    rows are permuted; ``prims`` keeps the caller's order and hits report
    original indices.

    layout="tiles" (default): count-balanced strip/slab/chunk sort, so
    clusters are compact axis-aligned tiles. layout="morton": Morton-chunk
    clustering (one sort, fatter clusters).

    instance_of: optional (n,) instance slot per input triangle, looked up
    by a hit's original index."""
    from .lbvh import morton_perm_padded, tile_perm_padded, tile_sort_axes
    if layout not in ("tiles", "morton"):
        raise ValueError(f"layout must be 'tiles' or 'morton', got {layout}")
    n = tris.vertices.shape[0]
    cap = max(next_pow2(n), cluster_size)
    lohi, payload_mask = _probe_mesh(tris)
    hot0 = _pack_hot_padded(tris.vertices, tris.metadata, cap)
    vp = i32_as_f32(hot0[:, :9].contiguous()).reshape(cap, 3, 3)
    if layout == "tiles":
        axes, s0, s1 = tile_sort_axes(tris.vertices, cap, cluster_size,
                                      lohi=lohi)
        perm = tile_perm_padded(vp, axes=axes, s0=s0, s1=s1)
    else:
        perm = morton_perm_padded(vp)
    hot = hot0[perm]
    blocks, cmin, cmax, sub_bounds, root = _dense_tables_from_hot(
        hot, cluster_size, sub_chunks)
    inst = (None if instance_of is None else
            torch.as_tensor(instance_of, device=tris.device).to(torch.int32))
    return DenseScene(tri_feats=blocks, cluster_min=cmin, cluster_max=cmax,
                      sub_bounds=sub_bounds, prims=tris, prims_hot=hot,
                      root_aabb=root, n_prims=cap, cluster_size=cluster_size,
                      sub_chunks=sub_chunks, payload_mask=payload_mask,
                      instance_of_prim=inst)


def depth_layers(scene: DenseScene, n_probe_side: int = 16,
                 gap_frac: float = 0.02) -> float:
    """The median over the three axes of the mean number of disjoint
    depth layers that the cluster AABBs form along axis-aligned probe
    rays: an open sheet reads about 1 along its height axis, a closed or
    multi-layer surface about 2 along at least two axes.
    ``passes="auto"`` (``ops/regroup.py:auto_passes``) takes the ordered
    multiwave where it reaches 1.6.

    Host NumPy over the (K, 3) bounds, copied from the device once per
    scene and cached on the scene. Clusters that touch the capacity
    padding at PAD_COORD are left out. A gap counts as a layer boundary
    only past ``gap_frac`` of the scene's extent along the probe axis.
    The arithmetic is the JAX package's, float32 step for step."""
    if scene._depth_layers is None:
        scene._depth_layers = _depth_layers(
            scene.cluster_min.cpu().numpy(), scene.cluster_max.cpu().numpy(),
            n_probe_side, gap_frac)
    return scene._depth_layers


def _depth_layers(bmin, bmax, n_probe_side: int, gap_frac: float) -> float:
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    real = np.all(np.abs(bmax) < PAD_COORD * 0.5, axis=1) \
        & np.all(np.abs(bmin) < PAD_COORD * 0.5, axis=1)
    bmin, bmax = bmin[real], bmax[real]
    if bmin.shape[0] == 0:
        return 1.0
    per_axis = []
    for a in range(3):
        u, v = (a + 1) % 3, (a + 2) % 3
        ext_a = float(bmax[:, a].max() - bmin[:, a].min())
        gap = gap_frac * max(ext_a, 1e-9)
        us = np.linspace(bmin[:, u].min(), bmax[:, u].max(),
                         n_probe_side + 2, dtype=np.float32)[1:-1]
        vs = np.linspace(bmin[:, v].min(), bmax[:, v].max(),
                         n_probe_side + 2, dtype=np.float32)[1:-1]
        U, V = np.meshgrid(us, vs, indexing="ij")
        Uf, Vf = U.reshape(-1, 1), V.reshape(-1, 1)
        inside = (Uf >= bmin[None, :, u]) & (Uf <= bmax[None, :, u]) \
            & (Vf >= bmin[None, :, v]) & (Vf <= bmax[None, :, v])
        lo = np.where(inside, bmin[None, :, a], np.inf)
        hi = np.where(inside, bmax[None, :, a], -np.inf)
        order = np.argsort(lo, axis=1)
        lo_s = np.take_along_axis(lo, order, axis=1)
        hi_s = np.take_along_axis(hi, order, axis=1)
        cummax = np.maximum.accumulate(hi_s, axis=1)
        new_group = (lo_s[:, 1:] > cummax[:, :-1] + gap) \
            & np.isfinite(lo_s[:, 1:])
        any_hit = np.isfinite(lo_s[:, 0])
        n_hit = int(any_hit.sum())
        if n_hit:
            per_axis.append(
                float((new_group.sum(axis=1) + any_hit).sum()) / n_hit)
    return float(np.median(per_axis)) if per_axis else 1.0


def _hit_instance_idx(scene: DenseScene, orig, hit):
    """Owning-instance index of each winning prim: the side array when the
    scene has one, else instance 0. ``orig`` is the original-order
    index."""
    if scene.instance_of_prim is None:
        return torch.where(hit, 0, -1).to(torch.int32)
    n = scene.instance_of_prim.shape[0]
    inst = scene.instance_of_prim[orig.clamp(0, n - 1)]
    return torch.where(hit, inst, -1).to(torch.int32)


def prim_only_hits(scene: DenseScene, pair, t=None,
                   metadata: bool = False) -> HitResult:
    """HitResult of the payload-free queries from table-space winners
    ``pair`` (-1 on a miss): hit, original prim_idx and instance_idx, with
    a zero triangle and barycentric. ``t`` (zeros when None) and, with
    ``metadata=True``, the winner's metadata ride along; the occlusion
    queries return neither."""
    R = pair.shape[0]
    dev = pair.device
    hit = pair >= 0
    orig = torch.where(hit, scene.prims_hot[:, 10][pair.clamp_min(0)], -1)
    t = (torch.zeros(R, dtype=torch.float32, device=dev) if t is None
         else torch.where(hit, t, 0.0))
    meta = (torch.where(hit, scene.prims.metadata[orig.clamp_min(0)], 0)
            if metadata else torch.zeros(R, dtype=torch.int64, device=dev))
    z3 = torch.zeros((R, 3, 3), dtype=torch.float32, device=dev)
    tri = Triangle(vertices=z3, normals=z3, tangents=z3,
                   uv=torch.zeros((R, 3, 2), dtype=torch.float32, device=dev),
                   metadata=meta)
    return HitResult(hit=hit, triangle=tri, t=t,
                     barycentric=torch.zeros((R, 3), dtype=torch.float32,
                                             device=dev),
                     prim_idx=orig,
                     instance_idx=_hit_instance_idx(scene, orig, hit))


def finalize_hits_exact(scene: DenseScene, pair, t_approx, o, d) -> HitResult:
    """HitResult from winning (pair, t): gather the winning triangle and
    recompute (t, u, v) with ``exact_t_bary``."""
    hit = (pair >= 0) & torch.isfinite(t_approx)
    tri, orig = gather_hit_payload(scene, pair.clamp_min(0), hit)
    t, bary = exact_t_bary(tri, hit, t_approx, o, d)
    return HitResult(hit=hit, triangle=tri, t=t, barycentric=bary,
                     prim_idx=orig,
                     instance_idx=_hit_instance_idx(scene, orig, hit))


def exact_t_bary(tri: Triangle, hit, t_approx, o, d):
    """(t, barycentric) of rays (o, d) against their gathered winning
    triangles ``tri`` by scalar float32 Möller–Trumbore, t_approx where
    det is 0, zeros off ``hit``. Winners admitted under the featurized
    sweep's edge slack clamp into the barycentric simplex."""
    v0, v1, v2 = tri.vertices[:, 0], tri.vertices[:, 1], tri.vertices[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    cross = torch.linalg.cross
    dot = lambda a, b: (a * b).sum(-1)
    s1 = cross(d, e2)
    det = dot(s1, e1)
    nz = det != 0.0
    r = torch.where(nz, 1.0 / torch.where(nz, det, 1.0), 0.0)
    dvec = o - v0
    u = dot(dvec, s1) * r
    s2 = cross(dvec, e1)
    v = dot(d, s2) * r
    t = torch.where(nz, dot(e2, s2) * r, t_approx)
    u = u.clamp(0.0, 1.0)
    v = torch.minimum(v.clamp_min(0.0), 1.0 - u)
    bary = torch.where(hit[:, None], torch.stack([1 - u - v, u, v], -1), 0.0)
    return torch.where(hit, t, 0.0), bary


def finalize_hits(scene: DenseScene, pair, t, u, v) -> HitResult:
    """HitResult from the rounds engine's raw bests: the winner's payload
    gathered, t and the barycentric from the featurized test itself."""
    hit = (pair >= 0) & torch.isfinite(t)
    tri, orig = gather_hit_payload(scene, pair.clamp_min(0), hit)
    bary = torch.where(hit[:, None], torch.stack([1 - u - v, u, v], -1), 0.0)
    return HitResult(hit=hit, triangle=tri, t=torch.where(hit, t, 0.0),
                     barycentric=bary, prim_idx=orig,
                     instance_idx=_hit_instance_idx(scene, orig, hit))


# ---------------------------------------------------------------------------
# The rounds engine
# ---------------------------------------------------------------------------

def _first_argmin(x):
    """Index of the first minimum along the last axis, as ``jnp.argmin``
    picks it (``torch.argmin`` does not promise the first index on CUDA).
    A row of +inf picks 0."""
    cols = torch.arange(x.shape[-1], device=x.device)
    hit = x == x.amin(dim=-1, keepdim=True)
    return torch.where(hit, cols, x.shape[-1]).amin(dim=-1)


def _epilogue(q, t_min, cur_best, C: int, sub_chunks: int = 4):
    """(t or +inf, u, v) per (row, triangle) from the quantity block q
    (R, 4C), sub-chunk-major; columns come out in the cluster's triangle
    order. ``fast_intersect_triangle``'s semantics with the EDGE_EPS
    barycentric slack of the featurized test, and t within
    [t_min, cur_best]."""
    R = q.shape[0]
    qs = q.reshape(R, sub_chunks, 4, C // sub_chunks)
    det, udet, vdet, tdet = (qs[:, :, k].reshape(R, C) for k in range(4))
    r = 1.0 / det
    u = udet * r
    v = vdet * r
    t = tdet * r
    e = EDGE_EPS
    ok = (u >= -e) & (u <= 1.0 + e) & (v >= -e) & (u + v <= 1.0 + e) \
        & (t >= t_min[:, None]) & (t <= cur_best[:, None])
    return torch.where(ok, t, float("inf")), u, v


def _round_group(scene: DenseScene, phi_g, cids_g, bt, bp, bu, bv, tmin_g):
    """One round on a group of TG tiles: test each tile's rays against its
    S picked clusters in one product, and replace a ray's best where the
    first of the nearest accepted hits is strictly nearer."""
    TG, tile, _ = phi_g.shape
    S = cids_g.shape[1]
    C = scene.cluster_size
    blocks = scene.tri_feats[cids_g.reshape(-1)] \
        .reshape(TG, S, FEAT, 4 * C).permute(0, 2, 1, 3) \
        .reshape(TG, FEAT, S * 4 * C)
    q = torch.bmm(phi_g, blocks)                        # (TG, tile, S*4C)
    t_pair, u, v = _epilogue(q.reshape(-1, 4 * C),
                             tmin_g.reshape(-1).repeat_interleave(S),
                             bt.reshape(-1).repeat_interleave(S), C,
                             scene.sub_chunks)
    t_pair = t_pair.reshape(TG, tile, S * C)
    arg = _first_argmin(t_pair)                         # (TG, tile)
    take = lambda a: a.reshape(TG, tile, S * C).gather(
        2, arg[..., None])[..., 0]
    tmin_c = take(t_pair)
    better = tmin_c < bt
    pair_id = cids_g.gather(1, arg // C) * C + arg % C
    return (torch.where(better, tmin_c, bt),
            torch.where(better, pair_id.to(torch.int32), bp),
            torch.where(better, take(u), bu),
            torch.where(better, take(v), bv))


def _closest_hit_dense_flat(scene: DenseScene, o, d, t_min, t_max, *,
                            tile: int, select_per_round: int,
                            max_rounds: int):
    """The rounds on padded rows (R a multiple of ``tile``). Returns the
    raw bests (pair int32, t, u, v) of each row and the rounds taken.

    Each round picks per tile the S = ``select_per_round`` clusters of
    smallest entry by a repeated first-index argmin, setting each pick to
    +inf; a tile with no finite entry left picks cluster 0 again and
    again, as the reference does. The loop asks the host once a round
    whether any tile still has an untested cluster whose entry is below
    its farthest best t."""
    from ..ops.dense import phase_a_entry
    R = o.shape[0]
    C = scene.cluster_size
    S = select_per_round
    n_tiles = R // tile
    dev = o.device
    phi = ray_features(o, d)
    entry = phase_a_entry(o, phi[:, INVD_COLS], t_min, t_max,   # K1
                          scene.cluster_min, scene.cluster_max, tile)
    phi = phi.reshape(n_tiles, tile, FEAT)
    tmin_t = t_min.reshape(n_tiles, tile)
    best_t = t_max.reshape(n_tiles, tile).clone()
    best_pair = torch.full((n_tiles, tile), -1, dtype=torch.int32,
                           device=dev)
    best_u = torch.zeros((n_tiles, tile), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    tiles = torch.arange(n_tiles, device=dev)
    TG = max(1, min(n_tiles, ROUND_GROUP_ELEMS // (tile * S * 4 * C)))
    rounds = 0
    while rounds < max_rounds and bool(
            (entry < best_t.amax(dim=1, keepdim=True)).any()):
        sel = []
        for _ in range(S):
            cid = _first_argmin(entry)
            sel.append(cid)
            entry[tiles, cid] = float("inf")
        cids = torch.stack(sel, dim=1)                  # (n_tiles, S)
        for g in range(0, n_tiles, TG):
            s = slice(g, g + TG)
            best_t[s], best_pair[s], best_u[s], best_v[s] = _round_group(
                scene, phi[s], cids[s], best_t[s], best_pair[s], best_u[s],
                best_v[s], tmin_t[s])
        rounds += 1
    flat = lambda a: a.reshape(R)
    return (flat(best_pair), flat(best_t), flat(best_u), flat(best_v),
            rounds)


def _dense_query(scene: DenseScene, rays, *, tile: int, select_per_round: int,
                 max_rounds: int):
    """Flatten, pad to whole tiles (``ops/dense.py:pad_rays``), run the
    rounds and finalize. Returns (HitResult of the flat rows, rounds)."""
    from ..ops.dense import flat_rays, pad_rays
    o, d, t_min, t_max = flat_rays(rays)
    R = o.shape[0]
    tile = min(tile, max(R, 8))
    po, pd, ptmin, ptmax = pad_rays(o, d, t_min, t_max, tile)
    pair, t, u, v, rounds = _closest_hit_dense_flat(
        scene, po, pd, ptmin, ptmax, tile=tile,
        select_per_round=select_per_round, max_rounds=max_rounds)
    return finalize_hits(scene, pair[:R], t[:R], u[:R], v[:R]), rounds


def closest_hit_dense(scene: DenseScene, rays, *, tile: int = 2048,
                      select_per_round: int = 4,
                      max_rounds: int = 1024) -> HitResult:
    """Exact closest hit via the rounds engine, on the scene's device;
    phase A launches kernel K1 on CUDA tensors. Rays should be spatially
    coherent in batch order (primary grids are; sort an incoherent batch
    with ``morton_sort_rays`` first). t and the barycentric come from the
    featurized test, not from an exact recompute."""
    batch = rays.batch_shape
    res, _ = _dense_query(scene, rays, tile=tile,
                          select_per_round=select_per_round,
                          max_rounds=max_rounds)
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))


def any_hit_dense(scene: DenseScene, rays, **kw) -> HitResult:
    """Occlusion on the rounds engine: ``closest_hit_dense`` with t_min
    forced to 0; only the hit mask is the occlusion contract."""
    rays0 = dataclasses.replace(rays, t_min=torch.zeros_like(rays.t_min))
    return closest_hit_dense(scene, rays0, **kw)


def morton_sort_rays(rays, bounds_min, bounds_max):
    """Sort a flat ray batch by the Morton code of its origin in the box
    [bounds_min, bounds_max] with its direction's octant on top, so the
    rounds engine's tiles become compact. Returns (sorted rays, inverse
    permutation); ``result.map(lambda a: a[inv])`` restores the caller's
    order. The uint32 key ``(code >> 3) | (octant << 29)`` is built in
    int64 and sorted stably, as ``jnp.argsort`` sorts."""
    from .morton import morton_code_30bit
    o, d = rays.o, rays.d
    lo = torch.as_tensor(bounds_min, dtype=torch.float32, device=o.device)
    hi = torch.as_tensor(bounds_max, dtype=torch.float32, device=o.device)
    ext = torch.clamp_min(hi - lo, 1e-12)
    code = morton_code_30bit((o - lo) / ext)
    pos = (d > 0).to(torch.int64)
    oct_d = pos[:, 0] | (pos[:, 1] << 1) | (pos[:, 2] << 2)
    key = (code >> 3) | (oct_d << 29)
    order = torch.argsort(key, stable=True)
    inv = torch.argsort(order, stable=True)
    sorted_rays = type(rays)(**{f.name: getattr(rays, f.name)[order]
                                for f in dataclasses.fields(rays)})
    return sorted_rays, inv
