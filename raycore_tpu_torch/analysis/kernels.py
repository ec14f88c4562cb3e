"""Analysis layer: ray grids, centroid, illumination and radiosity view
factors (counterpart of ``raycore_tpu/analysis/kernels.py``). Every query
goes through ``accel/dispatch.py``; ``view_factors`` draws from a
``torch.Generator`` (None: one seeded 0 on the scene's device) through
``_batch_draws``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel import dispatch as _disp
from ..core.ray import Ray
from ..core.sampling import get_orthogonal_basis, sum_mul
from ..render.wavefront import _generator, _scene_device


@dataclasses.dataclass
class RayHits:
    """Batched hit record."""
    hit: torch.Tensor       # (...,) bool
    point: torch.Tensor     # (..., 3) barycentric-reconstructed hit point
    metadata: torch.Tensor  # (...,) triangle metadata payload


def _unit(v):
    return v / torch.linalg.norm(v)


def generate_ray_grid(scene, ray_direction, grid_size: int):
    """Orthographic ray-origin grid on a plane behind the scene, oriented
    by the view direction, sized from the world bound + 5% margin.
    Returns (G, G, 3) origins."""
    dev = _scene_device(scene)
    direction = _unit(torch.as_tensor(ray_direction, dtype=torch.float32,
                                      device=dev))
    lo, hi = scene.root_aabb[0], scene.root_aabb[1]
    cs = torch.arange(8, device=dev)
    bits = torch.stack([(cs >> 0) & 1, (cs >> 1) & 1, (cs >> 2) & 1], -1)
    corners = torch.where(bits == 1, hi, lo)                    # (8, 3)

    temp = torch.tensor([1.0, 0.0, 0.0] if abs(float(direction[0])) < 0.9
                        else [0.0, 1.0, 0.0], device=dev)
    basis1 = _unit(torch.linalg.cross(direction, temp))
    basis2 = _unit(torch.linalg.cross(direction, basis1))

    proj1 = (corners * basis1).sum(-1)
    proj2 = (corners * basis2).sum(-1)
    min1, max1 = proj1.min(), proj1.max()
    min2, max2 = proj2.min(), proj2.max()
    margin = 0.05 * torch.maximum(max1 - min1, max2 - min2)
    width = max1 - min1 + 2 * margin
    height = max2 - min2 + 2 * margin

    min_depth = (corners * direction).sum(-1).min() - margin
    center = min_depth * direction + 0.5 * (min1 + max1) * basis1 \
        + 0.5 * (min2 + max2) * basis2

    ij = torch.arange(1, grid_size + 1, dtype=torch.float32, device=dev)
    u = (ij - (grid_size + 1) / 2.0) * (width / grid_size)
    v = (ij - (grid_size + 1) / 2.0) * (height / grid_size)
    U, V = torch.meshgrid(u, v, indexing="ij")
    return center + U[..., None] * basis1 + V[..., None] * basis2


def hits_from_grid(scene, viewdir, *, grid_size: int = 32,
                   tile_size: int = 16384) -> RayHits:
    """Trace the orthographic grid; hit point = barycentric-weighted
    vertices."""
    direction = _unit(torch.as_tensor(viewdir, dtype=torch.float32,
                                      device=_scene_device(scene)))
    origins = generate_ray_grid(scene, direction, grid_size)
    rays = Ray.create(origins, direction.expand(origins.shape))
    res = _disp.scene_closest_hit(scene, rays, tile_size=tile_size)
    point = sum_mul(res.barycentric, res.triangle.vertices)
    return RayHits(hit=res.hit, point=point, metadata=res.triangle.metadata)


def get_centroid(scene, viewdir, *, grid_size: int = 32,
                 tile_size: int = 16384):
    """(hits, centroid): visible surface points and the mean over the
    hit points."""
    hits = hits_from_grid(scene, viewdir, grid_size=grid_size,
                          tile_size=tile_size)
    w = hits.hit.float()[..., None]
    denom = torch.clamp(w.sum(), min=1.0)
    return hits, (hits.point * w).sum(dim=(0, 1)) / denom


def get_illumination(scene, viewdir, *, grid_size: int = 1000,
                     n_bins: int | None = None, tile_size: int = 16384):
    """Per-metadata-index hit counts, the exposure from a direction.
    Returns (n_bins,) float32."""
    if n_bins is None:
        n_bins = int(scene.prims.metadata.shape[0])
    hits = hits_from_grid(scene, viewdir, grid_size=grid_size,
                          tile_size=tile_size)
    idx = hits.metadata.to(torch.int32).reshape(-1).long().clamp(
        0, n_bins - 1)
    out = torch.zeros((n_bins,), device=idx.device)
    return out.index_add_(0, idx, hits.hit.reshape(-1).float())


def _batch_draws(gen, T: int, ray_batch: int, device):
    """One batch's uniforms: surface points (T, ray_batch, 2) and
    hemisphere directions (T, ray_batch, 2)."""
    r = torch.rand((T, ray_batch, 2), generator=gen, device=device)
    xi = torch.rand((T, ray_batch, 2), generator=gen, device=device)
    return r, xi


def view_factors(scene, triangles, gen, *, rays_per_triangle: int = 10_000,
                 n_bins: int | None = None, offset: float = 0.01,
                 ray_batch: int = 256, tile_size: int = 16384):
    """Radiosity view-factor count matrix: for each source triangle,
    uniform-hemisphere rays from random surface points offset along the
    normal; counts land in ``result[src_meta, hit_meta]``, self-hits
    excluded. ``triangles`` is the (T,) Triangle SoA to sample from. Rays
    are traced in batches of ``T * ray_batch``. Returns (n_bins, n_bins)
    float32."""
    dev = _scene_device(scene)
    gen = _generator(gen, dev)
    T = triangles.vertices.shape[0]
    if n_bins is None:
        n_bins = T
    v = triangles.vertices
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-20)
    u_b, v_b = get_orthogonal_basis(n)
    src_meta = triangles.metadata.to(torch.int32).long().clamp(0, n_bins - 1)
    src = src_meta[:, None].expand(T, ray_batch)

    result = torch.zeros((n_bins * n_bins,), device=dev)
    for _ in range(-(-rays_per_triangle // ray_batch)):
        r, xi = _batch_draws(gen, T, ray_batch, dev)
        sqrt_r1 = torch.sqrt(r[..., 0])
        bary = torch.stack([1.0 - sqrt_r1, sqrt_r1 * (1.0 - r[..., 1]),
                            sqrt_r1 * r[..., 1]], -1)
        pts = (bary[..., None] * v[:, None, :, :]).sum(dim=-2)
        o = pts + offset * n[:, None, :]
        theta = torch.arccos(xi[..., 0])
        phi = 2.0 * torch.pi * xi[..., 1]
        st, ct = torch.sin(theta), torch.cos(theta)
        d = (u_b[:, None] * (st * torch.cos(phi))[..., None]
             + v_b[:, None] * (st * torch.sin(phi))[..., None]
             + n[:, None] * ct[..., None])
        res = _disp.scene_closest_hit(
            scene, Ray.create(o.reshape(-1, 3), d.reshape(-1, 3)),
            tile_size=tile_size)
        hit_meta = res.triangle.metadata.to(torch.int32).long().clamp(
            0, n_bins - 1).reshape(T, ray_batch)
        valid = res.hit.reshape(T, ray_batch) & (hit_meta != src)
        result.index_add_(0, (src * n_bins + hit_meta).reshape(-1),
                          valid.reshape(-1).float())
    return result.reshape(n_bins, n_bins)
