"""Simple per-pixel renderer kernels (counterpart of
``raycore_tpu/render/simple.py``): ``trace(kernel, scene, cam, ...)``
drives a pinhole camera over a pixel grid and applies a shading kernel
to the batch of samples; stock kernels cover depth, normals, hard and
soft shadows, multi-light lambert and a one-bounce reflection. Queries go
through ``accel/dispatch.py``. Random draws come from a
``torch.Generator`` (``gen``; None: one seeded 0 on the scene's device)
through ``_primary_jitter`` and ``_disk_draws``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..accel import dispatch as _disp
from ..core.ray import Ray
from ..core.sampling import concentric_sample_disk, reflect
from ..core.triangle import bary_interp
from .wavefront import (Camera, Materials, PointLights, _generator,
                        _pinhole_rays, _scene_device, _unit_normal)


class Shading(NamedTuple):
    """What a shading kernel receives per sample (all batched)."""
    rays: Ray
    hit: torch.Tensor
    point: torch.Tensor
    normal: torch.Tensor
    t: torch.Tensor
    metadata: torch.Tensor


def _primary_jitter(gen, height, width, spp, device):
    """Sub-pixel offsets (H, W, spp, 2): uniforms for spp > 1, else the
    pixel centre."""
    if spp > 1:
        return torch.rand((height, width, spp, 2), generator=gen,
                          device=device)
    return torch.full((height, width, 1, 2), 0.5, device=device)


def _disk_draws(gen, n_shadow, R, device):
    """The soft-shadow light samples' uniforms (n_shadow, R, 2)."""
    return torch.rand((n_shadow, R, 2), generator=gen, device=device)


def trace(kernel: Callable[..., torch.Tensor], scene, cam: Camera, *,
          width=256, height=256, spp=1, gen=None, tile_size=16384,
          **kernel_kwargs):
    """Render with a kernel ``(scene, Shading, gen, **kw) -> (R, 3)`` ->
    (H, W, 3)."""
    dev = _scene_device(scene)
    gen = _generator(gen, dev)
    rays = _pinhole_rays(cam, width, height,
                         _primary_jitter(gen, height, width, spp, dev))
    res = _disp.scene_closest_hit(scene, rays, tile_size=tile_size)
    p = bary_interp(res.barycentric, res.triangle.vertices)
    n = _unit_normal(bary_interp(res.barycentric, res.triangle.normals))
    n = torch.where((n * rays.d).sum(-1, keepdim=True) > 0, -n, n)
    sh = Shading(rays=rays, hit=res.hit, point=p, normal=n, t=res.t,
                 metadata=res.triangle.metadata)
    color = kernel(scene, sh, gen, **kernel_kwargs)
    return torch.clamp(color.reshape(height, width, spp, 3).mean(2), 0.0,
                       1.0)


# -- stock kernels ------------------------------------------------------------

def depth_kernel(scene, sh: Shading, gen, *, t_scale=0.15):
    """Grayscale depth (nearer = brighter)."""
    g = torch.where(sh.hit, torch.exp(-sh.t * t_scale), 0.0)
    return torch.stack([g, g, g], -1)


def normal_kernel(scene, sh: Shading, gen):
    return torch.where(sh.hit[:, None], sh.normal * 0.5 + 0.5, 0.0)


def _occluded(scene, o, wi, dist, hit, eps, tile_size):
    """any_hit from lifted points ``o`` toward ``wi`` up to ``dist - 2
    eps`` where ``hit``; every argument broadcast to the shape of
    ``dist`` (plus a trailing 3), whose row-major order is the query's."""
    t_max = torch.where(hit, dist - 2 * eps, -1.0)
    occ = _disp.scene_any_hit(
        scene, Ray.create(o.expand(wi.shape).reshape(-1, 3),
                          wi.reshape(-1, 3), t_max=t_max.reshape(-1)),
        tile_size=tile_size)
    return occ.hit.reshape(dist.shape)


def shadow_kernel(scene, sh: Shading, gen, *, light_pos=(5, -5, 8),
                  light_radius=0.0, n_shadow=4, eps=1e-3,
                  base_color=(0.8, 0.8, 0.8), tile_size=16384):
    """Hard (radius 0) or soft shadows via disk-sampled light positions."""
    dev = sh.point.device
    light_pos = torch.tensor(light_pos, dtype=torch.float32, device=dev)
    R = sh.point.shape[0]
    if light_radius > 0:
        disk = concentric_sample_disk(_disk_draws(gen, n_shadow, R, dev)) \
            * light_radius                                   # (S, R, 2)
        lp = light_pos + torch.cat(
            [disk, torch.zeros((n_shadow, R, 1), device=dev)], -1)
    else:
        lp = light_pos[None, None, :].expand(1, R, 3)
    to_l = lp - sh.point[None]
    dist = torch.linalg.norm(to_l, dim=-1)                   # (S, R)
    wi = to_l / torch.clamp(dist[..., None], min=1e-12)
    occ = _occluded(scene, (sh.point + sh.normal * eps)[None], wi, dist,
                    sh.hit[None].expand(dist.shape), eps, tile_size)
    lit = 1.0 - occ.float().mean(0)
    ndotl = torch.clamp((sh.normal * wi[0]).sum(-1), min=0.0)
    c = torch.tensor(base_color, dtype=torch.float32, device=dev) \
        * (lit * ndotl + 0.07)[:, None]
    return torch.where(sh.hit[:, None], c, 0.02)


def _material_index(materials: Materials, metadata):
    return metadata.to(torch.int32).long().clamp(
        0, materials.base_color.shape[0] - 1)


def multi_light_kernel(scene, sh: Shading, gen, *, lights: PointLights,
                       materials: Materials, eps=1e-3, tile_size=16384):
    """Lambert with several point lights + occlusion."""
    to_l = lights.position[None] - sh.point[:, None]          # (R, L, 3)
    dist = torch.linalg.norm(to_l, dim=-1)
    wi = to_l / torch.clamp(dist[..., None], min=1e-12)
    occ = _occluded(scene, (sh.point + sh.normal * eps)[:, None], wi, dist,
                    sh.hit[:, None].expand(dist.shape), eps, tile_size)
    ndotl = torch.clamp((sh.normal[:, None] * wi).sum(-1), min=0.0)
    irr = lights.intensity[None] * (
        ndotl * (1 - occ.float()) / torch.clamp(dist ** 2, min=1e-12))[
        ..., None]
    base = materials.base_color[_material_index(materials, sh.metadata)]
    return torch.where(sh.hit[:, None], base * (irr.sum(1) + 0.06), 0.02)


def reflective_kernel(scene, sh: Shading, gen, *, lights: PointLights,
                      materials: Materials, eps=1e-3, tile_size=16384):
    """Multi-light lambert + one metallic bounce."""
    base = multi_light_kernel(scene, sh, gen, lights=lights,
                              materials=materials, eps=eps,
                              tile_size=tile_size)
    metal = materials.metallic[_material_index(materials, sh.metadata)]
    rd = reflect(-sh.rays.d, sh.normal)
    rd = rd / torch.clamp(torch.linalg.norm(rd, dim=-1, keepdim=True),
                          min=1e-12)
    active = sh.hit & (metal > 0)
    rres = _disp.scene_closest_hit(
        scene, Ray.create(sh.point + sh.normal * eps, rd,
                          t_max=torch.where(active, torch.inf, -1.0)),
        tile_size=tile_size)
    rp = bary_interp(rres.barycentric, rres.triangle.vertices)
    rn = _unit_normal(bary_interp(rres.barycentric, rres.triangle.normals))
    rsh = Shading(rays=Ray.create(sh.point, rd), hit=rres.hit, point=rp,
                  normal=rn, t=rres.t, metadata=rres.triangle.metadata)
    rcol = multi_light_kernel(scene, rsh, gen, lights=lights,
                              materials=materials, eps=eps,
                              tile_size=tile_size)
    m = metal[:, None]
    return torch.where(active[:, None], base * (1 - m) + rcol * m, base)
