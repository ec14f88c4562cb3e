"""Wavefront renderer over heterogeneous MultiTypeSet materials
(counterpart of ``raycore_tpu/render/mts_renderer.py``).

Materials live in a MultiTypeSet with distinct per-type schemas (matte,
mirror, plastic, glass), and shading dispatches per hit on the type
slot, as ``with_index`` does for a batched key: every type's branch on
every hit, each hit taking its own. Triangle metadata encodes the key:
``meta = type_idx * 2^24 + row_idx``.
"""
from __future__ import annotations

import torch

from ..accel import dispatch as _disp
from ..collections.multitypeset import (MultiTypeSet, StaticMultiTypeSet,
                                        _switch, gather_row)
from ..core.ray import Ray
from ..core.sampling import reflect
from ..core.triangle import bary_interp
from .wavefront import (Camera, PointLights, RenderConfig, _background,
                        _direct, _generator, _scene_device, _surface_frame,
                        _unit_normal, compact_order, generate_primary_rays)

KEY_SHIFT = 24
TYPE_MATTE, TYPE_MIRROR, TYPE_PLASTIC, TYPE_GLASS = 0, 1, 2, 3

MATERIAL_TYPES = ("matte", "mirror", "plastic", "glass")


def pack_key(type_idx: int, row_idx: int) -> int:
    return (type_idx << KEY_SHIFT) | row_idx


def unpack_key(meta):
    meta = meta.to(torch.int32)
    return meta >> KEY_SHIFT, meta & ((1 << KEY_SHIFT) - 1)


def default_material_set(device=None):
    """A MultiTypeSet with one default of each of the four archetypes, in
    the order of the TYPE_* constants."""
    s = MultiTypeSet(device=device)
    s.push({"kd_r": 0.7, "kd_g": 0.7, "kd_b": 0.7, "sigma": 0.0}, "matte")
    s.push({"kr_r": 0.95, "kr_g": 0.95, "kr_b": 0.95}, "mirror")
    s.push({"kd_r": 0.6, "kd_g": 0.6, "kd_b": 0.6,
            "ks_r": 0.3, "ks_g": 0.3, "ks_b": 0.3, "rough": 0.1}, "plastic")
    s.push({"kt_r": 0.9, "kt_g": 0.9, "kt_b": 0.9, "eta": 1.5}, "glass")
    return s


def _rgb(row, prefix):
    return torch.stack([row[prefix + "_r"], row[prefix + "_g"],
                        row[prefix + "_b"]], -1)


def _shade_props(sset: StaticMultiTypeSet, type_idx, row_idx):
    """Per-hit (diffuse_rgb (R, 3), specular_rgb (R, 3), reflectivity
    (R,)) by type slot; a type index past the slots is clipped."""
    def matte(row):
        kd = _rgb(row, "kd")
        return kd, torch.zeros_like(kd), torch.zeros_like(kd[:, 0])

    def mirror(row):
        kr = _rgb(row, "kr")
        return torch.zeros_like(kr), kr, torch.ones_like(kr[:, 0])

    def plastic(row):
        kd = _rgb(row, "kd")
        return kd, _rgb(row, "ks"), torch.full_like(kd[:, 0], 0.35)

    def glass(row):
        kt = _rgb(row, "kt")
        return torch.zeros_like(kt), kt, torch.full_like(kt[:, 0], 0.9)

    fns = (matte, mirror, plastic, glass)
    ti = torch.as_tensor(type_idx).reshape(-1)
    ri = torch.as_tensor(row_idx).reshape(-1)
    return _switch(ti, min(len(sset.tables), len(fns)),
                   lambda k: fns[k](gather_row(sset.tables[k], ri)))


def render_step_mts(scene, sset: StaticMultiTypeSet, lights: PointLights,
                    cam: Camera, gen, cfg: RenderConfig):
    """One frame with per-hit material dispatch -> (H, W, 3). A single
    jit in the JAX package; here eager stages with every query taking
    dispatch's engine."""
    H, W, spp = cfg.height, cfg.width, cfg.spp
    R = H * W * spp
    n_lights = lights.position.shape[0]
    dev = _scene_device(scene)
    bg = _background(cfg.background, dev)

    rays = generate_primary_rays(cam, W, H, spp, _generator(gen, dev))
    res = _disp.scene_closest_hit(scene, rays, tile_size=cfg.tile_size)
    hit = res.hit
    p, n = _surface_frame(res, rays.d)
    kd, ks, refl = _shade_props(sset, *unpack_key(res.triangle.metadata))

    # Shadow rays.
    to_l = lights.position[None] - p[:, None]
    dist = torch.linalg.norm(to_l, dim=-1)
    wi = to_l / torch.clamp(dist[..., None], min=1e-12)
    so = (p + n * cfg.shadow_eps)[:, None, :].expand(R, n_lights, 3) \
        .reshape(-1, 3)
    st = torch.where(hit.repeat_interleave(n_lights),
                     (dist - 2 * cfg.shadow_eps).reshape(-1), -1.0)
    occ = _disp.scene_any_hit(scene, Ray.create(so, wi.reshape(-1, 3),
                                                t_max=st),
                              tile_size=cfg.tile_size).hit.reshape(R,
                                                                   n_lights)
    ndotl = torch.clamp((n[:, None] * wi).sum(-1), min=0.0)
    vis = torch.where(occ, 0.0, 1.0)
    irr = lights.intensity[None] * (
        ndotl * vis / torch.clamp(dist * dist, min=1e-12))[..., None]
    color = torch.where(hit[:, None], kd * (irr.sum(1) + cfg.ambient), bg)

    # One specular bounce for the reflective types, traced compacted.
    active = hit & (refl > 0.0)
    rd = reflect(-rays.d, n)
    rd = rd / torch.clamp(torch.linalg.norm(rd, dim=-1, keepdim=True),
                          min=1e-12)
    order = compact_order(active)
    inv = torch.argsort(order, stable=True)
    rres = _disp.scene_closest_hit(
        scene, Ray.create((p + n * cfg.reflect_eps)[order], rd[order],
                          t_max=torch.where(active[order], torch.inf,
                                            -1.0)),
        tile_size=cfg.tile_size).map(lambda a: a[inv])
    r_p = bary_interp(rres.barycentric, rres.triangle.vertices)
    r_n = _unit_normal(bary_interp(rres.barycentric, rres.triangle.normals))
    r_kd, _, _ = _shade_props(sset, *unpack_key(rres.triangle.metadata))
    r_col = torch.where(rres.hit[:, None],
                        _direct(r_p, r_n, r_kd, lights, cfg.ambient), bg)

    color = torch.where(active[:, None],
                        color * (1 - refl[:, None])
                        + ks * r_col * refl[:, None], color)
    img = color.reshape(H, W, spp, 3).mean(2)
    return torch.clamp(img, 0.0, 1.0)
