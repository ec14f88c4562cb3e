"""Wavefront renderer (counterpart of ``raycore_tpu/render/wavefront.py``).

The 9-stage pipeline over SoA wavefront queues: primary rays -> closest
hit -> shadow rays -> occlusion -> lambert shade -> reflection rays
(compacted: active lanes first) -> closest hit -> blend -> accumulate.
Materials are an SoA table indexed by triangle metadata.

The glue stages are eager tensor code and every query goes through
``accel/dispatch.py``, which picks the engine by scene form and batch
size: ``render_step`` (a single jit in the JAX package, whose queries
there take the in-jit engines) and ``render_staged`` run the same stages
here, and their hits meet the engine contract against the JAX package's.
Random draws come from a ``torch.Generator`` (``None``: one seeded 0 on
the scene's device) through ``_pixel_jitter`` and ``_roughness_draws``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..accel import dispatch as _disp
from ..core.device import as_f32, default_device
from ..core.ray import Ray
from ..core.sampling import reflect
from ..core.triangle import bary_interp


def _device_of(x, device):
    """The device of a tensor ``x``, else ``default_device(device)``."""
    return x.device if isinstance(x, torch.Tensor) else default_device(device)


@dataclasses.dataclass
class Materials:
    """SoA material table."""
    base_color: torch.Tensor    # (M, 3)
    metallic: torch.Tensor      # (M,)
    roughness: torch.Tensor     # (M,)
    ior: torch.Tensor           # (M,)
    transmission: torch.Tensor  # (M,)

    @classmethod
    def create(cls, base_color, metallic=None, roughness=None, ior=None,
               transmission=None, device=None):
        """Missing columns take metallic 0, roughness 0, ior 1.5 and
        transmission 0. Lists and arrays go to ``device``, the CUDA card
        by default; tensors stay on their device."""
        dev = _device_of(base_color, device)
        base_color = as_f32(base_color, dev)
        m = base_color.shape[0]
        z = lambda v, d: (torch.full((m,), d, device=dev) if v is None
                          else as_f32(v, dev))
        return cls(base_color=base_color, metallic=z(metallic, 0.0),
                   roughness=z(roughness, 0.0), ior=z(ior, 1.5),
                   transmission=z(transmission, 0.0))

    def take(self, idx) -> "Materials":
        """Rows ``idx`` (already in range) of every column."""
        return Materials(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class PointLights:
    """SoA point lights."""
    position: torch.Tensor   # (L, 3)
    intensity: torch.Tensor  # (L, 3)

    @classmethod
    def create(cls, position, intensity, device=None):
        dev = _device_of(position, device)
        return cls(position=as_f32(position, dev),
                   intensity=as_f32(intensity, dev))


@dataclasses.dataclass
class Camera:
    position: torch.Tensor
    target: torch.Tensor
    up: torch.Tensor
    fov_deg: torch.Tensor

    @classmethod
    def create(cls, position, target, up=(0, 0, 1), fov_deg=45.0,
               device=None):
        device = default_device(device)
        f = lambda x: as_f32(x, device)
        return cls(position=f(position), target=f(target), up=f(up),
                   fov_deg=f(fov_deg))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 256
    spp: int = 1
    ambient: float = 0.08
    shadow_eps: float = 1e-3
    reflect_eps: float = 1e-3
    tile_size: int = 16384
    background: tuple = (0.05, 0.07, 0.12)


def _scene_device(scene) -> torch.device:
    """The device of a StaticTLAS, DenseScene or DenseInstancedScene."""
    return scene.root_aabb.device


def _generator(gen, device):
    """``gen``, or a generator seeded 0 on ``device`` for None."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    return gen


def _pixel_jitter(gen, height: int, width: int, spp: int, device):
    """The primary rays' sub-pixel jitter: (H, W, spp, 2) uniforms."""
    return torch.rand((height, width, spp, 2), generator=gen, device=device)


def _roughness_draws(gen, shape, device):
    """The reflection rays' roughness jitter: uniforms of ``shape``."""
    return torch.rand(shape, generator=gen, device=device)


def camera_basis(cam: Camera):
    fwd = cam.target - cam.position
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, cam.up)
    right = right / torch.linalg.norm(right)
    up = torch.linalg.cross(right, fwd)
    return fwd, right, up


def _pinhole_rays(cam: Camera, width: int, height: int, jit) -> Ray:
    """Pinhole lookat rays through pixel (x, y) at offset ``jit``
    (H, W, spp, 2) within it, pixel-major."""
    dev = cam.position.device
    fwd, right, up = camera_basis(cam)
    tan_half = torch.tan(torch.deg2rad(cam.fov_deg) * 0.5)
    aspect = width / height
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None, None]
    u = ((px + jit[..., 0]) / width * 2.0 - 1.0) * tan_half * aspect
    v = (1.0 - (py + jit[..., 1]) / height * 2.0) * tan_half
    d = fwd + u[..., None] * right + v[..., None] * up
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = cam.position.expand(d.shape)
    return Ray.create(o.reshape(-1, 3), d.reshape(-1, 3))


def generate_primary_rays(cam: Camera, width: int, height: int, spp: int,
                          gen) -> Ray:
    """Stage 1: pinhole lookat rays, spp jittered samples per pixel."""
    dev = cam.position.device
    jit = _pixel_jitter(_generator(gen, dev), height, width, spp, dev)
    return _pinhole_rays(cam, width, height, jit)


def _mat_lookup(materials: Materials, idx):
    return materials.take(idx.long().clamp(0, materials.base_color.shape[0]
                                           - 1))


def compact_order(active):
    """Stable order putting active lanes first."""
    return torch.argsort((~active).to(torch.int8), stable=True)


def _shade_lambert(hit_p, hit_n, mats, lights: PointLights, occluded,
                   ambient):
    """Stages 4-5: lambert + inverse-square attenuation + hard shadows +
    ambient."""
    to_l = lights.position[None, :, :] - hit_p[:, None, :]     # (R, L, 3)
    dist2 = (to_l * to_l).sum(dim=-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    wi = to_l / dist[..., None]
    ndotl = torch.clamp((hit_n[:, None, :] * wi).sum(-1), min=0.0)
    vis = torch.where(occluded, 0.0, 1.0)
    irr = lights.intensity[None] * (ndotl * vis
                                    / torch.clamp(dist2, min=1e-12))[..., None]
    return mats.base_color * (irr.sum(dim=1) + ambient)


def _surface_frame(res, in_dir):
    """Hit point and the viewer-facing smooth unit normal of a query
    result (a zero normal where the interpolated one vanishes)."""
    tri = res.triangle
    p = bary_interp(res.barycentric, tri.vertices)
    n = _unit_normal(bary_interp(res.barycentric, tri.normals))
    n = torch.where((n * in_dir).sum(-1, keepdim=True) > 0, -n, n)
    return p, n


def _unit_normal(n):
    nl = torch.linalg.norm(n, dim=-1, keepdim=True)
    return torch.where(nl > 1e-8, n / torch.where(nl > 0, nl, 1.0), 0.0)


def _background(bg, device):
    """The background colour (3,) float32, filled on ``device``: an
    upload from the host would wait there for the work already queued."""
    return torch.stack([torch.full((), float(c), device=device) for c in bg])


def _shadow_setup_core(rays, res, materials, lights, cfg: RenderConfig):
    """Stages 2-3: surface frame, material fetch, shadow-ray SoA."""
    n_lights = lights.position.shape[0]
    hit = res.hit
    hit_p, n = _surface_frame(res, rays.d)
    mats = _mat_lookup(materials, res.triangle.metadata.to(torch.int32))
    to_l = lights.position[None] - hit_p[:, None]
    dist = torch.linalg.norm(to_l, dim=-1)
    wi = to_l / torch.clamp(dist[..., None], min=1e-12)
    so = (hit_p + n * cfg.shadow_eps)[:, None, :] \
        .repeat(1, n_lights, 1).reshape(-1, 3)
    sd = wi.reshape(-1, 3)
    st = torch.where(hit.repeat_interleave(n_lights),
                     (dist - 2 * cfg.shadow_eps).reshape(-1), -1.0)
    return dict(hit=hit, hit_p=hit_p, n=n, mats=mats, so=so, sd=sd, st=st)


def _shade_reflect_core(rays, occl_hit, s, gen, lights, cfg: RenderConfig):
    """Stages 5-6: lambert shade + compacted reflection rays with
    roughness jitter."""
    hit, hit_p, n, mats = s["hit"], s["hit_p"], s["n"], s["mats"]
    R = hit.shape[0]
    n_lights = lights.position.shape[0]
    occluded = occl_hit.reshape(R, n_lights)
    view_dir = -rays.d
    color = _shade_lambert(hit_p, n, mats, lights, occluded, cfg.ambient)
    color = torch.where(hit[:, None], color,
                        _background(cfg.background, hit_p.device))

    refl_active = hit & (mats.metallic > 0.0)
    rd = reflect(view_dir, n)
    # Roughness jitter: uniform [-1,1]^3 offset scaled by the material's
    # roughness, renormalized. roughness=0 mirrors exactly.
    offs = _roughness_draws(gen, rd.shape, rd.device) * 2.0 - 1.0
    rd = rd + offs * mats.roughness[:, None]
    rd = rd / torch.clamp(torch.linalg.norm(rd, dim=-1, keepdim=True),
                          min=1e-12)
    order = compact_order(refl_active)
    inv_order = torch.argsort(order, stable=True)
    return dict(color=color, refl_active=refl_active, rd=rd,
                inv_order=inv_order,
                ro_c=(hit_p + n * cfg.reflect_eps)[order], rd_c=rd[order],
                act_c=refl_active[order], mats=mats)


def _direct(p, n, mats_color, lights, ambient):
    """Unshadowed lambert from every light plus ambient."""
    to_l = lights.position[None] - p[:, None]
    d2 = (to_l * to_l).sum(-1)
    wi = to_l / torch.clamp(torch.sqrt(d2)[..., None], min=1e-12)
    ndotl = torch.clamp((n[:, None] * wi).sum(-1), min=0.0)
    irr = lights.intensity[None] * (ndotl / torch.clamp(d2, min=1e-12))[
        ..., None]
    return mats_color * (irr.sum(1) + ambient)


def _blend_core(rres_sorted, s2, materials, lights, cfg: RenderConfig):
    """Stages 7-9: shade reflections, metallic blend, sample mean."""
    H, W, spp = cfg.height, cfg.width, cfg.spp
    rres = rres_sorted.map(lambda a: a[s2["inv_order"]])
    bg = _background(cfg.background, s2["rd"].device)
    r_p, r_n = _surface_frame(rres, s2["rd"])
    r_mats = _mat_lookup(materials, rres.triangle.metadata.to(torch.int32))
    r_color = _direct(r_p, r_n, r_mats.base_color, lights, cfg.ambient)
    r_color = torch.where(rres.hit[:, None], r_color, bg)

    mats = s2["mats"]
    m = mats.metallic[:, None]
    color = torch.where(s2["refl_active"][:, None],
                        s2["color"] * (1 - m)
                        + r_color * mats.base_color * m,
                        s2["color"])
    img = color.reshape(H, W, spp, 3).mean(dim=2)
    return torch.clamp(img, 0.0, 1.0)


def _query(fn, scene, rays, cfg):
    """One query through dispatch at the config's tile size."""
    return fn(scene, rays, tile_size=cfg.tile_size)


def _frame(scene, materials, lights, cam, gen, cfg):
    gen = _generator(gen, _scene_device(scene))
    rays = generate_primary_rays(cam, cfg.width, cfg.height, cfg.spp, gen)
    res = _query(_disp.scene_closest_hit, scene, rays, cfg)
    s = _shadow_setup_core(rays, res, materials, lights, cfg)
    occl = _query(_disp.scene_any_hit, scene,
                  Ray.create(s["so"], s["sd"], t_max=s["st"]), cfg)
    s2 = _shade_reflect_core(rays, occl.hit, s, gen, lights, cfg)
    rres = _query(_disp.scene_closest_hit, scene, Ray.create(
        s2["ro_c"], s2["rd_c"],
        t_max=torch.where(s2["act_c"], torch.inf, -1.0)), cfg)
    return _blend_core(rres, s2, materials, lights, cfg)


def render_step(scene, materials: Materials, lights: PointLights,
                cam: Camera, gen, cfg: RenderConfig):
    """One full wavefront frame -> (H, W, 3) image. The JAX package runs
    it as one jit whose queries take its in-jit engines; here it is the
    same eager stages as ``render_staged``, and every query takes
    dispatch's engine for the scene form and batch size."""
    return _frame(scene, materials, lights, cam, gen, cfg)


def render_staged(scene, materials: Materials, lights: PointLights,
                  cam: Camera, gen, cfg: RenderConfig,
                  pipelined: bool = False):
    """The frame of ``render_step`` with its three queries between the
    glue stages, each routed by dispatch. ``pipelined`` is accepted and
    ignored: the JAX package overlaps a query's finalize with the next
    glue stage, but every port query syncs before it returns, so the
    pipelined frame is the per-query frame."""
    return _frame(scene, materials, lights, cam, gen, cfg)


class WavefrontRenderer:
    """Holds the frozen scene + materials + lights + config;
    ``render(gen)`` runs the full pipeline. ``staged`` selects
    ``render_staged`` (default) or ``render_step``, as in the JAX
    package; here both run the same stages, and ``pipelined`` is
    accepted and ignored (``render_staged``)."""

    def __init__(self, scene, materials: Materials, lights: PointLights,
                 camera: Camera, config: Optional[RenderConfig] = None,
                 staged: bool = True, pipelined: bool = False):
        self.scene = scene
        self.materials = materials
        self.lights = lights
        self.camera = camera
        self.config = config or RenderConfig()
        self.staged = staged

    def render(self, gen=None) -> torch.Tensor:
        """One frame; ``gen`` None is a generator seeded 0 on the scene's
        device."""
        if self.staged:
            return render_staged(self.scene, self.materials, self.lights,
                                 self.camera, gen, self.config)
        return render_step(self.scene, self.materials, self.lights,
                           self.camera, gen, self.config)
