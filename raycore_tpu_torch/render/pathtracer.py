"""Multi-bounce wavefront path tracer with ray compaction (counterpart of
``raycore_tpu/render/pathtracer.py``).

N-bounce wavefront over SoA queues: every bounce is
  closest hit -> surface frame and next-event shadow ray -> occlusion ->
  shade, sample the BRDF -> compact (dead lanes last, live lanes by
  direction octant then origin Morton code)
with diffuse/metallic materials and an optional textured albedo from a
``TexturePool``.

``trace_paths`` (one jit in the JAX package, whose queries there take its
in-jit engines) and ``trace_paths_staged`` share one frame function here:
eager glue stages with every query routed by ``accel/dispatch.py``, so
their hits meet the engine contract against the JAX package's.
``trace_paths`` honours ``cfg.compact``; the staged drivers always sort.

Random draws: a ``torch.Generator`` per frame (``None``: one seeded 0 on
the scene's device). The primary rays' jitter comes from
``wavefront._pixel_jitter``, each bounce's draws from ``_bounce_draws``,
indexed by original path id and then permuted by the accumulated
compaction order, so compaction never changes a path's randoms.

Tracing (``utils/config.py:span``, entered only while a profiler
records): a frame runs in ``raycore.render``; inside it
``raycore.render.primary`` (camera rays and the paths' state), then per
bounce ``.draws``, the closest query (``raycore.closest_hit``), ``.nee``
(the surface frame and the shadow rays), the occlusion query
(``raycore.any_hit``), ``.shade`` (next-event shading and the BRDF
sample) and, but on the last bounce, ``.compact`` (the sort key, its
stable argsort and the gathers); last ``.image`` (the un-permute, the
sample mean and the clamp). The glue adds no host sync to its queries'.
Counters on ``_frames``, over every frame of the process: ``frames``,
``queries`` and ``rays`` (the rays submitted to the queries) as host
ints, and ``live``, the live lanes submitted to the closest queries,
summed on the device without a host sync (a tensor once a frame ran);
a caller reads it after the fact.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..accel import dispatch as _disp
from ..accel.morton import morton_code_30bit
from ..collections.multitypeset import TexturePool, sample_nearest
from ..core.ray import Ray
from ..core.sampling import cosine_sample_hemisphere, reflect
from ..core.triangle import bary_interp
from ..utils.config import span
from .wavefront import (Camera, Materials, PointLights, _background,
                        _generator, _query, _scene_device, _unit_normal,
                        generate_primary_rays)


@dataclasses.dataclass(frozen=True)
class PTConfig:
    width: int = 256
    height: int = 256
    spp: int = 1
    bounces: int = 4
    tile_size: int = 2048
    eps: float = 1e-3
    background: tuple = (0.03, 0.04, 0.07)
    compact: bool = True


def _bounce_draws(gen, R: int, n_lights: int, device):
    """One bounce's draws for R paths in original path order: the light
    index (R,), the BRDF uniforms (R, 3) and the roughness normals
    (R, 3)."""
    u_l = torch.randint(0, n_lights, (R,), generator=gen, device=device)
    u_b = torch.rand((R, 3), generator=gen, device=device)
    u_r = torch.randn((R, 3), generator=gen, device=device)
    return u_l, u_b, u_r


def _shading_basis(n):
    """Orthonormal frame with n as +z (branch-free)."""
    s = torch.where(n[:, 2:3] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2:3])
    b = n[:, 0:1] * n[:, 1:2] * a
    t1 = torch.cat([1.0 + s * n[:, 0:1] ** 2 * a, s * b, -s * n[:, 0:1]],
                   dim=1)
    t2 = torch.cat([b, s + n[:, 1:2] ** 2 * a, -n[:, 1:2]], dim=1)
    return t1, t2


def _albedo(materials: Materials, pool, tex_refs, mi, uv):
    base = materials.base_color[mi]
    if pool is None or tex_refs is None:
        return base
    ref = tex_refs[mi]
    texel = sample_nearest(pool, torch.clamp(ref, min=0), uv)[:, :3]
    return torch.where((ref >= 0)[:, None], texel, base)


def _pt_prep_nee(res_hit, res_bary, res_verts, res_norms, res_uv, res_meta,
                 d, alive, materials, lights, u_l, eps, pool, tex_refs):
    """After closest-hit: surface frame + next-event shadow-ray setup."""
    hit = res_hit & alive
    p = bary_interp(res_bary, res_verts)
    n = _unit_normal(bary_interp(res_bary, res_norms))
    n = torch.where((n * d).sum(-1, keepdim=True) > 0, -n, n)
    uv_hit = bary_interp(res_bary, res_uv)
    mi = res_meta.to(torch.int32).long().clamp(
        0, materials.base_color.shape[0] - 1)
    base = _albedo(materials, pool, tex_refs, mi, uv_hit)
    to_l = lights.position[u_l] - p
    dist = torch.linalg.norm(to_l, dim=-1)
    wi = to_l / torch.clamp(dist[:, None], min=1e-12)
    so = p + n * eps
    st = torch.where(hit, dist - 2 * eps, -1.0)
    return hit, p, n, base, mi, wi, dist, so, st


def _sort_key(o, d, alive, root_aabb):
    """The compaction key, in int64: dead lanes last, then the direction
    octant, then the top 27 bits of the origin's Morton code."""
    lo_w = root_aabb[0]
    ext_w = torch.clamp(root_aabb[1] - lo_w, min=1e-12)
    code = morton_code_30bit(torch.clamp((o - lo_w) / ext_w, 0.0, 1.0))
    octant = ((d[:, 0] > 0).long() | ((d[:, 1] > 0).long() << 1)
              | ((d[:, 2] > 0).long() << 2))
    return ((~alive).long() << 31) | (octant << 28) | (code >> 3)


def _pt_shade_and_sample(hit, res_hit, p, n, base, mi, wi, dist, occ_hit,
                         o, d, throughput, radiance, alive, order_acc,
                         materials, lights, u_l, u_b, u_r, root_aabb,
                         bg, eps, *, n_lights: int, last: bool,
                         compact: bool = True):
    """Next-event shading, BRDF sampling and the coherence-sorting
    compaction (skipped with ``compact=False``)."""
    with span("raycore.render.shade"):
        radiance = radiance + torch.where((alive & ~res_hit)[:, None],
                                          throughput * bg, 0.0)
        metal = materials.metallic[mi]
        rough = materials.roughness[mi]
        lint = lights.intensity[u_l]
        ndotl = torch.clamp((n * wi).sum(-1), min=0.0)
        f_d = base / math.pi * (1.0 - metal)[:, None]
        contrib = f_d * lint * (ndotl * (~occ_hit) * float(n_lights)
                                / torch.clamp(dist ** 2, min=1e-12))[:, None]
        radiance = radiance + torch.where(hit[:, None], throughput * contrib,
                                          0.0)
        if last:
            return o, d, throughput, radiance, alive, order_acc

        # BRDF sample: mirror with probability metallic, else cosine
        # diffuse.
        pick_spec = u_b[:, 0] < metal
        t1, t2 = _shading_basis(n)
        local = cosine_sample_hemisphere(u_b[:, 1:3])
        d_diff = t1 * local[:, 0:1] + t2 * local[:, 1:2] + n * local[:, 2:3]
        d_spec = reflect(-d, n) + u_r * rough[:, None] * 0.25
        d_spec = d_spec / torch.clamp(torch.linalg.norm(
            d_spec, dim=-1, keepdim=True), min=1e-12)
        d = torch.where(pick_spec[:, None], d_spec, d_diff)
        throughput = throughput * base
        o = p + n * eps
        alive = hit
        if not compact:
            return o, d, throughput, radiance, alive, order_acc
    with span("raycore.render.compact"):
        order = torch.argsort(_sort_key(o, d, alive, root_aabb), stable=True)
        return (o[order], d[order], throughput[order], radiance[order],
                alive[order], order_acc[order])


def _image(radiance, order_acc, F: int, H: int, W: int, spp: int):
    """The paths' radiance back in path order (the inverse of the
    accumulated compaction order), each pixel's sample mean, clamped to
    [0, 1] -> (F, H, W, 3)."""
    radiance = radiance[torch.argsort(order_acc, stable=True)]
    img = radiance.reshape(F, H, W, spp, 3).mean(dim=3)
    return torch.clamp(img, 0.0, 1.0)


def _frames(scene, materials, lights, cam, gens, cfg, pool, tex_refs,
            compact: bool):
    """F = len(gens) frames riding every query as one F*R-ray batch ->
    (F, H, W, 3) images. Counts ``_frames.frames``, ``.queries``, ``.rays``
    and ``.live`` (module docstring)."""
    H, W, spp, B = cfg.height, cfg.width, cfg.spp, cfg.bounces
    R = H * W * spp
    dev = _scene_device(scene)
    with span("raycore.render"):
        gens = [_generator(g, dev) for g in gens]
        RT = len(gens) * R
        n_lights = lights.position.shape[0]
        with span("raycore.render.primary"):
            bg = _background(cfg.background, dev)
            prim = [generate_primary_rays(cam, W, H, spp, g) for g in gens]
            o = torch.cat([r.o for r in prim])
            d = torch.cat([r.d for r in prim])
            throughput = torch.ones((RT, 3), device=dev)
            radiance = torch.zeros((RT, 3), device=dev)
            alive = torch.ones((RT,), dtype=torch.bool, device=dev)
            order_acc = torch.arange(RT, device=dev)

        for bounce in range(B):
            with span("raycore.render.draws"):
                draws = [_bounce_draws(g, R, n_lights, dev) for g in gens]
                # Each path's draws by its ORIGINAL id (frame-major), then
                # the accumulated compaction permutation.
                u_l, u_b, u_r = (torch.cat(list(col))[order_acc]
                                 for col in zip(*draws))
            _frames.live = _frames.live + alive.sum()
            _frames.queries += 2
            _frames.rays += 2 * RT
            res = _query(_disp.scene_closest_hit, scene, Ray.create(
                o, d, t_max=torch.where(alive, torch.inf, -1.0)), cfg)
            with span("raycore.render.nee"):
                hit, p, n, base, mi, wi, dist, so, st = _pt_prep_nee(
                    res.hit, res.barycentric, res.triangle.vertices,
                    res.triangle.normals, res.triangle.uv,
                    res.triangle.metadata, d, alive, materials, lights, u_l,
                    cfg.eps, pool, tex_refs)
                shadow = Ray.create(so, wi, t_max=st)
            occ = _query(_disp.scene_any_hit, scene, shadow, cfg)
            o, d, throughput, radiance, alive, order_acc = \
                _pt_shade_and_sample(
                    hit, res.hit, p, n, base, mi, wi, dist, occ.hit, o, d,
                    throughput, radiance, alive, order_acc, materials,
                    lights, u_l, u_b, u_r, scene.root_aabb, bg, cfg.eps,
                    n_lights=n_lights, last=(bounce == B - 1),
                    compact=compact)

        with span("raycore.render.image"):
            img = _image(radiance, order_acc, len(gens), H, W, spp)
        _frames.frames += len(gens)
    return img


_frames.frames = 0
_frames.queries = 0
_frames.rays = 0
_frames.live = 0


def trace_paths(scene, materials: Materials, lights: PointLights,
                cam: Camera, gen, cfg: PTConfig, pool: TexturePool = None,
                tex_refs=None):
    """One frame of N-bounce path tracing -> (H, W, 3). A single jit in
    the JAX package; here the staged drivers' frame function with
    ``cfg.compact`` honoured, every query taking dispatch's engine."""
    return _frames(scene, materials, lights, cam, [gen], cfg, pool,
                   tex_refs, cfg.compact)[0]


def trace_paths_staged(scene, materials: Materials, lights: PointLights,
                       cam: Camera, gen, cfg: PTConfig,
                       pool: TexturePool = None, tex_refs=None,
                       pipelined: bool = False):
    """One frame of N-bounce path tracing with compaction every bounce
    -> (H, W, 3): ``trace_paths_staged_batch`` with one generator
    (``pipelined`` accepted and ignored, as there)."""
    return trace_paths_staged_batch(scene, materials, lights, cam, [gen],
                                    cfg, pool=pool, tex_refs=tex_refs)[0]


def trace_paths_staged_batch(scene, materials: Materials,
                             lights: PointLights, cam: Camera, gens,
                             cfg: PTConfig, pool: TexturePool = None,
                             tex_refs=None, pipelined: bool = False):
    """F independent frames, one generator each, riding every query as
    one concatenated F*R-ray batch -> (F, H, W, 3). Each frame samples
    the same paths as a solo ``trace_paths_staged`` call with its own
    generator (draws are indexed by original path id, so the cross-frame
    compaction never changes a path's randoms). ``pipelined`` is
    accepted and ignored: every port query syncs before it returns, so
    the pipelined batch is the per-query batch. Raises ValueError on an
    empty ``gens``."""
    gens = list(gens)
    if not gens:
        raise ValueError("trace_paths_staged_batch needs at least one "
                         "generator (one per frame)")
    return _frames(scene, materials, lights, cam, gens, cfg, pool, tex_refs,
                   True)
