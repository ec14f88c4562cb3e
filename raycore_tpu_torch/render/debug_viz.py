"""Debug visualization helpers (counterpart of
``raycore_tpu/render/debug_viz.py``): ``trace_rays`` returns plot-ready
data per ray, ``scene_preview`` renders a quick look with the wavefront
renderer, ``ray_plot`` draws the scene and the traced rays in a small
software rasteriser, and ``save_ppm``/``save_png`` write images with no
plotting stack. The rasteriser and the writers run on the host with
NumPy and zlib; the queries go through ``accel/dispatch.py``.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

from ..accel import dispatch as _disp
from ..core.ray import Ray
from ..core.sampling import sum_mul


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class RayIntersectionResult:
    """Everything a plot recipe needs per ray."""
    origins: torch.Tensor       # (N, 3)
    directions: torch.Tensor    # (N, 3)
    hits: torch.Tensor          # (N,) bool
    points: torch.Tensor        # (N, 3) hit points (0 on miss)
    t: torch.Tensor             # (N,)
    instance_idx: torch.Tensor  # (N,)
    metadata: torch.Tensor      # (N,)


def trace_rays(scene, rays: Ray, **kw) -> RayIntersectionResult:
    """A closest-hit query returning plot-ready data, flattened over the
    rays' batch shape."""
    res = _disp.scene_closest_hit(scene, rays, **kw)
    nb = len(rays.batch_shape)
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[nb:]))
    pts = sum_mul(res.barycentric, res.triangle.vertices)
    return RayIntersectionResult(
        origins=flat(rays.o), directions=flat(rays.d),
        hits=flat(res.hit), points=flat(pts), t=flat(res.t),
        instance_idx=flat(res.instance_idx),
        metadata=flat(res.triangle.metadata))


def scene_preview(scene, materials=None, lights=None, camera=None,
                  width=320, height=240, spp=1):
    """Render a quick look at a scene with default lighting and materials
    (a generator seeded 0 on the scene's device)."""
    from .wavefront import (Camera, Materials, PointLights, RenderConfig,
                            WavefrontRenderer, _scene_device)
    dev = _scene_device(scene)
    lo, hi = _host(scene.root_aabb)
    center = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))
    if camera is None:
        camera = Camera.create(
            position=center + np.array([0.8, -1.6, 0.9]) * diag,
            target=center, up=(0, 0, 1), fov_deg=45.0, device=dev)
    if lights is None:
        lights = PointLights.create(
            position=np.asarray([center + np.array([1.0, -1.0, 2.0])
                                 * diag]),
            intensity=torch.tensor([[4.0, 4.0, 4.0]], device=dev)
            * diag ** 2, device=dev)
    if materials is None:
        n_meta = min(1 + int(scene.prims.metadata.max()), 4096)
        rng = np.random.default_rng(7)
        materials = Materials.create(
            base_color=rng.uniform(0.2, 0.9, (n_meta, 3)).astype(np.float32),
            device=dev)
    r = WavefrontRenderer(scene, materials, lights, camera,
                          RenderConfig(width=width, height=height, spp=spp))
    return r.render()


# --- RayPlot recipe equivalent ----------------------------------------------
# The recipe draws the scene geometry (alpha-blended, per-metadata wong
# colors), the rays as arrows (origin -> hit point for hits in
# `ray_color`, origin + d * ray_length for misses in `miss_color`),
# markers at hit points, and optional "Hit i / d=..." labels. This is the same recipe as a
# dependency-free software renderer: the geometry pass ray-casts the scene
# once (producing color + a depth buffer), and the overlay pass projects
# the ray segments through the same pinhole camera and rasterizes them
# depth-tested against the geometry.

# Okabe-Ito palette == Makie.wong_colors() (the recipe's default
# geometry_colors).
WONG_COLORS = np.array([
    [0.0, 0.447, 0.698], [0.902, 0.624, 0.0], [0.0, 0.620, 0.451],
    [0.835, 0.369, 0.0], [0.800, 0.475, 0.655], [0.941, 0.894, 0.259],
    [0.337, 0.706, 0.914]], np.float32)

# Minimal 5x7 bitmap font for the label charset ("Hit 12 d=3.45-e+").
_FONT5x7 = {
    "0": "0E 11 13 15 19 11 0E", "1": "04 0C 04 04 04 04 0E",
    "2": "0E 11 01 02 04 08 1F", "3": "1F 02 04 02 01 11 0E",
    "4": "02 06 0A 12 1F 02 02", "5": "1F 10 1E 01 01 11 0E",
    "6": "06 08 10 1E 11 11 0E", "7": "1F 01 02 04 08 08 08",
    "8": "0E 11 11 0E 11 11 0E", "9": "0E 11 11 0F 01 02 0C",
    "H": "11 11 11 1F 11 11 11", "i": "04 00 0C 04 04 04 0E",
    "t": "08 08 1C 08 08 09 06", "d": "01 01 0D 13 11 13 0D",
    "=": "00 00 1F 00 1F 00 00", ".": "00 00 00 00 00 0C 0C",
    "-": "00 00 00 1F 00 00 00", "+": "00 04 04 1F 04 04 00",
    "e": "00 00 0E 11 1F 10 0E", " ": "00 00 00 00 00 00 00",
}


def _cam_basis(position, target, up):
    fwd = np.asarray(target, np.float64) - np.asarray(position, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    upv = np.cross(right, fwd)
    return fwd, right, upv


def _project(pts, position, fwd, right, upv, tanf, width, height):
    """World points -> (px, py, depth) through the pinhole camera."""
    v = np.asarray(pts, np.float64) - np.asarray(position, np.float64)
    z = v @ fwd
    x = (v @ right) / np.maximum(z, 1e-9) / tanf
    y = (v @ upv) / np.maximum(z, 1e-9) / tanf
    aspect = width / height
    px = (x / aspect * 0.5 + 0.5) * (width - 1)
    py = (0.5 - y * 0.5) * (height - 1)
    return px, py, z


def _draw_line(img, depth, p0, p1, z0, z1, color, alpha=1.0):
    """Depth-tested DDA segment into img (numpy, in place)."""
    h, w = depth.shape
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    ts = np.linspace(0.0, 1.0, n)
    xs = np.round(p0[0] + (p1[0] - p0[0]) * ts).astype(int)
    ys = np.round(p0[1] + (p1[1] - p0[1]) * ts).astype(int)
    zs = z0 + (z1 - z0) * ts
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h) & (zs > 1e-6)
    xs, ys, zs = xs[ok], ys[ok], zs[ok]
    vis = zs <= depth[ys, xs] * 1.002 + 1e-4
    xs, ys = xs[vis], ys[vis]
    img[ys, xs] = (1 - alpha) * img[ys, xs] + alpha * np.asarray(color)


def _draw_disc(img, depth, cx, cy, z, r, color):
    h, w = depth.shape
    x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, w)
    y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, h)
    if x0 >= x1 or y0 >= y1 or z <= 1e-6:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = ((xx - cx) ** 2 + (yy - cy) ** 2 <= r * r) \
        & (z <= depth[y0:y1, x0:x1] * 1.002 + 1e-4)
    img[y0:y1, x0:x1][m] = color


def _draw_text(img, x, y, text, color):
    h, w = img.shape[:2]
    for k, ch in enumerate(text):
        rows = _FONT5x7.get(ch)
        if rows is None:
            continue
        for ry, hexrow in enumerate(rows.split()):
            bits = int(hexrow, 16)
            for rx in range(5):
                if bits & (1 << (4 - rx)):
                    px, py = int(x) + k * 6 + rx, int(y) + ry
                    if 0 <= px < w and 0 <= py < h:
                        img[py, px] = color


def ray_plot(scene, result: RayIntersectionResult = None, *, rays: Ray = None,
             width: int = 640, height: int = 480, camera=None,
             show_geometry: bool = True, geometry_alpha: float = 0.4,
             geometry_colors=None, ray_color=(0.0, 0.6, 0.0),
             hit_color=(0.0, 0.6, 0.0), miss_color=(0.5, 0.5, 0.5),
             miss_alpha: float = 0.5, ray_length: float = 15.0,
             show_hit_points: bool = True, hit_markersize: float = 0.1,
             show_labels: bool = False, background=(1.0, 1.0, 1.0),
             **query_kw) -> np.ndarray:
    """Software RayPlot recipe.

    Renders the scene geometry (flat-shaded, per-metadata wong colors,
    alpha-blended over ``background``) plus the traced rays: hit rays as
    depth-tested segments from origin to hit point (``ray_color``), missed
    rays extended by ``ray_length`` (``miss_color``), markers at hit
    points, and optional "Hit i / d=t" labels. Returns an (H, W, 3) float
    image — pair with :func:`save_png`.

    Pass either a precomputed ``result`` (from :func:`trace_rays`) or
    ``rays`` (traced here). ``hit_markersize`` is in world units, like a
    meshscatter markersize.
    """
    if result is None:
        if rays is None:
            raise ValueError("ray_plot needs `result` or `rays`")
        result = trace_rays(scene, rays, **query_kw)
    lo, hi = _host(scene.root_aabb).astype(np.float64)
    center, diag = (lo + hi) / 2, float(np.linalg.norm(hi - lo)) or 1.0
    if camera is None:
        position = center + np.array([0.9, -1.8, 1.1]) * diag * 0.75
        target, up, fov_deg = center, (0.0, 0.0, 1.0), 45.0
    else:
        position = _host(camera.position).astype(np.float64)
        target = _host(camera.target).astype(np.float64)
        up = _host(camera.up).astype(np.float64)
        fov_deg = float(getattr(camera, "fov_deg", 45.0))
    fwd, right, upv = _cam_basis(position, target, up)
    tanf = np.tan(np.radians(fov_deg) / 2)

    img = np.broadcast_to(np.asarray(background, np.float32),
                          (height, width, 3)).copy()
    depth = np.full((height, width), np.inf)
    if show_geometry:
        aspect = width / height
        iy, ix = np.mgrid[0:height, 0:width]
        sx = (ix / (width - 1) * 2 - 1) * tanf * aspect
        sy = (0.5 - iy / (height - 1)) * 2 * tanf
        dirs = (fwd[None, None] + sx[..., None] * right[None, None]
                + sy[..., None] * upv[None, None])
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        dev = scene.root_aabb.device
        cam_rays = Ray.create(
            torch.tensor(position, dtype=torch.float32, device=dev).expand(
                height * width, 3),
            torch.tensor(dirs.reshape(-1, 3), dtype=torch.float32,
                         device=dev))
        geo = trace_rays(scene, cam_rays, **query_kw)
        ghit = _host(geo.hits).reshape(height, width)
        gt = _host(geo.t).reshape(height, width)
        meta = _host(geo.metadata).reshape(height, width).astype(int)
        pal = np.asarray(geometry_colors if geometry_colors is not None
                         else WONG_COLORS, np.float32)
        base = pal[np.abs(meta) % len(pal)]
        # Cheap n.l shading from the camera direction for depth cues.
        pts = _host(geo.points).reshape(height, width, 3)
        gx, gy = np.gradient(gt)
        shade = 1.0 / (1.0 + 2.0 * np.hypot(gx, gy) / (gt + 1e-6))
        col = base * (0.55 + 0.45 * shade[..., None])
        a = geometry_alpha
        img[ghit] = (1 - a) * img[ghit] + a * col[ghit]
        # Depth buffer in camera-z for the overlay depth test.
        depth[ghit] = ((pts - position) @ fwd)[ghit]

    o = _host(result.origins).astype(np.float64)
    dvec = _host(result.directions).astype(np.float64)
    hits = _host(result.hits)
    pts = _host(result.points).astype(np.float64)
    tvals = _host(result.t)
    ends = np.where(hits[:, None], pts, o + dvec * ray_length)
    px0, py0, z0 = _project(o, position, fwd, right, upv, tanf,
                            width, height)
    px1, py1, z1 = _project(ends, position, fwd, right, upv, tanf,
                            width, height)
    marker_px = max(hit_markersize / (diag * tanf) * height * 0.5, 2.0)
    for i in range(o.shape[0]):
        color = ray_color if hits[i] else miss_color
        alpha = 1.0 if hits[i] else miss_alpha
        _draw_line(img, depth, (px0[i], py0[i]), (px1[i], py1[i]),
                   z0[i], z1[i], color, alpha)
        # Arrowhead: a small disc at the segment end (arrows3d tip).
        _draw_disc(img, depth, px1[i], py1[i], z1[i],
                   max(marker_px * 0.5, 1.5), color)
    if show_hit_points:
        for i in np.nonzero(hits)[0]:
            _draw_disc(img, depth, px1[i], py1[i], z1[i] * 0.999,
                       marker_px, hit_color)
    if show_labels:
        for i in np.nonzero(hits)[0]:
            _draw_text(img, px1[i] + marker_px + 2, py1[i] - 4,
                       f"Hit {i + 1} d={tvals[i]:.2f}", hit_color)
    return img


def save_ppm(img, path: str):
    """Write an (H, W, 3) float image in [0,1] as binary PPM."""
    a = np.clip(_host(img), 0, 1)
    b = (a * 255 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (b.shape[1], b.shape[0]))
        f.write(b.tobytes())


def save_png(img, path: str):
    """Minimal dependency-free PNG writer for (H, W, 3) float images."""
    a = np.clip(_host(img), 0, 1)
    b = (a * 255 + 0.5).astype(np.uint8)
    h, w = b.shape[:2]
    raw = b"".join(b"\x00" + b[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
