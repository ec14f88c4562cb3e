"""Sampling and shading-frame math (counterpart of
``raycore_tpu/core/sampling.py``).

Float32 tensors throughout; results stay on their inputs' device. The two
functions that draw random numbers take a ``torch.Generator`` where the
JAX package takes a PRNG key; ``None`` means a generator seeded 0 on the
inputs' device. Their draws come from ``_uniform``, the module's one
source of random numbers.
"""
from __future__ import annotations

import math

import torch

from .device import as_f32

PI = math.pi


def _uniform(gen, shape, device) -> torch.Tensor:
    """Float32 uniforms in [0, 1) of ``shape`` on ``device``."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=gen, device=device)


def _stack(*xs):
    return torch.stack(xs, dim=-1)


def concentric_sample_disk(u):
    """Map [0,1]^2 uniforms to the unit disk, concentric mapping."""
    u = as_f32(u)
    offset = 2.0 * u - 1.0
    ox, oy = offset[..., 0], offset[..., 1]
    degenerate = (ox == 0.0) & (oy == 0.0)
    use_x = ox.abs() > oy.abs()
    safe = lambda x: torch.where(x == 0.0, 1.0, x)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, (oy / safe(ox)) * (PI / 4.0),
                        PI / 2.0 - (ox / safe(oy)) * (PI / 4.0))
    p = r[..., None] * _stack(torch.cos(theta), torch.sin(theta))
    return torch.where(degenerate[..., None], 0.0, p)


def cosine_sample_hemisphere(u):
    """Cosine-weighted hemisphere about +z."""
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                               min=0.0))
    return _stack(d[..., 0], d[..., 1], z)


def uniform_sample_sphere(u):
    u = as_f32(u)
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return _stack(r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_sample_cone(u, cos_theta_max, x=None, y=None, z=None):
    """Uniform direction within a cone about +z, or about frame (x,y,z)."""
    u = as_f32(u)
    cos_t = 1.0 - u[..., 0] + u[..., 0] * cos_theta_max
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
    phi = u[..., 1] * 2.0 * PI
    if x is None:
        return _stack(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t)
    return (x * (torch.cos(phi) * sin_t)[..., None]
            + y * (torch.sin(phi) * sin_t)[..., None]
            + z * cos_t[..., None])


def uniform_sphere_pdf():
    return 1.0 / (4.0 * PI)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def sum_mul(a, b):
    """sum_i a[..., i] * b[..., i, :]: a barycentric combination of a
    stack of three vectors (elementwise, never a matrix product)."""
    a, b = as_f32(a), as_f32(b)
    return (a[..., :, None] * b).sum(dim=-2)


# -- shading frame trig (normal = +z) ----------------------------------------

def cos_theta(w):
    return w[..., 2]


def sin_theta2(w):
    return torch.clamp(1.0 - cos_theta(w) ** 2, min=0.0)


def sin_theta(w):
    return torch.sqrt(sin_theta2(w))


def tan_theta(w):
    return sin_theta(w) / cos_theta(w)


def cos_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 1.0, torch.clamp(
        w[..., 0] / torch.where(st == 0, 1.0, st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 1.0, torch.clamp(
        w[..., 1] / torch.where(st == 0, 1.0, st), -1.0, 1.0))


def reflect(wo, n):
    """Reflect wo about n: -wo + 2(wo.n)n."""
    wo, n = as_f32(wo), as_f32(n)
    return -wo + 2.0 * (wo * n).sum(dim=-1, keepdim=True) * n


def coordinate_system(v1):
    """Orthonormal frame from one vector. Returns (v1, v2, v3)."""
    v1 = as_f32(v1)
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = x.abs() > y.abs()
    inv = 1.0 / torch.sqrt(torch.where(use_x, x * x + z * z, y * y + z * z))
    zero = torch.zeros_like(x)
    v2 = torch.where(use_x[..., None], _stack(-z * inv, zero, x * inv),
                     _stack(zero, z * inv, -y * inv))
    return v1, v2, torch.linalg.cross(v1, v2)


def spherical_direction(sin_t, cos_t, phi, x=None, y=None, z=None):
    if x is None:
        return _stack(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    return (x * (sin_t * torch.cos(phi))[..., None]
            + y * (sin_t * torch.sin(phi))[..., None] + z * cos_t[..., None])


def spherical_theta(v):
    return torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0, p + 2.0 * PI, p)


def face_forward(n, v):
    """Flip n into the hemisphere of v."""
    return torch.where((n * v).sum(dim=-1, keepdim=True) < 0, -n, n)


def random_hemisphere_uniform(gen, n, u, v):
    """Uniform-cosine(theta in [0,1]) hemisphere sample in frame (u, v, n),
    one per leading index of ``n``, drawn from ``gen``."""
    xi = _uniform(gen, n.shape[:-1] + (2,), n.device)
    theta = torch.arccos(xi[..., 0])
    phi = 2.0 * PI * xi[..., 1]
    xl = torch.sin(theta) * torch.cos(phi)
    yl = torch.sin(theta) * torch.sin(phi)
    zl = torch.cos(theta)
    return u * xl[..., None] + v * yl[..., None] + n * zl[..., None]


def get_orthogonal_basis(normal):
    """(u, v) orthonormal and perpendicular to normal; the cardinal axis
    of the smallest |component| seeds it (the first on ties)."""
    normal = as_f32(normal)
    n = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    idx = torch.argmin(normal.abs(), dim=-1)
    cand = torch.nn.functional.one_hot(idx, 3).to(torch.float32)
    v = torch.linalg.cross(n, cand)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    u = torch.linalg.cross(v, n)
    u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    return u, v


def random_triangle_point(gen, vertices):
    """Uniform point on a triangle via sqrt-barycentric mapping, one per
    leading index of ``vertices`` (..., 3, 3), drawn from ``gen``."""
    vertices = as_f32(vertices)
    r = _uniform(gen, vertices.shape[:-2] + (2,), vertices.device)
    sqrt_r1 = torch.sqrt(r[..., 0])
    u = 1.0 - sqrt_r1
    v = sqrt_r1 * (1.0 - r[..., 1])
    w = sqrt_r1 * r[..., 1]
    return sum_mul(_stack(u, v, w), vertices)
