"""Affine transformations, quaternions and row-major 3x4 instance
transforms (counterpart of ``raycore_tpu/core/transforms.py``).

A ``Transformation`` carries a 4x4 matrix and its inverse, with any
leading batch dimensions. Instance transforms are (..., 3, 4) row-major
affine matrices: ``world = M[:, :3] @ p + M[:, 3]``.

Every small matrix product here is an elementwise multiply and sum in
float32, never ``torch.matmul``: a product on the card could take the
TF32 tensor cores, which would round the geometry. Constructors that take
no tensor (``Transformation.identity``, ``translate``, ``look_at``, ...)
take ``device``, the CUDA card by default; the other functions keep
their inputs' device.
"""
from __future__ import annotations

import dataclasses

import torch

from . import bounds as _bounds
from .device import as_f32, default_device
from .ray import Ray, RayDifferentials
from .triangle import cross as _fused_cross
from .triangle import dot3 as _fused_dot3


def _apply_mat3(R, p):
    """R @ p over the last axes as an elementwise multiply and sum."""
    return (R * p[..., None, :]).sum(dim=-1)


def _apply_mat3_fused(R, p):
    """R @ p over the last axes, each row's dot as the fused chain
    fma(r2, p2, fma(r1, p1, r0*p0)) (``core/triangle.py:dot3``): what the
    JAX package's compiled programs compute for ``_apply_mat3``, whose
    products its compiler fuses into the sum. The instance tables
    (``accel/tlas_build.py``, ``scene/instanced.py``) and the instanced
    engine's local rays use it, so they equal the reference's bits."""
    return _fused_dot3(R, p[..., None, :])


def _matmul(a, b):
    """a @ b over the last two axes as an elementwise multiply and sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _eye(n, batch_shape, device, m=None):
    eye = torch.eye(n, m or n, dtype=torch.float32, device=device)
    return eye.expand(tuple(batch_shape) + eye.shape)


@dataclasses.dataclass
class Transformation:
    m: torch.Tensor      # (..., 4, 4) float32
    m_inv: torch.Tensor  # (..., 4, 4) float32

    @classmethod
    def identity(cls, batch_shape=(), device=None) -> "Transformation":
        eye = _eye(4, batch_shape, default_device(device))
        return cls(m=eye, m_inv=eye)

    @classmethod
    def from_matrix(cls, m, device=None) -> "Transformation":
        """A matrix and its inverse (``torch.linalg.inv``); ``device`` as
        in ``as_f32``."""
        m = as_f32(m, device)
        return cls(m=m, m_inv=torch.linalg.inv(m))

    def inverse(self) -> "Transformation":
        return Transformation(m=self.m_inv, m_inv=self.m)

    def transpose(self) -> "Transformation":
        return Transformation(m=self.m.transpose(-1, -2),
                              m_inv=self.m_inv.transpose(-1, -2))

    def compose(self, other: "Transformation") -> "Transformation":
        """self after other: ``other`` applies first; the inverses compose
        in the reverse order."""
        return Transformation(m=_matmul(self.m, other.m),
                              m_inv=_matmul(other.m_inv, self.m_inv))

    def __matmul__(self, other):
        if isinstance(other, Transformation):
            return self.compose(other)
        return NotImplemented

    def apply_point(self, p):
        """The transformed point, divided by its w."""
        p = as_f32(p, self.m.device)
        r = _apply_mat3(self.m[..., :3, :3], p) + self.m[..., :3, 3]
        w = (self.m[..., 3, :3] * p).sum(dim=-1) + self.m[..., 3, 3]
        return r / w[..., None]

    def apply_vector(self, v):
        return _apply_mat3(self.m[..., :3, :3], as_f32(v, self.m.device))

    def apply_normal(self, n):
        """Normals transform by the inverse transpose."""
        n = as_f32(n, self.m.device)
        return (self.m_inv[..., :3, :3] * n[..., :, None]).sum(dim=-2)

    def apply_bounds(self, b: _bounds.Bounds3) -> _bounds.Bounds3:
        """The box of the 8 transformed corners."""
        tc = self.apply_point(_bounds.corners(b))       # (..., 8, 3)
        return _bounds.Bounds3(p_min=tc.amin(dim=-2), p_max=tc.amax(dim=-2))

    def apply_ray(self, r):
        if isinstance(r, RayDifferentials):
            return dataclasses.replace(
                r, o=self.apply_point(r.o), d=self.apply_vector(r.d),
                rx_origin=self.apply_point(r.rx_origin),
                ry_origin=self.apply_point(r.ry_origin),
                rx_direction=self.apply_vector(r.rx_direction),
                ry_direction=self.apply_vector(r.ry_direction))
        return dataclasses.replace(r, o=self.apply_point(r.o),
                                   d=self.apply_vector(r.d))

    def __call__(self, x):
        if isinstance(x, _bounds.Bounds3):
            return self.apply_bounds(x)
        if isinstance(x, (Ray, RayDifferentials)):
            return self.apply_ray(x)
        return self.apply_point(x)


# --- constructors ------------------------------------------------------------

def _affine(m3, t):
    m = torch.zeros(tuple(t.shape[:-1]) + (4, 4), dtype=torch.float32,
                    device=t.device)
    m[..., :3, :3] = m3
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def translate(delta, device=None) -> Transformation:
    delta = as_f32(delta, device)
    eye = _eye(3, delta.shape[:-1], delta.device)
    return Transformation(m=_affine(eye, delta), m_inv=_affine(eye, -delta))


def scale(s, device=None) -> Transformation:
    """Scale by s per axis (a scalar scales all three)."""
    s = as_f32(s, device)
    if s.ndim == 0:
        s = s.expand(3)
    eye = torch.eye(3, dtype=torch.float32, device=s.device)
    z = torch.zeros(tuple(s.shape[:-1]) + (3,), device=s.device)
    return Transformation(m=_affine(s[..., None, :] * eye, z),
                          m_inv=_affine((1.0 / s)[..., None, :] * eye, z))


def _rot_axis(theta, i, j):
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(4, theta.shape, theta.device).clone()
    m[..., i, i] = c
    m[..., i, j] = -s
    m[..., j, i] = s
    m[..., j, j] = c
    return Transformation(m=m, m_inv=m.transpose(-1, -2))


def _radians(theta_deg, device):
    return torch.deg2rad(as_f32(theta_deg, device))


def rotate_x(theta_deg, device=None):
    return _rot_axis(_radians(theta_deg, device), 1, 2)


def rotate_y(theta_deg, device=None):
    return _rot_axis(_radians(theta_deg, device), 2, 0)


def rotate_z(theta_deg, device=None):
    return _rot_axis(_radians(theta_deg, device), 0, 1)


def rotate(theta_deg, axis, device=None) -> Transformation:
    """Rotation by theta degrees about an arbitrary axis (Rodrigues)."""
    theta = _radians(theta_deg, device)
    a = as_f32(axis, device if device is not None else theta.device)
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    c, s = torch.cos(theta), torch.sin(theta)
    x, y, z = a.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, dtype=torch.float32, device=a.device)
    m3 = eye + s[..., None, None] * K \
        + (1 - c)[..., None, None] * _matmul(K, K)
    m = _affine(m3, torch.zeros(tuple(a.shape[:-1]) + (3,), device=a.device))
    return Transformation(m=m, m_inv=m.transpose(-1, -2))


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def look_at(position, target, up, device=None) -> Transformation:
    """The camera-to-world transform of a camera at ``position`` looking
    at ``target``."""
    position = as_f32(position, device)
    target = as_f32(target, position.device)
    up = as_f32(up, position.device)
    z = _unit(target - position)
    x = _unit(torch.linalg.cross(_unit(up), z))
    y = torch.linalg.cross(z, x)
    m = _affine(torch.stack([x, y, z], dim=-1), position)
    return Transformation(m=m, m_inv=torch.linalg.inv(m))


def perspective(fov_deg, near, far, device=None) -> Transformation:
    """Perspective projection with a field of view of ``fov_deg``."""
    fov = as_f32(fov_deg, device)
    near, far = as_f32(near, fov.device), as_f32(far, fov.device)
    persp = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 0],
                          [0, 0, 1, 0]], dtype=torch.float32,
                         device=fov.device)
    persp[2, 2] = far / (far - near)
    persp[2, 3] = -far * near / (far - near)
    inv_tan = 1.0 / torch.tan(torch.deg2rad(fov) / 2.0)
    one = torch.ones((), device=fov.device)
    return scale(torch.stack([inv_tan, inv_tan, one])).compose(
        Transformation.from_matrix(persp))


def has_scale(t: Transformation, eps=1e-4):
    """Whether the transform changes the length of an axis by more than
    eps (squared)."""
    m3 = t.m[..., :3, :3]
    ok = lambda v: (v > 1 - eps) & (v < 1 + eps)
    la, lb, lc = ((m3[..., :, k] ** 2).sum(dim=-1) for k in range(3))
    return ~(ok(la) & ok(lb) & ok(lc))


def swaps_handedness(t: Transformation):
    """The upper-left 3x3 has a negative determinant."""
    return torch.linalg.det(t.m[..., :3, :3]) < 0


def is_identity(t: Transformation):
    return (t.m == torch.eye(4, dtype=torch.float32,
                             device=t.m.device)).all(dim=-1).all(dim=-1)


# --- quaternions -------------------------------------------------------------

@dataclasses.dataclass
class Quaternion:
    v: torch.Tensor  # (..., 3)
    w: torch.Tensor  # (...,)

    @classmethod
    def identity(cls, batch_shape=(), device=None) -> "Quaternion":
        device = default_device(device)
        batch_shape = tuple(batch_shape)
        return cls(v=torch.zeros(batch_shape + (3,), device=device),
                   w=torch.ones(batch_shape, device=device))

    @classmethod
    def from_transformation(cls, t: Transformation) -> "Quaternion":
        """Shepperd's extraction, every case computed and the right one
        selected: the trace case where the trace is positive, else the
        case of the largest diagonal element."""
        m = t.m
        tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
        sA = torch.sqrt(torch.clamp_min(tr + 1.0, 0.0))
        wA = 0.5 * sA
        fA = torch.where(sA > 0, 0.5 / torch.where(sA > 0, sA, 1.0), 0.0)
        vA = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) * fA,
                          (m[..., 0, 2] - m[..., 2, 0]) * fA,
                          (m[..., 1, 0] - m[..., 0, 1]) * fA], -1)

        def diag_case(i):
            j, k = (i + 1) % 3, (i + 2) % 3
            s = torch.sqrt(torch.clamp_min(
                m[..., i, i] - m[..., j, j] - m[..., k, k] + 1.0, 1e-20))
            f = 0.5 / s
            q = [None] * 3
            q[i] = 0.5 * s
            q[j] = (m[..., j, i] + m[..., i, j]) * f
            q[k] = (m[..., k, i] + m[..., i, k]) * f
            return torch.stack(q, -1), (m[..., k, j] - m[..., j, k]) * f

        diag = torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
        i_max = _bounds.first_argmax(diag)
        (v0, w0), (v1, w1), (v2, w2) = (diag_case(i) for i in range(3))
        vB = torch.where((i_max == 0)[..., None], v0,
                         torch.where((i_max == 1)[..., None], v1, v2))
        wB = torch.where(i_max == 0, w0, torch.where(i_max == 1, w1, w2))
        use_a = tr > 0
        return cls(v=torch.where(use_a[..., None], vA, vB),
                   w=torch.where(use_a, wA, wB))

    def to_transformation(self) -> Transformation:
        x, y, z = self.v.unbind(-1)
        w = self.w
        m3 = torch.stack([
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                         2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                         2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                         1 - 2 * (x * x + y * y)], -1)], -2)
        m = _affine(m3, torch.zeros(tuple(w.shape) + (3,), device=w.device))
        return Transformation(m=m, m_inv=m.transpose(-1, -2))

    def normalize(self) -> "Quaternion":
        n = torch.sqrt(dot(self, self))
        return Quaternion(v=self.v / n[..., None], w=self.w / n)


def dot(a: Quaternion, b: Quaternion):
    return (a.v * b.v).sum(dim=-1) + a.w * b.w


def slerp(t, a: Quaternion, b: Quaternion) -> Quaternion:
    """Spherical interpolation, a normalized lerp where the two are
    within about 1.8 degrees (cos > 0.9995)."""
    t = as_f32(t, a.w.device)
    cos_theta = dot(a, b)
    near = cos_theta > 0.9995
    lv = a.v + t[..., None] * (b.v - a.v)
    lw = a.w + t * (b.w - a.w)
    ln = torch.sqrt((lv * lv).sum(dim=-1) + lw * lw)
    theta_p = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0)) * t
    pv = b.v - a.v * cos_theta[..., None]
    pw = b.w - a.w * cos_theta
    pn = torch.sqrt(torch.clamp_min((pv * pv).sum(dim=-1) + pw * pw, 1e-20))
    cp, sp = torch.cos(theta_p), torch.sin(theta_p)
    sv = a.v * cp[..., None] + (pv / pn[..., None]) * sp[..., None]
    sw = a.w * cp + (pw / pn) * sp
    return Quaternion(v=torch.where(near[..., None], lv / ln[..., None], sv),
                      w=torch.where(near, lw / ln, sw))


# --- row-major 3x4 instance transforms ---------------------------------------

def mat4_to_mat3x4(m):
    """The upper three rows of a 4x4."""
    return as_f32(m)[..., :3, :4]


def mat3x4_identity(batch_shape=(), device=None):
    return _eye(3, batch_shape, default_device(device), 4)


def mat3x4_inverse(m, fused: bool = False):
    """The affine inverse of a row-major 3x4, [B | -B t] with B the
    adjugate inverse of its 3x3. The cross products are fused
    multiply-add pairs (``core/triangle.py:cross``), as the JAX package's
    ``jnp.cross`` computes them. The determinant and B t are plain
    float32 sums, as in the JAX package's eager calls, or with
    ``fused=True`` fused chains, as in its compiled ones (the TLAS
    manager's ``sync``, ``refresh_instances``)."""
    m = as_f32(m)
    R, t = m[..., :3, :3], m[..., :3, 3]
    col = lambda k: R[..., :, k]
    # Rows: col1 x col2, col2 x col0, col0 x col1, in one call.
    C = _fused_cross(torch.stack([col(1), col(2), col(0)], dim=-2),
                     torch.stack([col(2), col(0), col(1)], dim=-2))
    det = (_fused_dot3(col(0), C[..., 0, :]) if fused
           else (col(0) * C[..., 0, :]).sum(dim=-1))
    B = C / det[..., None, None]
    apply = _apply_mat3_fused if fused else _apply_mat3
    return torch.cat([B, -apply(B, t)[..., :, None]], dim=-1)


def transform_point_3x4(m, p):
    """R p + t for a row-major 3x4."""
    return _apply_mat3(m[..., :3, :3], p) + m[..., :3, 3]


def transform_direction_3x4(m, v):
    return _apply_mat3(m[..., :3, :3], v)
