"""Dense brute-force sweep for small meshes (counterpart of
``raycore_tpu/ops/pallas_brute.py``).

Every ray is tested against every triangle of a resident (9, T)
component-major table with the exact scalar Möller–Trumbore test and no
edge slack: kernel K6 (``run_brute``, ``csrc/brute_sweep.cu``), whose
plain version ``run_brute_plain`` is the brute-force oracle's sweep. For
meshes up to about 64K triangles the sweep needs no acceleration
structure at all. ``u_may_pass`` is the kernel's division-free reject and
``run_brute_model`` the plain sweep routed through it, as the kernel
sweeps.
"""
from __future__ import annotations

import torch

from ..accel.brute import HitResult, _masked_rows, closest_over
from ..core import triangle as tri
from ..kernels import _build
from .dense import INT32_MIN, _f32, flat_rays

RAY_TILE = 256
TRI_BLOCK = 512
# Consecutive rays that one warp of the kernel sweeps, and so votes over:
# 32 threads of one ray.
WARP_RAYS = 32
# The reject's margins (csrc/brute_sweep.cu:u_may_pass, which states why
# they are safe): u may pass only where -|det| 2^-20 <= su < |det| (1 +
# 2^-20), su being u's numerator with det's sign turned into its own.
U_MARGIN_LO = 2.0 ** -20
U_MARGIN_HI = 1.0 + 2.0 ** -20


def make_tri_table(tris):
    """(9, T) float32 component-major triangle table (rows v0 xyz, v1 xyz,
    v2 xyz), T padded to a whole TRI_BLOCK with zero triangles, which
    always miss."""
    v = tris.vertices
    T = v.shape[0]
    Tp = -(-T // TRI_BLOCK) * TRI_BLOCK
    table = torch.zeros((9, Tp), dtype=torch.float32, device=v.device)
    table[:, :T] = v.reshape(T, 9).T
    return table


def run_brute_plain(tri_table, o, d, t_min, t_max):
    """Each ray's closest triangle of the table by exhaustive
    ``fast_intersect_triangle`` (its cross products and dots as the
    reference's fused multiply-add chains): the smallest t wins, the
    lowest index among equal t. ``o``/``d`` (R, 3), ``t_min``/``t_max``
    (R,). Returns (t, idx, u, v) of shape (R,): t, u and v float32 (0 on a
    miss), idx int32 (-1 on a miss). Rays go through in chunks of at most
    2^24 (ray, triangle) tests."""
    T = tri_table.shape[1]
    verts = tri_table.T.reshape(T, 3, 3)
    R = o.shape[0]
    tri_chunk = 8192
    step = max(1, (1 << 24) // min(max(T, 1), tri_chunk))
    outs = []
    for lo in range(0, R, step):
        sl = slice(lo, lo + step)
        hit, t, u, v, idx = closest_over(o[sl], d[sl], t_min[sl], t_max[sl],
                                         verts, tri_chunk)
        outs.append((torch.where(hit, t, 0.0),
                     torch.where(hit, idx, -1).to(torch.int32),
                     torch.where(hit, u, 0.0), torch.where(hit, v, 0.0)))
    if not outs:
        z = torch.zeros(0, dtype=torch.float32, device=o.device)
        return z, z.to(torch.int32), z, z
    return tuple(torch.cat(x) for x in zip(*outs))


def u_may_pass(det, unum):
    """The kernel's division-free reject, elementwise on float32 det and
    u's numerator: False only where u = RN(unum * RN(1/det)) fails u >= 0
    and u <= 1 (NaN included), so the kernel skips the division there."""
    a = det.abs()
    sign = det.view(torch.int32) & INT32_MIN
    su = (unum.view(torch.int32) ^ sign).view(torch.float32)
    return (su >= -(a * _f32(U_MARGIN_LO, det.device))) \
        & (su < a * _f32(U_MARGIN_HI, det.device))


def pair_tests(o, d, t_min, t_max, verts):
    """The exact test of rays (R, 3) against triangles (T, 3, 3) as the
    kernel evaluates it, with its reject: (hit, t, u, v, may), each (R, T);
    hit only where may."""
    v0 = verts[:, 0]
    e1, e2 = verts[:, 1] - v0, verts[:, 2] - v0
    dc = d[:, None]
    s1 = tri.cross(dc, e2)
    det = tri.dot3(s1, e1)
    p = o[:, None] - v0
    unum = tri.dot3(p, s1)
    may = u_may_pass(det, unum)
    invd = 1.0 / det
    u = unum * invd
    s2 = tri.cross(p, e1)
    v = tri.dot3(dc, s2) * invd
    t = tri.dot3(e2, s2) * invd
    hit = may & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= t_min[:, None]) & (t <= t_max[:, None])
    return hit, t, u, v, may


def run_brute_model(tri_table, o, d, t_min, t_max, ray_chunk=256):
    """``run_brute_plain`` with every test first put to ``u_may_pass``, as
    the kernel sweeps: a refused test hits nothing. Equal to
    ``run_brute_plain`` bit for bit where the reject never refuses a test
    that the exact path accepts. Returns (t, idx, u, v) as it does."""
    T = tri_table.shape[1]
    verts = tri_table.T.reshape(T, 3, 3)
    cols = torch.arange(T, device=o.device)
    outs = []
    for lo in range(0, o.shape[0], ray_chunk):
        sl = slice(lo, lo + ray_chunk)
        hit, t, u, v, _ = pair_tests(o[sl], d[sl], t_min[sl], t_max[sl],
                                     verts)
        tk = torch.where(hit, t, float("inf"))
        best = tk.amin(1, keepdim=True)
        idx = torch.where(hit & (tk == best), cols, T).amin(1)
        h = idx < T
        take = lambda a: a.gather(1, idx.clamp_max(T - 1)[:, None])[:, 0]
        outs.append((torch.where(h, take(t), 0.0),
                     torch.where(h, idx, -1).to(torch.int32),
                     torch.where(h, take(u), 0.0),
                     torch.where(h, take(v), 0.0)))
    if not outs:
        z = torch.zeros(0, dtype=torch.float32, device=o.device)
        return z, z.to(torch.int32), z, z
    return tuple(torch.cat(x) for x in zip(*outs))


def run_brute(tri_table, o, d, t_min, t_max):
    """Kernel K6 (``csrc/brute_sweep.cu``): ``run_brute_plain`` on the card,
    bit for bit. Any R and T. CPU tensors take
    ``run_brute_plain``; CUDA tensors launch the kernel or raise."""
    if tri_table.device.type == "cpu":
        return run_brute_plain(tri_table, o, d, t_min, t_max)
    dev = tri_table.device
    _build.require(tri_table, torch.float32, "tri_table", dev)
    for name, a in (("o", o), ("d", d), ("t_min", t_min), ("t_max", t_max)):
        _build.require(a, torch.float32, name, dev)
    R, T = o.shape[0], tri_table.shape[1]
    if tri_table.shape[0] != 9 or tuple(o.shape) != (R, 3) \
            or tuple(d.shape) != (R, 3) or tuple(t_min.shape) != (R,) \
            or tuple(t_max.shape) != (R,):
        raise ValueError(
            f"brute sweep shapes: tri_table {tuple(tri_table.shape)} must be "
            f"(9, T), o {tuple(o.shape)} and d {tuple(d.shape)} (R, 3), "
            f"t_min {tuple(t_min.shape)} and t_max {tuple(t_max.shape)} (R,)")
    t = torch.empty(R, dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if R == 0:
        return t, idx, u, v
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.raycore_brute_sweep(
            tri_table.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), t.data_ptr(), idx.data_ptr(),
            u.data_ptr(), v.data_ptr(), R, T, _build.stream_ptr(tri_table))
    _build.check(err, "brute_sweep")
    run_brute.launches += 1
    return t, idx, u, v


run_brute.launches = 0


def _pad_to(a, n, fill):
    """``a`` extended to n rows of ``fill``, always a fresh contiguous
    tensor (a view may be unaligned for the kernel)."""
    if a.shape[0] == n:
        return a.clone(memory_format=torch.contiguous_format)
    return torch.cat([a, torch.full((n - a.shape[0],) + tuple(a.shape[1:]),
                                    fill, dtype=a.dtype, device=a.device)])


def closest_hit_brute_pallas(tris, rays, *, tri_table=None) -> HitResult:
    """Dense closest hit over every triangle (kernel K6); the same
    ``HitResult`` contract as the other paths: barycentric (1-u-v, u, v),
    instance 0, and zeros and -1 on a miss. Precompute
    ``tri_table=make_tri_table(tris)`` to amortize the table."""
    if tri_table is None:
        tri_table = make_tri_table(tris)
    batch = rays.batch_shape
    o, d, t_min, t_max = flat_rays(rays)
    R = o.shape[0]
    Rp = -(-R // RAY_TILE) * RAY_TILE
    t, idx, u, v = run_brute(tri_table, _pad_to(o, Rp, 0.0),
                             _pad_to(d, Rp, 1.0), _pad_to(t_min, Rp, 0.0),
                             _pad_to(t_max, Rp, -1.0))
    t, idx, u, v = (x[:R] for x in (t, idx, u, v))
    hit = idx >= 0
    bary = torch.where(hit[:, None], torch.stack([1 - u - v, u, v], -1), 0.0)
    res = HitResult(hit=hit,
                    triangle=_masked_rows(tris, idx.clamp_min(0).long(), hit),
                    t=t, barycentric=bary,
                    prim_idx=torch.where(hit, idx, -1),
                    instance_idx=torch.where(hit, 0, -1).to(torch.int32))
    return res.map(lambda a: a.reshape(batch + tuple(a.shape[1:])))
