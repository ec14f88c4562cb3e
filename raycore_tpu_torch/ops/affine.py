"""Kernel K8 (``csrc/instance_affine.cu``): the instanced frame's affine
arithmetic, the per-frame instance refresh and the instanced engine's
local rays.

Both are fused multiply-add chains, as the JAX package's compiled
programs compute them. On CPU tensors the wrappers run the plain
versions, whose fused multiply-adds are ``core/triangle.py:fma``'s
float64 emulation of the card's ``fmaf`` (exactly it, so the plain
versions are also the kernel's model); on CUDA tensors they launch K8 or
raise. An empty grid launches nothing.

Counters (function attributes): ``refresh_tables.launches``;
``local_rays.launches`` and ``local_rays.rows``, the rows transformed on
either device.
"""
from __future__ import annotations

import math

import torch

from ..accel.tlas_build import transformed_aabbs
from ..core.transforms import _apply_mat3_fused, mat3x4_inverse
from ..kernels import _build
from .dense import INT32_MAX


def _sections(shapes, like):
    """Contiguous float32 tensors of ``shapes`` carved from one
    allocation, each starting on a 16-byte boundary."""
    sizes = [math.prod(s) for s in shapes]
    starts = [0]
    for n in sizes[:-1]:
        starts.append(starts[-1] + -(-n // 4) * 4)
    buf = torch.empty((starts[-1] + sizes[-1],), dtype=torch.float32,
                      device=like.device)
    return [buf[a:a + n].view(s) for a, n, s in zip(starts, sizes, shapes)]


def _operand(t, dtype, name, dev):
    """A kernel operand: ``t`` on ``dev`` as ``dtype``, contiguous."""
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    return t.contiguous()


def refresh_tables_plain(transforms, local_min, local_max):
    """Each instance's world -> local inverse (``mat3x4_inverse`` with
    fused chains) and the world box of its local root box
    (``transformed_aabbs``). Returns (inst_inv (I, 3, 4), aabb_min (I, 3),
    aabb_max (I, 3))."""
    wmin, wmax = transformed_aabbs(transforms, local_min, local_max)
    return mat3x4_inverse(transforms, fused=True), wmin, wmax


def refresh_tables(transforms, local_min, local_max):
    """``refresh_tables_plain`` on CPU tensors; on CUDA tensors kernel K8,
    one thread an instance, bit for bit the plain version on the card
    (its min and max keep the zero that PyTorch's ``amin`` and ``amax``
    keep there). ``transforms`` (I, 3, 4), ``local_min`` and
    ``local_max`` (I, 3), float32."""
    if transforms.device.type == "cpu":
        return refresh_tables_plain(transforms, local_min, local_max)
    dev = transforms.device
    I = transforms.shape[0]
    if transforms.shape != (I, 3, 4) or local_min.shape != (I, 3) \
            or local_max.shape != (I, 3):
        raise ValueError(
            f"refresh_tables shapes: transforms {tuple(transforms.shape)}, "
            f"local_min {tuple(local_min.shape)}, local_max "
            f"{tuple(local_max.shape)}")
    tf = _operand(transforms, torch.float32, "transforms", dev)
    lo = _operand(local_min, torch.float32, "local_min", dev)
    hi = _operand(local_max, torch.float32, "local_max", dev)
    inv, wmin, wmax = _sections([(I, 3, 4), (I, 3), (I, 3)], tf)
    if I == 0:
        return inv, wmin, wmax
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.raycore_instance_refresh(
            tf.data_ptr(), lo.data_ptr(), hi.data_ptr(), inv.data_ptr(),
            wmin.data_ptr(), wmax.data_ptr(), I, _build.stream_ptr(tf))
    _build.check(err, "instance_refresh")
    refresh_tables.launches += 1
    return inv, wmin, wmax


refresh_tables.launches = 0


def _local(inv, o, d):
    """o_l = R o + t and d_l = R d through inverses (..., 3, 4) broadcast
    against rays (..., 3), each dot a fused chain."""
    R = inv[..., :3]
    return _apply_mat3_fused(R, o) + inv[..., 3], _apply_mat3_fused(R, d)


def local_rays_plain(inst_inv, inst, o, d, pairs=None):
    """Rays into their instances' local space. Ray mode (``pairs`` None):
    row r is ray r through ``inst_inv[max(inst[r], 0)]``; returns (o_l,
    d_l), a -0 in d_l kept, as the finalize takes them. Pair mode
    (``pairs`` = (sub, t_min, t_max, G)): row q*G + lane is ray
    sub[q]*G + lane through ``inst_inv[inst[q]]``; returns (o_l, d_l,
    tmin_l, tmax_l) with -0 in d_l turned into +0, as stage 1's ray table
    takes them."""
    if pairs is None:
        return _local(inst_inv[inst.clamp_min(0)], o, d)
    sub, t_min, t_max, G = pairs
    n_sub = o.shape[0] // G
    qs = sub.long()
    o_l, d_l = _local(inst_inv[inst.long()][:, None],
                      o.reshape(n_sub, G, 3)[qs], d.reshape(n_sub, G, 3)[qs])
    return (o_l.reshape(-1, 3),
            torch.where(d_l == 0.0, 0.0, d_l).reshape(-1, 3),
            t_min.reshape(n_sub, G)[qs].reshape(-1),
            t_max.reshape(n_sub, G)[qs].reshape(-1))


def local_rays(inst_inv, inst, o, d, pairs=None):
    """``local_rays_plain`` on CPU tensors; on CUDA tensors kernel K8, one
    thread a row, bit for bit the plain version. Ray mode takes ``inst``
    (R,) int64 (-1 reads instance 0); pair mode ``inst`` and ``sub`` (Q,)
    int32 and rays padded to whole subgroups of G. Ids are not
    range-checked on the card. Adds the rows to the counter ``rows``."""
    n = inst.shape[0] * (1 if pairs is None else pairs[3])
    local_rays.rows += n
    if o.device.type == "cpu":
        return local_rays_plain(inst_inv, inst, o, d, pairs)
    dev = o.device
    if inst_inv.dim() != 3 or inst_inv.shape[1:] != (3, 4) \
            or o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"local_rays shapes: inst_inv "
                         f"{tuple(inst_inv.shape)}, o {tuple(o.shape)}, d "
                         f"{tuple(d.shape)}")
    if n > INT32_MAX:
        raise ValueError(f"local_rays: {n} rows pass int32")
    inv = _operand(inst_inv, torch.float32, "inst_inv", dev)
    o = _operand(o, torch.float32, "o", dev)
    d = _operand(d, torch.float32, "d", dev)
    if pairs is None:
        if inst.shape != (o.shape[0],):
            raise ValueError(f"local_rays: inst {tuple(inst.shape)} for "
                             f"{o.shape[0]} rays")
        ids = _operand(inst, torch.int64, "inst", dev)
        out = _sections([(n, 3), (n, 3)], o)
        sub = t_min = t_max = None
        G = 1
    else:
        sub, t_min, t_max, G = pairs
        if sub.shape != inst.shape or inst.dim() != 1 or o.shape[0] % G \
                or t_min.shape != (o.shape[0],) or t_max.shape != t_min.shape:
            raise ValueError(
                f"local_rays pair shapes: sub {tuple(sub.shape)}, inst "
                f"{tuple(inst.shape)}, G {G}, o {tuple(o.shape)}, t_min "
                f"{tuple(t_min.shape)}, t_max {tuple(t_max.shape)}")
        ids = _operand(inst, torch.int32, "inst", dev)
        sub = _operand(sub, torch.int32, "sub", dev)
        t_min = _operand(t_min, torch.float32, "t_min", dev)
        t_max = _operand(t_max, torch.float32, "t_max", dev)
        out = _sections([(n, 3), (n, 3), (n,), (n,)], o)
    if n == 0:
        return tuple(out)
    ptr = lambda t: None if t is None else t.data_ptr()
    tmin_l, tmax_l = out[2:] if pairs is not None else (None, None)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.raycore_local_rays(
            inv.data_ptr(), o.data_ptr(), d.data_ptr(), ptr(t_min),
            ptr(t_max), ptr(sub), ids.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), ptr(tmin_l), ptr(tmax_l), n, G,
            int(pairs is not None), _build.stream_ptr(o))
    _build.check(err, "local_rays")
    local_rays.launches += 1
    return tuple(out)


local_rays.launches = 0
local_rays.rows = 0
