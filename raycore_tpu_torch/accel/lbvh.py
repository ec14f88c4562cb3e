"""Spatial sort permutations for the dense build (counterpart of
``raycore_tpu/accel/lbvh.py``, partial: ``_tri_bounds``,
``_normalize_centroids``, ``morton_perm_padded``, ``tile_perm_padded`` and
``tile_sort_axes``).

Every sort is ``torch.sort(stable=True)``: the table order, and so the
build's tables, depend on stable ties.
"""
from __future__ import annotations

import numpy as np
import torch

from . import morton as _morton
from .types import PAD_COORD


def _tri_bounds(vertices):
    return vertices.amin(dim=-2), vertices.amax(dim=-2)


def _normalize_centroids(centers, scene_min, scene_max):
    extent = (scene_max - scene_min).clamp_min(1e-12)
    return (centers - scene_min) / extent


def _real_scene_bounds(bmin, bmax):
    """Scene bounds over real triangles only (padding sits at PAD_COORD)."""
    real = bmin[:, 0] < PAD_COORD / 2
    inf = torch.tensor(float("inf"), dtype=bmin.dtype, device=bmin.device)
    scene_min = torch.where(real[:, None], bmin, inf).amin(0)
    scene_max = torch.where(real[:, None], bmax, -inf).amax(0)
    return real, scene_min, scene_max


def morton_perm_padded(v):
    """(cap,) permutation Morton-sorting capacity-padded (cap, 3, 3)
    vertices; padding sentinels sort last."""
    bmin, bmax = _tri_bounds(v)
    _, scene_min, scene_max = _real_scene_bounds(bmin, bmax)
    centers = 0.5 * (bmin + bmax)
    codes = _morton.morton_code_30bit(
        _normalize_centroids(centers, scene_min, scene_max))
    return torch.sort(codes, stable=True).indices


def tile_perm_padded(v, *, axes: tuple, s0: int, s1: int):
    """(cap,) permutation for the count-balanced 3-level spatial sort of
    capacity-padded (cap, 3, 3) vertices: equal-count strips along
    ``axes[0]``, equal-count slabs along ``axes[1]`` inside each strip,
    then order along ``axes[2]``. With power-of-two capacity and strip and
    slab counts, every cluster boundary is also a strip or slab boundary,
    so fixed-size clusters are compact axis-aligned tiles."""
    bmin, bmax = _tri_bounds(v)
    real, scene_min, scene_max = _real_scene_bounds(bmin, bmax)
    ext = (scene_max - scene_min).clamp_min(1e-12)
    centers = 0.5 * (bmin + bmax)
    q = ((centers - scene_min) / ext * 65535.0).clamp(0.0, 65535.0)
    q = q.to(torch.int32)                                   # (cap, 3)
    N = v.shape[0]
    iota = torch.arange(N, dtype=torch.int32, device=v.device)
    pad_key = lambda fill: torch.tensor(fill, dtype=torch.int32,
                                        device=v.device)

    # Pass 0: strips along the dominant axis; padding sorts last.
    key0 = torch.where(real, q[:, axes[0]], pad_key(1 << 24))
    q1 = torch.where(real, q[:, axes[1]], pad_key(65536))
    q2 = torch.where(real, q[:, axes[2]], pad_key(65536))
    perm = torch.sort(key0, stable=True).indices
    q1s, q2s = q1[perm], q2[perm]
    # Pass 1: slabs along the second axis inside each strip.
    strip = iota // (N // s0)
    p1 = torch.sort(strip * 65537 + q1s, stable=True).indices
    q2ss, perm = q2s[p1], perm[p1]
    # Pass 2: order along the third axis inside each slab.
    slab = iota // (N // (s0 * s1))
    p2 = torch.sort(slab * 65537 + q2ss, stable=True).indices
    return perm[p2]


def tile_sort_axes(vertices, capacity: int, cluster_size: int, lohi=None):
    """Host-side strip/slab shape for the tile sort: greedily halve the
    currently longest scene extent. ``lohi`` is the 6 scene-bound floats
    (min xyz, max xyz) when the caller already has them. Returns
    (axes, s0, s1) for tile_perm_padded."""
    if lohi is None:
        vr = vertices.reshape(-1, 3).to(torch.float32)
        lohi = torch.cat([vr.amin(0), vr.amax(0)]).cpu().numpy()
    lohi = np.asarray(lohi)
    lo, hi = lohi[:3], lohi[3:]
    ext = np.maximum(hi - lo, 1e-12)
    K = max(capacity // cluster_size, 1)
    bits = [0, 0, 0]
    e = ext.copy()
    for _ in range(int(np.log2(K))):
        a = int(np.argmax(e))
        bits[a] += 1
        e[a] *= 0.5
    axes = tuple(int(a) for a in np.argsort(-np.asarray(bits, np.float64)
                                            - ext / ext.max() * 0.5))
    return axes, 1 << bits[axes[0]], 1 << bits[axes[1]]
