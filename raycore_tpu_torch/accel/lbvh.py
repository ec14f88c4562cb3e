"""LBVH construction and the spatial sort permutations of the dense build
(counterpart of ``raycore_tpu/accel/lbvh.py``).

The BLAS build: triangle bounds, Morton codes of the centroids in the
real prims' box, a stable sort, the Karras (2012) radix tree over the
sorted codes (``karras_topology``: its searches are masked loops over
every internal node at once) and a bottom-up AABB refit without atomics
(``refit_aabbs``: idempotent union passes; after k passes every node
within height k of the leaves is exact, and the tree's depth is at most
``MAX_DEPTH``). Everything runs as tensor ops on the triangles' device;
the tables are the JAX package's bit for bit.

Every sort is ``torch.sort(stable=True)``: the table order, and so the
build's tables, depend on stable ties.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.triangle import Triangle
from . import morton as _morton
from .types import (BLAS, INVALID_NODE, PAD_COORD, f32_as_i32,
                    flush_denormals, next_pow2, pad_triangles)

# Depth bound of a Karras radix tree over 30-bit codes with the index
# tiebreak: a root-to-leaf path has strictly increasing common prefixes,
# at most 31 while the codes differ and 32 while they are equal.
MAX_DEPTH = 64


def _make_delta(codes: torch.Tensor):
    """delta(i, j): the common prefix length of sorted codes i and j, with
    32 + the prefix of the indices where the codes are equal; -1 where
    either index is out of range."""
    n = codes.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < n) & (i >= 0) & (i < n)
        ic = i.clamp(0, n - 1)
        jc = j.clamp(0, n - 1)
        ci, cj = codes[ic], codes[jc]
        d_code = _morton.clz32(ci ^ cj)
        d_idx = 32 + _morton.clz32(ic ^ jc)
        d = torch.where(ci == cj, d_idx, d_code)
        return torch.where(valid, d, -1)

    return delta


def karras_topology(codes: torch.Tensor):
    """The radix tree over n >= 2 sorted Morton codes. Returns ``(child0,
    child1, parent)`` int32: child0/child1 (n-1,) of each internal node
    (internal ids [0, n-2], leaf p at id n-1+p), parent (2n-1,) with
    INVALID_NODE at the root.

    The JAX package runs each of its three searches (the exponential and
    binary searches for the span, the binary search for the split) as a
    32-step masked loop. A step is a no-op once its search has converged,
    which takes at most bit_length(n) + 1 steps, so these loops stop at
    min(32, bit_length(n) + 2) steps with the same result."""
    n = codes.shape[0]
    assert n >= 2
    dev = codes.device
    steps = min(32, n.bit_length() + 2)
    delta = _make_delta(codes.to(torch.int64))
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)

    # Direction and the minimum common prefix (the span excludes the
    # neighbour on the other side).
    d = torch.where(delta(i, i + 1) > delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)

    # Exponential search for an upper bound on the span length.
    l_max = torch.full_like(i, 2)
    for _ in range(steps):
        grow = delta(i, i + l_max * d) > delta_min
        l_max = torch.where(grow, l_max * 2, l_max)

    # Binary search for the span's other end.
    ln = torch.zeros_like(i)
    t = l_max
    for _ in range(steps):
        active = t > 1
        t = torch.where(active, t // 2, t)
        take = delta(i, i + (ln + t) * d) > delta_min
        ln = torch.where(active & take, ln + t, ln)
    j = i + ln * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)

    # Binary search for the split inside the span.
    num_identical = delta(first, last)
    left, right = first, last
    for _ in range(steps):
        active = right > left + 1
        mid = (left + right) // 2
        go_left = delta(first, mid) > num_identical
        left = torch.where(active & go_left, mid, left)
        right = torch.where(active & ~go_left, mid, right)
    split = left

    leaf_base = n - 1
    child0 = torch.where(split == first, leaf_base + split, split)
    child1 = torch.where(split + 1 == last, leaf_base + split + 1, split + 1)
    parent = torch.full((2 * n - 1,), INVALID_NODE, dtype=torch.int64,
                        device=dev)
    parent[child0] = i
    parent[child1] = i
    return (child0.to(torch.int32), child1.to(torch.int32),
            parent.to(torch.int32))


def refit_aabbs(child0, child1, leaf_min, leaf_max, n_passes=None):
    """Per-node (2n-1, 3) AABB mins and maxes from the (n, 3) AABBs of the
    sorted leaves, without atomics: ``n_passes`` (min(MAX_DEPTH, n) by
    default) gather-union passes over the internal rows."""
    n = leaf_min.shape[0]
    if n_passes is None:
        n_passes = min(MAX_DEPTH, n)
    dev = leaf_min.device
    c0, c1 = child0.long(), child1.long()
    mn = torch.cat([torch.full((n - 1, 3), float("inf"), device=dev),
                    leaf_min])
    mx = torch.cat([torch.full((n - 1, 3), -float("inf"), device=dev),
                    leaf_max])
    for _ in range(n_passes):
        mn = torch.cat([torch.minimum(mn[c0], mn[c1]), mn[n - 1:]])
        mx = torch.cat([torch.maximum(mx[c0], mx[c1]), mx[n - 1:]])
    return mn, mx


def _tri_bounds(vertices):
    """Per-triangle AABBs, denormal bounds flushed to zero as the
    reference's reductions flush them (T9)."""
    return (flush_denormals(vertices.amin(dim=-2)),
            flush_denormals(vertices.amax(dim=-2)))


def _normalize_centroids(centers, scene_min, scene_max):
    extent = (scene_max - scene_min).clamp_min(1e-12)
    return (centers - scene_min) / extent


def pack_nodes_blas(child0, child1, parent, node_min, node_max,
                    sorted_verts):
    """The (2n-1, 16) int32 node matrix: internal rows carry their
    children's AABBs, leaf rows their triangle's vertices and its sorted
    prim index in child1. Float fields ride as their bits."""
    n = sorted_verts.shape[0]
    dev = sorted_verts.device
    c0, c1 = child0.long(), child1.long()
    col = lambda a: a.to(torch.int32)[:, None]
    internal = torch.cat([
        f32_as_i32(torch.cat([node_min[c0], node_max[c0], node_min[c1],
                              node_max[c1]], dim=1).contiguous()),
        col(child0), col(child1), col(parent[:n - 1]),
        torch.zeros((n - 1, 1), dtype=torch.int32, device=dev)], dim=1)
    leaves = torch.cat([
        f32_as_i32(torch.cat([sorted_verts.reshape(n, 9),
                              torch.zeros((n, 3), device=dev)], dim=1)
                   .contiguous()),
        torch.full((n, 1), INVALID_NODE, dtype=torch.int32, device=dev),
        col(torch.arange(n, device=dev)), col(parent[n - 1:]),
        torch.zeros((n, 1), dtype=torch.int32, device=dev)], dim=1)
    return torch.cat([internal, leaves])


def permute_triangles(tris: Triangle, perm) -> Triangle:
    """Rows ``perm`` of a Triangle SoA."""
    return Triangle(vertices=tris.vertices[perm], normals=tris.normals[perm],
                    tangents=tris.tangents[perm], uv=tris.uv[perm],
                    metadata=tris.metadata[perm])


def _build_blas_padded(tris: Triangle, n_real: int) -> BLAS:
    """The BLAS of a capacity-padded Triangle SoA whose first ``n_real``
    rows are real."""
    cap = tris.vertices.shape[0]
    bmin, bmax = _tri_bounds(tris.vertices)
    # The scene box over the real prims only (padding sits at PAD_COORD).
    scene_min = bmin[:n_real].amin(0)
    scene_max = bmax[:n_real].amax(0)
    root_aabb = torch.stack([scene_min, scene_max])
    centers = 0.5 * (bmin + bmax)
    codes = _morton.morton_code_30bit(
        _normalize_centroids(centers, scene_min, scene_max))
    perm = torch.sort(codes, stable=True).indices
    prims = permute_triangles(tris, perm)
    child0, child1, parent = karras_topology(codes[perm])
    leaf_min, leaf_max = _tri_bounds(prims.vertices)
    node_min, node_max = refit_aabbs(child0, child1, leaf_min, leaf_max,
                                     n_passes=min(MAX_DEPTH, cap))
    nodes = pack_nodes_blas(child0, child1, parent, node_min, node_max,
                            prims.vertices)
    return BLAS(nodes=nodes, prims=prims, root_aabb=root_aabb,
                n_prims=n_real, capacity=cap)


def build_blas(tris: Triangle, capacity: int | None = None) -> BLAS:
    """The BLAS of a Triangle SoA (any count >= 1), padded to a
    power-of-two capacity (``capacity`` when given) with sentinels."""
    n_real = tris.vertices.shape[0]
    cap = next_pow2(n_real) if capacity is None else int(capacity)
    assert cap >= max(2, n_real)
    return _build_blas_padded(pad_triangles(tris, cap), n_real)


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
