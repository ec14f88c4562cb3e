"""Phase-A interval culling and worklist compaction (counterpart of
``raycore_tpu/ops/pallas_dense.py``, partial: kernel K1 ``phase_a`` with
its plain version, ``phase_a_entry``, ``phase_a_entry_bounds``,
``compact_indices``, ``build_worklist`` and ``_t_from_keys``).

``phase_a`` launches the CUDA kernel ``csrc/phase_a.cu`` on CUDA tensors
and runs ``phase_a_plain`` on CPU tensors; the tensor's device alone
decides.
"""
from __future__ import annotations

import torch

from ..core.triangle import INV_DIR_CLAMP, safe_invdir
from ..kernels import _build

FEAT = 16


def _t_from_keys(key, bits: int):
    """Decode a float32 t from int32 keys whose low ``bits`` mantissa bits
    carry a lane index (bits=0: the key is the t's bit pattern)."""
    mask = (1 << bits) - 1
    return (key & ~mask).view(torch.float32)


def interval_entry(st, bmin, bmax):
    """Conservative entry lower bound of ray bundles into boxes, +inf where
    provably no ray of the bundle enters the box.

    ``st`` (..., 14) bundle stats, cols o_lo(0:3) o_hi(3:6) i_lo(6:9)
    i_hi(9:12) tmin(12) tmax(13); ``bmin``/``bmax`` (..., 3) boxes. The
    leading dims broadcast against each other. Per axis the slab interval
    comes from the min and max of the 8 corner products; a near-parallel
    bundle (clamped inverse direction) whose origins may lie inside the
    slab never exits it, so that axis widens to (-inf, inf). Kernel K1
    repeats these steps in this order."""
    shape = torch.broadcast_shapes(st.shape[:-1], bmin.shape[:-1])
    dev = st.device
    full = lambda v: torch.full(shape, v, dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    t_lo, t_hi = full(-float("inf")), full(float("inf"))
    CL = INV_DIR_CLAMP
    for a in range(3):
        blo, bhi = bmin[..., a], bmax[..., a]
        o_lo, o_hi = st[..., a], st[..., 3 + a]
        i_lo, i_hi = st[..., 6 + a], st[..., 9 + a]
        lo8, hi8 = full(float("inf")), full(-float("inf"))
        for bb in (blo, bhi):
            for oc in (o_lo, o_hi):
                diff = bb - oc
                for ic in (i_lo, i_hi):
                    prod = diff * ic
                    lo8 = torch.minimum(lo8, prod)
                    hi8 = torch.maximum(hi8, prod)
        wide = ((i_hi >= CL) | (i_lo <= -CL)) & (o_hi >= blo) & (o_lo <= bhi)
        t_lo = torch.maximum(t_lo, torch.where(wide, -inf, lo8))
        t_hi = torch.minimum(t_hi, torch.where(wide, inf, hi8))
    entry = torch.maximum(t_lo, st[..., 12])
    exit_ = torch.minimum(t_hi, st[..., 13])
    return torch.where(entry <= exit_, entry, inf)


def phase_a_plain(stats, bounds):
    """(n_tiles, 16) stats x (6, K) bounds -> (n_tiles, K)
    ``interval_entry`` of every (tile, cluster) pair. Bounds rows: bmin
    xyz (0:3), bmax xyz (3:6)."""
    return interval_entry(stats[:, None, :14], bounds[:3].T[None],
                          bounds[3:].T[None])


def phase_a(stats, bounds):
    """Kernel K1 (``csrc/phase_a.cu``): ``phase_a_plain`` computed on the
    card, bit for bit. CPU tensors take ``phase_a_plain``; CUDA tensors
    launch the kernel or raise."""
    if stats.device.type == "cpu":
        return phase_a_plain(stats, bounds)
    _build.require(stats, torch.float32, "stats")
    _build.require(bounds, torch.float32, "bounds", stats.device)
    n_tiles, K = stats.shape[0], bounds.shape[1]
    if stats.shape[1] != 16 or bounds.shape[0] != 6:
        raise ValueError(f"phase_a: stats {tuple(stats.shape)} must be "
                         f"(n_tiles, 16), bounds {tuple(bounds.shape)} (6, K)")
    entry = torch.empty((n_tiles, K), dtype=torch.float32,
                        device=stats.device)
    if n_tiles == 0 or K == 0:
        return entry
    lib = _build.library()
    with torch.cuda.device(stats.device):
        err = lib.raycore_phase_a(stats.data_ptr(), bounds.data_ptr(),
                                  entry.data_ptr(), n_tiles, K,
                                  INV_DIR_CLAMP, _build.stream_ptr(stats))
    _build.check(err, "phase_a")
    phase_a.launches += 1
    return entry


phase_a.launches = 0


def phase_a_entry(scene, o, d, t_min, t_max, n_tiles, TILE):
    """Tile stats + interval culling -> (n_tiles, K) entry bounds."""
    return phase_a_entry_bounds(scene.cluster_min, scene.cluster_max,
                                o, d, t_min, t_max, n_tiles, TILE)


def phase_a_inputs(bounds_min, bounds_max, o, d, t_min, t_max, n_tiles,
                   TILE):
    """The kernel's operands: (n_tiles, 16) tile stats and (6, K) bounds."""
    invd = safe_invdir(torch.where(d == 0.0, 0.0, d))
    shp = lambda a: a.reshape((n_tiles, TILE) + tuple(a.shape[1:]))
    o_t, invd_t = shp(o), shp(invd)
    stats = torch.cat([
        o_t.amin(1), o_t.amax(1), invd_t.amin(1), invd_t.amax(1),
        shp(t_min).amin(1)[:, None], shp(t_max).amax(1)[:, None],
        torch.zeros((n_tiles, 2), dtype=torch.float32, device=o.device)],
        dim=1)
    bounds = torch.cat([bounds_min.T, bounds_max.T]).contiguous()
    return stats, bounds


def phase_a_entry_bounds(bounds_min, bounds_max, o, d, t_min, t_max,
                         n_tiles, TILE):
    """phase_a_entry against arbitrary (K, 3) AABBs."""
    return phase_a(*phase_a_inputs(bounds_min, bounds_max, o, d, t_min,
                                   t_max, n_tiles, TILE))


def compact_indices(flat):
    """Indices of the True flags of a 1-D mask, in ascending order (the
    order of the reference's stable argsort). Syncs for the count."""
    return torch.nonzero(flat).squeeze(1)


def build_worklist(entry):
    """(tids, cids) int32 of every finite-entry pair of the (n_tiles, K)
    entry matrix, row-major (tile-major) order."""
    K = entry.shape[1]
    sel = compact_indices(torch.isfinite(entry).reshape(-1))
    return (sel // K).to(torch.int32), (sel % K).to(torch.int32)
