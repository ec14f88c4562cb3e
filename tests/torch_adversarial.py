"""Adversarial inputs of kernels K1 (phase A), K7 (the subgroup refine)
and K6 (the dense sweep), of the probes P2's and P4's epilogues and of
P1's gathers, and the Morton-ordered ray grid of the multiwave tests,
made with NumPy from a seed.

This module imports no JAX: the card tests (test_torch_kernels.py) use
the same inputs as the CPU tests. Every function returns float32 NumPy
arrays.
"""
import numpy as np
import torch

from raycore_tpu_torch.accel.dense import INVD_COLS, ray_features
from raycore_tpu_torch.core.triangle import INV_DIR_CLAMP
from raycore_tpu_torch.ops import dense as ops_dense
from raycore_tpu_torch.ops import regroup as ops_regroup

CL = np.float32(INV_DIR_CLAMP)
F32 = np.float32

# Phase A: a tile count that is not a whole number of the kernel's strips
# and a cluster count that is not a whole number of its CTAs.
PHASE_A_TILES = 29
PHASE_A_K = 300
PHASE_A_CASES = ("base", "zero_dirs", "clamped", "padded_boxes",
                 "empty_boxes", "tmin_gt_tmax") \
    + tuple(f"nonfinite_col{c}" for c in range(14))


def stage1_rows(o, d, t_min, t_max):
    """(o, invd, t_min, t_max) of flat rays as the query engines hand them to
    ``bundle_stats`` and phase A: the -0 direction components turned into
    +0, the inverse directions read from the ray features."""
    d = torch.where(d == 0.0, 0.0, d)
    return o, ray_features(o, d)[:, INVD_COLS], t_min, t_max


def _boxes(rng, K):
    lo = rng.uniform(-1.5, 1.5, (3, K)).astype(F32)
    hi = (lo + rng.uniform(0.0, 0.6, (3, K))).astype(F32)
    return np.concatenate([lo, hi])


def _stats(rng, n):
    """(n, 16) tile stats: origin ranges over [-1, 1]^3, inverse-direction
    ranges of one sign or of both, t_min_lo 0 or above, t_max_hi inf or
    finite."""
    st = np.zeros((n, 16), F32)
    st[:, 0:3] = rng.uniform(-1, 1, (n, 3))
    st[:, 3:6] = st[:, 0:3] + rng.uniform(0, 0.4, (n, 3))
    inv = 1.0 / rng.uniform(0.2, 1.0, (n, 3, 2))
    inv.sort(axis=2)
    sign = rng.choice([-1.0, 1.0, 0.0], (n, 3))
    st[:, 6:9] = np.where(sign > 0, inv[..., 0],
                          np.where(sign < 0, -inv[..., 1], -inv[..., 0]))
    st[:, 9:12] = np.where(sign > 0, inv[..., 1],
                           np.where(sign < 0, -inv[..., 0], inv[..., 1]))
    st[:, 12] = np.where(rng.uniform(size=n) < 0.7, 0.0,
                         rng.uniform(0, 1, n))
    st[:, 13] = np.where(rng.uniform(size=n) < 0.7, np.inf,
                         rng.uniform(1, 5, n))
    return st


def phase_a_case(case, seed=0):
    """(stats (PHASE_A_TILES, 16), bounds (6, PHASE_A_K)) of one case:
    - base: random stats and boxes;
    - zero_dirs: the stats of rays whose directions hold +-0 and tiny
      components (safe_invdir clamps them), over boxes around them;
    - clamped: inverse-direction bounds at exactly +-INV_DIR_CLAMP, so the
      parallel-bundle widening runs, against boxes that overlap the
      origins and boxes that do not;
    - padded_boxes: the last quarter of the boxes at +-1e30, as the
      reference pads K;
    - empty_boxes: a third of the boxes with bmin > bmax on some axis;
    - tmin_gt_tmax: t_min_lo above (or equal to) t_max_hi;
    - nonfinite_col{c}: column c of the stats NaN, +inf or -inf, every
      third tile each."""
    rng = np.random.default_rng(seed)
    n, K = PHASE_A_TILES, PHASE_A_K
    st, b = _stats(rng, n), _boxes(rng, K)
    if case == "zero_dirs":
        TILE = 16
        o = rng.uniform(-1, 1, (n * TILE, 3)).astype(F32)
        d = rng.normal(size=(n * TILE, 3)).astype(F32)
        d[::3, 0] = 0.0
        d[1::3, 1] = -0.0
        d[2::5, 2] = F32(3e-6)
        d[3::5, 0] = F32(-3e-6)
        d[:TILE, :2] = 0.0             # a tile of rays along z
        t_min = np.zeros(n * TILE, F32)
        t_max = np.full(n * TILE, np.inf, F32)
        stats, _ = ops_dense.phase_a_inputs(
            *stage1_rows(*(torch.as_tensor(a) for a in (o, d, t_min,
                                                        t_max))),
            torch.zeros(1, 3), torch.zeros(1, 3), TILE)
        st = stats.numpy()
    elif case == "clamped":
        st[::2, 9] = CL
        st[1::2, 6] = -CL
        st[::3, 7], st[::3, 10] = -CL, CL
        st[1::4, 11] = CL
        st[1::4, 8] = CL
        # Boxes that contain some tiles' origin ranges.
        b[0, :n], b[3, :n] = st[:, 0] - 0.1, st[:, 3] + 0.1
        b[1, :n], b[4, :n] = st[:, 1], st[:, 4]
    elif case == "padded_boxes":
        b[:, 3 * K // 4:] = F32(1e30)
        b[:3, -5:] = F32(-1e30)
    elif case == "empty_boxes":
        sel = rng.uniform(size=K) < 1 / 3
        ax = rng.integers(0, 3, K)
        for a in range(3):
            m = sel & (ax == a)
            b[a, m], b[3 + a, m] = b[3 + a, m] + F32(0.1), b[a, m]
    elif case == "tmin_gt_tmax":
        st[::2, 12] = rng.uniform(2, 3, len(st[::2]))
        st[::2, 13] = rng.uniform(0.5, 1.9, len(st[::2]))
        st[1::4, 13] = st[1::4, 12]
    elif case.startswith("nonfinite_col"):
        c = int(case[len("nonfinite_col"):])
        st[0::3, c], st[1::3, c], st[2::3, c] = np.nan, np.inf, -np.inf
    elif case != "base":
        raise ValueError(case)
    return np.ascontiguousarray(st), np.ascontiguousarray(b)


def phase_a_signed_zeros(seed=0):
    """Stats and boxes whose corner products are exact zeros of both
    signs on one axis (origins and box faces at +-0, an inverse-direction
    range across 0), with t_min_lo +-0 or negative: entries of +-0 whose
    sign depends on which zero each min and max keeps."""
    st, b = phase_a_case("base", seed)
    st[::2, 2], st[::2, 5] = -0.0, 0.0
    st[::2, 8], st[::2, 11] = -1.0, 1.0
    st[1::4, 12], st[3::4, 12] = -0.0, -1.0
    b[2, ::2], b[5, ::2] = 0.0, -0.0
    b[2, 1::4], b[5, 1::4] = -0.0, 0.0
    st[::3, 9:11] = CL
    return st, b


# K7 (the subgroup refine): the tiles of subgroup stats a case draws, and
# pair counts that are not a whole number of the kernel's CTAs, 0 among
# them.
REFINE_TILES = 5
REFINE_PAIRS = (0, 1, 301)


def refine_case(case, SPT, P, seed=0):
    """(stats (REFINE_TILES*SPT, 14), tids (P,) int32, cids (P,) int32,
    cluster_min (K, 3), cluster_max (K, 3)) of one phase-A case (or
    "signed_zeros"): the case's stats rows as subgroup stats, each row
    drawn before any is drawn again, its boxes as the clusters, and P
    random (tile, cluster) pairs."""
    st, b = (phase_a_signed_zeros(seed) if case == "signed_zeros"
             else phase_a_case(case, seed))
    rng = np.random.default_rng(seed + 1)
    n_sub = REFINE_TILES * SPT
    rows = np.concatenate([rng.permutation(len(st))
                           for _ in range(-(-n_sub // len(st)))])[:n_sub]
    tids = rng.integers(0, REFINE_TILES, P).astype(np.int32)
    cids = rng.integers(0, b.shape[1], P).astype(np.int32)
    return (np.ascontiguousarray(st[rows, :14]), tids, cids,
            np.ascontiguousarray(b[:3].T), np.ascontiguousarray(b[3:].T))


def refine_operands(bmin, bmax, rays, tile, G, tile_major=False):
    """What stage 1 hands the refine on a padded batch of ``rays``: the
    subgroup stats and phase A's worklist against the boxes (bmin, bmax),
    cluster-major as the regrouped engine builds it or tile-major as the
    instanced engine does. Returns refine_pairs' arguments."""
    o, d, t_min, t_max, _, G, TILE = ops_regroup._padded_batch(rays, tile, G)
    rows = stage1_rows(o, d, t_min, t_max)
    entry = ops_dense.phase_a_entry(*rows, bmin, bmax, TILE)
    if tile_major:
        tids, cids = ops_dense.build_worklist(entry)
    else:
        cids, tids = ops_dense.build_worklist(entry.T)
    stats = ops_dense.bundle_stats(*rows, G)
    return stats, tids, cids, bmin, bmax, TILE // G, o.shape[0] // TILE


# K6: a ray count that is not a whole number of the kernel's CTAs or
# warps, and a table that is not a whole TRI_BLOCK.
BRUTE_RAYS = 300


def brute_case(seed=0):
    """(tbl (9, T), o, d, t_min, t_max) for the dense sweep: a flat 6 x 6
    grid at z = 0 split along its x == y diagonals (exact binary
    vertices), a random soup over the unit box, and degenerate triangles:
    all zero (det +-0, as the table's padding), zero area, tiny (det
    underflows to a subnormal or to 0), huge (det overflows to inf), and
    one with a NaN vertex. Rays: random ones at the box, rays through the
    grid's shared edges and vertices (u or v exactly 0 or 1), rays with
    +-0 direction components, an empty t range (t_min > t_max), NaN and
    finite bounds, and a NaN origin."""
    rng = np.random.default_rng(seed)
    tris = []
    n = 6
    for i in range(n):
        for j in range(n):
            p = [np.array([(i + a) / n, (j + c) / n, 0.0])
                 for a, c in ((0, 0), (1, 0), (1, 1), (0, 1))]
            tris += [[p[0], p[1], p[2]], [p[0], p[2], p[3]]]
    soup = rng.uniform(-1, 1, (40, 1, 3)) + rng.normal(0, 0.3, (40, 3, 3))
    tris += list(soup)
    tris += [np.zeros((3, 3))] * 3
    tris += [[[0, 0, 0.5], [1, 1, 0.5], [2, 2, 0.5]]]             # zero area
    tris += [np.array([[0, 0, 0.2], [1, 0, 0.2], [0, 1, 0.2]]) * s
             for s in (1e-20, 1e-25, 1e-40)]                        # tiny
    tris += [np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]]) * 1e19,   # huge
             [[0.2, 0.2, 0.3], [np.nan, 0.5, 0.3], [0.2, 0.6, 0.3]]]
    v = np.asarray(tris, np.float64).astype(F32)
    tbl = np.ascontiguousarray(v.reshape(len(v), 9).T)
    R = BRUTE_RAYS
    o = rng.uniform(-1.2, 1.2, (R, 3)).astype(F32)
    o[:, 2] = 2.0
    tgt = rng.uniform(-1, 1, (R, 3)).astype(F32)
    tgt[:, 2] = 0.0
    d = (tgt - o).astype(F32)
    # Rays straight down through grid lines, shared edges and vertices.
    k = np.arange(100)
    o[:100, 0] = (k % 7) / F32(n)
    o[:100, 1] = np.where(k % 2 == 0, (k // 7 % 7) / F32(n),
                          (k % 7) / F32(n))
    d[:100] = (0.0, -0.0, -1.0)
    d[100:110, :2] = 0.0
    d[110:115] = 0.0                              # a zero direction
    t_min = np.zeros(R, F32)
    t_max = np.full(R, np.inf, F32)
    t_min[120:130], t_max[120:130] = 3.0, 1.0     # empty range
    t_min[130:135] = np.nan
    t_max[135:140] = np.nan
    t_max[140:170] = rng.uniform(0.5, 2.5, 30)
    t_min[170:190] = rng.uniform(0.5, 2.0, 20)
    o[190:193] = np.nan
    return (tbl, np.ascontiguousarray(o), np.ascontiguousarray(d), t_min,
            t_max)


def morton_grid(side, half=0.75, z=3.0):
    """(o, d): a side x side grid of downward rays over [-half, half]^2 at
    height z in Morton order, as the 1M cells' rays are (side a power of
    two). A subgroup of 32 rays is then a compact patch whose rays share
    clusters, so the multiwave's prune has bounds to work with."""
    xs = np.linspace(-half, half, side, dtype=F32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    o = np.stack([X, Y, np.full_like(X, z)], -1).reshape(-1, 3)

    def spread(v):
        for s, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                     (1, 0x55555555)):
            v = (v | (v << np.uint64(s))) & np.uint64(m)
        return v
    zz = spread(np.arange(side, dtype=np.uint64))
    code = (zz[:, None] << np.uint64(1)) | zz[None, :]
    o = np.ascontiguousarray(o[np.argsort(code.reshape(-1), kind="stable")])
    d = np.broadcast_to(np.array([0.0, 0.0, -1.0], F32), o.shape)
    return o, np.ascontiguousarray(d)


# The probe P4: dets the pre-test must handle (signed zeros, subnormals,
# 2^+-126 scales, overflowing magnitudes, infinities, NaN) and the
# quotients u = udet / det and v = vdet / det aimed at: each clause's edge
# (-e and 1 + e exactly as float32), v past 1 + e where u = -e lets u + v
# pass, and plain values inside and outside.
BLOCK_DETS = tuple(s * sg for s in (
    0.0, 2.0 ** -149, 3 * 2.0 ** -140, 2.0 ** -128, 2.0 ** -126,
    2.0 ** -100, 1e-30, 0.37, 1.0, 3.0, 2.0 ** 100, 2.0 ** 126, 2.0 ** 127,
    float(np.finfo(F32).max), np.inf) for sg in (1.0, -1.0)) + (np.nan,)
BLOCK_QUOTIENTS = (-1e-5, 1 + 1e-5, 0.0, -0.0, 0.25, 0.5, 1.0, -0.5, 2.0,
                   1 + 1.5e-5, 1 + 2e-5)


def block_probe_case(K=16, n_sub=64, G=32, seed=0):
    """(tbl (n_sub + 1, G, 16), feats (K, 16, 4 * 128)) for P4, whose
    products are set lane by lane: the tables' feature row 0 holds det,
    udet, vdet and tdet, rows 1-15 are zero, and every row's column 0 is 1,
    so det is feature row 0's value (+-0 may change sign). det from
    BLOCK_DETS; udet and vdet det times a quotient of BLOCK_QUOTIENTS,
    rounded, moved by up to 2 ulps either way (so a quotient lands on, just
    inside and just outside a clause's edge); tdet det / 2, or a special
    value. The last cluster holds random bit patterns. Rows: t in [-1, 2],
    every 7th an empty range (t_min 1 > t_max 0), every 11th a NaN t_min."""
    rng = np.random.default_rng(seed)
    C = 128
    det = rng.choice(np.array(BLOCK_DETS, F32), (K, C))
    quot = np.array(BLOCK_QUOTIENTS, F32)

    def numerator():
        with np.errstate(all="ignore"):
            x = (det * rng.choice(quot, (K, C))).astype(F32)
            step = rng.integers(-2, 3, (K, C))
            for k in (1, 2):
                x = np.where(step >= k, np.nextafter(x, F32(np.inf)), x)
                x = np.where(step <= -k, np.nextafter(x, F32(-np.inf)), x)
        return x

    udet, vdet = numerator(), numerator()
    with np.errstate(all="ignore"):
        tdet = (det * F32(0.5)).astype(F32)
    tdet[:, ::9] = rng.choice(np.array(BLOCK_DETS, F32), (K, -(-C // 9)))
    feats = np.zeros((K, 16, 4 * C), F32)
    feats[:, 0] = np.concatenate([det, udet, vdet, tdet], 1)
    bits = rng.integers(0, 2 ** 32, (4 * C,), dtype=np.uint64)
    feats[-1, 0] = bits.astype(np.uint32).view(F32)
    tbl = rng.standard_normal((n_sub + 1, G, 16)).astype(F32)
    tbl[..., 0] = 1.0
    tbl[..., 13], tbl[..., 14] = -1.0, 2.0
    flat = tbl.reshape(-1, 16)
    flat[::7, 13], flat[::7, 14] = 1.0, 0.0
    flat[::11, 13] = np.nan
    return tbl, feats


def epilogue_probe_case(TILE, n_tiles, seed=0):
    """(phi (n_tiles * TILE, 16), feats (n_tiles, 16, 4 * 128)) for P2,
    whose products sit on the pre-test's special dets and the clauses'
    edges: feats from ``block_probe_case`` (feature row 0 holds det, udet,
    vdet, tdet; the other rows are zero), phi's column 0 is 1."""
    _, feats = block_probe_case(K=n_tiles, n_sub=1, G=1, seed=seed)
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((n_tiles * TILE, 16)).astype(F32)
    phi[:, 0] = 1.0
    return phi, feats


# P1's gathers: (NN, steps) and what the case does to the tool's normal
# table and uniform indices. Every case but the one-row table lies in the
# shared-memory tier (gather_probe.SLICE_ROWS); 2 steps are fewer than its
# step groups (4 on 132 SMs), 6,147 rows not a whole number of 4, and the
# magnitudes sit near 2^100 and below 2^-100.
GATHER_CASES = {"tool": (6144, 6), "one_row_table": (1, 3),
                "rows_not_x4": (6147, 5), "fewer_steps_than_groups": (6147, 2),
                "one_row_fetched": (6147, 4), "huge": (6147, 3),
                "tiny": (6147, 3)}


def gather_case(case, seed=0):
    """(idx int32 (steps * 512,), tbl float32 (NN, 128)) of a
    ``GATHER_CASES`` entry."""
    NN, steps = GATHER_CASES[case]
    rng = np.random.default_rng(seed)
    tbl = rng.normal(size=(NN, 128)).astype(F32)
    idx = rng.integers(0, NN, steps * 512).astype(np.int32)
    if case == "one_row_fetched":
        idx[:] = NN // 2
    elif case == "huge":
        tbl = (tbl * F32(2.0 ** 100)).astype(F32)
    elif case == "tiny":
        tbl = (tbl * F32(2.0 ** -110)).astype(F32)
    return idx, tbl


# K8 (the instanced frame's affine arithmetic): instance counts that are
# not a whole number of the kernel's CTAs, and the cases of its transforms.
AFFINE_INSTANCES = 300
AFFINE_CASES = ("cell_poses", "random", "near_singular", "signed_zeros")
TINY = F32(1e-40)       # a float32 subnormal


def affine_case(case, seed=0):
    """(transforms (I, 3, 4), local_min (I, 3), local_max (I, 3)) of one
    ``AFFINE_CASES`` entry. "cell_poses": the benchmark's dynamic-128
    poses (identity rotations at default_rng(0).uniform(-5, 5) centres,
    shifted 0.1 in x a frame for 6 frames) around a 0.3-radius sphere's
    box; "random": random rotations scaled 1e-3 to 1e3 a column,
    translations up to +-1e6; "near_singular": 3x3s with |det| about
    1e-30; "signed_zeros": signed permutations with +-0 and subnormal
    entries, +-0 and subnormal translations, boxes with -0 and +0 faces,
    so that the 8 corners tie at zeros of both signs."""
    rng = np.random.default_rng(seed)
    if case == "cell_poses":
        centres = np.random.default_rng(0).uniform(-5, 5, (128, 3))
        m = np.zeros((6, 128, 3, 4))
        m[..., :3] = np.eye(3)
        m[..., 3] = centres + 0.1 * np.arange(1, 7)[:, None, None] \
            * np.array([1.0, 0.0, 0.0])
        m = m.reshape(-1, 3, 4)
        lo = np.full((m.shape[0], 3), -0.3)
        return m.astype(F32), lo.astype(F32), (-lo).astype(F32)
    I = AFFINE_INSTANCES
    lo = rng.uniform(-2, 1, (I, 3))
    hi = lo + rng.uniform(0, 2, (I, 3))
    q, _ = np.linalg.qr(rng.normal(size=(I, 3, 3)))
    m = np.zeros((I, 3, 4))
    if case == "random":
        m[..., :3] = q * 10.0 ** rng.uniform(-3, 3, (I, 1, 3))
        m[..., 3] = rng.uniform(-1e6, 1e6, (I, 3))
    elif case == "near_singular":
        # A rotation with one column scaled to 1e-30, or every entry
        # 1e-10: |det| = 1e-30 either way.
        s = np.where(np.arange(3) == rng.integers(0, 3, (I, 1, 1)), 1e-30,
                     1.0)
        m[..., :3] = np.where(rng.uniform(size=(I, 1, 1)) < 0.5, q * s,
                              np.eye(3) * 1e-10)
        m[..., 3] = rng.uniform(-10, 10, (I, 3))
    elif case == "signed_zeros":
        perm = np.stack([rng.permutation(3) for _ in range(I)])
        sign = rng.choice([-1.0, 1.0], (I, 3))
        scale = rng.choice([1.0, 2.0, 0.5], (I, 3))
        m[np.arange(I)[:, None], np.arange(3), perm] = sign * scale
        m = m.astype(F32)
        # The zero entries of R take either sign; one in five is a
        # subnormal instead.
        z = m[..., :3] == 0
        m[..., :3] = np.where(z, rng.choice(
            [F32(0.0), F32(-0.0), F32(0.0), F32(-0.0), TINY], (I, 3, 3)),
            m[..., :3])
        m[..., 3] = rng.choice([F32(0.0), F32(-0.0), TINY, -TINY, F32(1.0)],
                               (I, 3))
        faces = np.array([0.0, -0.0, TINY, -1.0, 1.0], F32)
        lo = faces[rng.integers(0, 4, (I, 3))]
        hi = np.where(rng.uniform(size=(I, 3)) < 0.5, F32(0.0), F32(-0.0))
        hi[:, 0] = np.where(lo[:, 0] == -1.0, F32(1.0), hi[:, 0])
        return m.astype(F32), lo.astype(F32), hi.astype(F32)
    else:
        raise ValueError(f"unknown affine case {case!r}")
    return m.astype(F32), lo.astype(F32), hi.astype(F32)


def affine_rays(R, seed=0):
    """(o, d) (R, 3) for the local rays: origins up to +-100, unit
    directions, on every other ray one component +0, -0 or a subnormal
    of either sign, and rays (-0, +0, -1) and (-0, -0.6, -0.8): under an
    identity rotation the last keeps d_l's -0 in x."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-100, 100, (R, 3)).astype(F32)
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(F32)
    special = np.array([0.0, -0.0, TINY, -TINY], F32)
    rows = np.arange(0, R, 2)
    d[rows, rng.integers(0, 3, rows.size)] = special[rng.integers(
        0, 4, rows.size)]
    d[1::6] = np.array([-0.0, 0.0, -1.0], F32)
    d[3::6] = np.array([-0.0, -0.6, -0.8], F32)
    return o, d
