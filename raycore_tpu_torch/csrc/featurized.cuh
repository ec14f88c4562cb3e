// Helpers shared by the sweep kernels (K2 regroup_sweep.cu, K3
// worklist_sweep.cu, K4 occlusion_sweep.cu, K5 packed_sweep.cu) and phase
// A (K1 phase_a.cu).
//
// The featurized Möller–Trumbore test: with ray features phi = [d, o x d,
// o, 1, ...] and a cluster's (16, 4C) feature table, the four quantities
// det, u*det, v*det and t*det of a ray against a triangle are dots of phi
// with four table columns. Feature rows 10-15 are zero by construction, so
// the kernels before their redesign evaluated a dot as a 10-deep fused
// multiply-add chain. Of those 40 coefficients only 19 can be nonzero:
// det reads rows 0-2, u*det and v*det rows 0-5, t*det rows 6-9
// (accel/dense.py:_featurize_tris). K2-K5 chain over those alone
// (sparse_quads): dropping a step fmaf(phi_f, 0, acc) keeps every bit of
// a chain over finite features except the sign of an exact zero, which no
// acceptance test or key can see. A non-finite feature turns the 10-deep
// chain's zero step into a NaN that rejects; the sparse kernels reject
// such rays outright (finite_features). The closest-hit sweeps K2 and K5
// share one row sweep (sweep_lanes) and differ only in what they stage.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace raycore {

constexpr int FEAT = 16;    // ray-feature and feature-table row width
constexpr int KFEAT = 10;   // feature rows that can be nonzero
constexpr int SPARSE_TERMS = 19;   // nonzero float4s of one lane group

// torch.minimum / torch.maximum on the card: NaN propagates.
__device__ __forceinline__ float min_prop(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_prop(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// The first KFEAT features of a 16-float ray-feature row (16-byte aligned).
__device__ __forceinline__ void load_phi(const float* row, float phi[KFEAT]) {
  const float4* p = reinterpret_cast<const float4*>(row);
  const float4 p0 = p[0], p1 = p[1], p2 = p[2];
  phi[0] = p0.x; phi[1] = p0.y; phi[2] = p0.z; phi[3] = p0.w;
  phi[4] = p1.x; phi[5] = p1.y; phi[6] = p1.z; phi[7] = p1.w;
  phi[8] = p2.x; phi[9] = p2.y;
}

// Acceptance of lane j of a featurized quad: barycentric slack [edge_lo,
// edge_hi] and t in [t_lo, t_hi]. The reciprocal, the products and u + v
// are explicitly rounded so that nothing is contracted into an FMA and the
// plain versions' rounding is kept.
__device__ __forceinline__ bool mt_accept(const float q[4][4], int j,
                                          float edge_lo, float edge_hi,
                                          float t_lo, float t_hi, float* t) {
  const float rcp = __fdiv_rn(1.0f, q[0][j]);
  const float u = __fmul_rn(q[1][j], rcp);
  const float v = __fmul_rn(q[2][j], rcp);
  *t = __fmul_rn(q[3][j], rcp);
  return (u >= edge_lo) && (u <= edge_hi) && (v >= edge_lo) &&
         (__fadd_rn(u, v) <= edge_hi) && (*t >= t_lo) && (*t <= t_hi);
}

// Staged term i of a lane group: quantity sparse_quantity(i) on feature
// row sparse_row(i); det rows 0-2 (i = 0-2), u*det rows 0-5 (3-8), v*det
// rows 0-5 (9-14), t*det rows 6-9 (15-18). Each quantity's terms ascend.
__host__ __device__ constexpr int sparse_quantity(int i) {
  return i < 3 ? 0 : (i < 9 ? 1 : (i < 15 ? 2 : 3));
}
__host__ __device__ constexpr int sparse_row(int i) {
  return i < 3 ? i : (i < 9 ? i - 3 : i - 9);
}

// Stage lane groups [g0, g0 + n) of cluster cid's sub-chunk-major (FEAT,
// 4C) table, sub-chunks of CS lanes, into shared memory: the 19 nonzero
// (feature row, quantity) float4s of group g = s * CS / 4 + c4 (lanes
// 4g..4g+3, in triangle order) go to SPARSE_TERMS consecutive float4s
// at tbl + (g - g0) * SPARSE_TERMS. Threads tid, tid + nthreads, ... of
// the caller share the copy. Consecutive threads read consecutive float4s
// of a table row; the odd stride of 19 float4s keeps their shared-memory
// stores free of bank conflicts.
__device__ __forceinline__ void stage_sparse_groups(float4* tbl,
                                                    const float* feats,
                                                    int cid, int C, int CS,
                                                    int g0, int n, int tid,
                                                    int nthreads) {
  const float4* src =
      reinterpret_cast<const float4*>(feats + (size_t)cid * FEAT * 4 * C);
  const int CS4 = CS / 4;
  for (int idx = tid; idx < SPARSE_TERMS * n; idx += nthreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    const int g = g0 + j;
    const int s = g / CS4;
    tbl[j * SPARSE_TERMS + i] = __ldg(src + sparse_row(i) * C + s * CS +
                                      sparse_quantity(i) * CS4 + g - s * CS4);
  }
}

// Every lane group of cluster cid, all threads of the block helping: 19 C
// floats.
__device__ __forceinline__ void stage_sparse_table(float4* tbl,
                                                   const float* feats,
                                                   int cid, int C, int CS) {
  stage_sparse_groups(tbl, feats, cid, C, CS, 0, C / 4, threadIdx.x,
                      blockDim.x);
}

// q[k][j] = quantity k of lane j of the lane group whose 19 staged float4s
// start at w: each quantity a chain of fused multiply-adds over its
// nonzero rows, ascending, from fmaf(phi_f0, w_f0, 0) as the 10-deep chain
// starts. Every broadcast float4 feeds 4 fused multiply-adds.
__device__ __forceinline__ void sparse_quads(const float4* w,
                                             const float phi[KFEAT],
                                             float q[4][4]) {
#pragma unroll
  for (int i = 0; i < SPARSE_TERMS; ++i) {
    const int k = sparse_quantity(i);
    const int f = sparse_row(i);
    const bool first = f == (k == 3 ? 6 : 0);
    const float4 wv = w[i];
    const float p = phi[f];
    q[k][0] = fmaf(p, wv.x, first ? 0.f : q[k][0]);
    q[k][1] = fmaf(p, wv.y, first ? 0.f : q[k][1]);
    q[k][2] = fmaf(p, wv.z, first ? 0.f : q[k][2]);
    q[k][3] = fmaf(p, wv.w, first ? 0.f : q[k][3]);
  }
}

// False for a ray with a non-finite feature among rows 0-9: the 10-deep
// chain multiplies it by a zero coefficient in some quantity, and the NaN
// rejects every lane.
__device__ __forceinline__ bool finite_features(const float phi[KFEAT]) {
  bool ok = true;
#pragma unroll
  for (int f = 0; f < KFEAT; ++f) ok = ok && fabsf(phi[f]) < INFINITY;
  return ok;
}

// The division-free reject: true only where mt_accept must fail, so that
// the division and the epilogue run only for the rest. Needs edge_lo >=
// -1e-5 and edge_hi <= 1 + 1e-5 (the wrappers' slack).
//
// Why it is safe. Let a = |det|, eps = 2^-24, and su, sv, st the
// quantities u*det, v*det, t*det with det's sign bit flipped into theirs.
// mt_accept computes rcp = RN(1/det) and u = RN(u*det * rcp) =
// RN(su * RN(1/a)), likewise v and t. For a in [2^-60, 2^60], 1/a is a
// normal float, so u = (su/a)(1 + d1)(1 + d2) with |d1|, |d2| <= eps (plus
// at most 2^-149 where the product is subnormal); overflow to inf only
// moves u, v or t further out.
// - su < -p, p = RN(2e-5 a) >= 2e-5 a (1 - eps): u <= (su/a)(1 - eps)^2
//   < -2e-5 (1 - eps)^3 < -1.00001e-5 < edge_lo, so u >= edge_lo fails.
//   The same for sv and v.
// - st < -p on a ray with t_min >= 0: t is a negative normal number
//   (never -0), below t_min.
// - Otherwise su, sv >= -p, so |su| + |sv| <= su + sv + 4p. RN(su + sv) >
//   q = RN(1.0001 a) means su + sv > q >= 1.0001 a (1 - eps), as RN is
//   monotone and q a float. Then u + v >= (su + sv)/a (1 - 2.01 eps)
//   - 2.01 eps 4p/a - 2^-148 > 1.00009, and RN(u + v) >= 1.00009 (1 -
//   eps) > edge_hi, so u + v <= edge_hi fails.
// det NaN, +-0, subnormal, below 2^-60 or above 2^60 (inf included) fails
// the range test and falls through to the exact test.
__device__ __forceinline__ bool quick_reject(float det, float udet,
                                             float vdet, float tdet,
                                             bool tmin_nonneg) {
  const float a = fabsf(det);
  const unsigned sign = __float_as_uint(det) & 0x80000000u;
  const float su = __uint_as_float(__float_as_uint(udet) ^ sign);
  const float sv = __uint_as_float(__float_as_uint(vdet) ^ sign);
  const float st = __uint_as_float(__float_as_uint(tdet) ^ sign);
  const float p = __fmul_rn(2e-5f, a);
  const float q = __fmul_rn(1.0001f, a);
  return (a >= 0x1p-60f) & (a <= 0x1p60f) &
         ((su < -p) | (sv < -p) | (__fadd_rn(su, sv) > q) |
          (tmin_nonneg & (st < -p)));
}

// Bit j set where lane j of a lane group may pass for one ray: those
// quick_reject does not refuse. The sweeps vote on it across the warp and
// branch around the division and mt_accept only when no lane of any ray
// of the warp may pass: a per-lane branch around them is if-converted,
// and then the reject only adds work.
__device__ __forceinline__ unsigned maybe_lanes(const float q[4][4],
                                                bool tmin_nonneg) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool may = !quick_reject(q[0][j], q[1][j], q[2][j], q[3][j],
                                   tmin_nonneg);
    m |= static_cast<unsigned>(may) << j;
  }
  return m;
}

// The wrappers' slack, which quick_reject's margins assume.
constexpr float REJECT_EDGE_LO = -1e-5f;
constexpr float REJECT_EDGE_HI = 1.0f + 1e-5f;

// int32 bits of a hit's t as a key: +0 for t <= 0 (and for -0.0), so keys
// order as the t's do.
__device__ __forceinline__ int t_key(float t) {
  return __float_as_int(t > 0.f ? t : 0.f);
}

// Columns of the regrouped sweeps' ray table (ops/regroup.py:ray_table):
// features 0-12, t_min in 13, t_max in 14.
constexpr int COL_TMIN = 13;
constexpr int COL_TMAX = 14;

// One ray row of a closest-hit sweep (K2, K5) and what the sweep needs to
// know of it before the first lane.
//
// A row is dead when it can accept no lane: a non-finite feature among
// rows 0-9 (the 10-deep chain's NaN refused every lane of such a ray) or
// !(t_min <= t_max). The second is exact: an accepted t has t >= t_min and
// t <= t_max, so t_min <= t_max, and a NaN bound fails both compares. It
// covers the dummy subgroup that pads a cluster's last block (zeros, t_max
// = -inf) and the padding rays (t_max = -inf). The reject would let those
// through to the division, since their det is +0.
struct SweepRow {
  float phi[KFEAT];
  float t_min, t_max;
  bool live;          // not dead (SweepRow{} is a dead row)
  bool tmin_nonneg;   // quick_reject's t clause holds
};

__device__ __forceinline__ SweepRow load_sweep_row(const float* row) {
  SweepRow r;
  load_phi(row, r.phi);
  r.t_min = row[COL_TMIN];
  r.t_max = row[COL_TMAX];
  r.live = finite_features(r.phi) && r.t_min <= r.t_max;
  r.tmin_nonneg = r.t_min >= 0.f;
  return r;
}

// The closest-hit sweep of one row against n staged lane groups (tbl,
// SPARSE_TERMS float4s each, as stage_sparse_groups lays them out) that
// hold lanes lane0 .. lane0 + 4n - 1. Carries the row's best key and its
// lane across calls, lanes ascending: a strict < on t_key keeps the
// smallest lane of equal keys. A warp whose rows are all dead runs no lane
// group; otherwise every lane group runs the 19-term chain, and the
// division and mt_accept run only for the lane groups where the warp's
// vote finds a lane of a live row that quick_reject does not refuse. A
// thread skips only when the vote, its own included, is false: then every
// lane of its own is refused and the skip changes nothing for it. All
// threads of a warp must call it with the same n.
__device__ __forceinline__ void sweep_lanes(const float4* tbl, int n,
                                            int lane0, const SweepRow& row,
                                            float edge_lo, float edge_hi,
                                            int& best, int& lane) {
  if (!__any_sync(__activemask(), row.live)) return;
  for (int c4 = 0; c4 < n; ++c4) {
    float q[4][4];   // [quantity][lane j of the four]
    sparse_quads(tbl + (size_t)c4 * SPARSE_TERMS, row.phi, q);
    const unsigned may = row.live ? maybe_lanes(q, row.tmin_nonneg) : 0u;
    if (!__any_sync(__activemask(), may != 0)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t;
      if (((may >> j) & 1u) &&
          mt_accept(q, j, edge_lo, edge_hi, row.t_min, row.t_max, &t)) {
        const int kb = t_key(t);
        if (kb < best) {
          best = kb;
          lane = lane0 + 4 * c4 + j;
        }
      }
    }
  }
}

}  // namespace raycore
