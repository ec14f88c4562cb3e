// Helpers shared by the sweep kernels (K2 regroup_sweep.cu, K3
// worklist_sweep.cu, K4 occlusion_sweep.cu) and phase A (K1 phase_a.cu).
//
// The featurized Möller–Trumbore test: with ray features phi = [d, o x d,
// o, 1, ...] and a cluster's (16, 4C) feature table, the four quantities
// det, u*det, v*det and t*det of a ray against a triangle are dots of phi
// with four table columns. Feature rows 10-15 are zero by construction, so
// a dot is a 10-deep fused multiply-add chain.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace raycore {

constexpr int FEAT = 16;    // ray-feature and feature-table row width
constexpr int KFEAT = 10;   // feature rows that can be nonzero

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

// Copy rows 0..KFEAT-1 of a cluster's (FEAT, 4C) table (contiguous, KFEAT
// * C float4s) into shared memory, all threads of the block helping.
__device__ __forceinline__ void stage_table(float4* table4, const float* feats,
                                            int cid, int C) {
  const float4* src =
      reinterpret_cast<const float4*>(feats + (size_t)cid * FEAT * 4 * C);
  const int n4 = KFEAT * C;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) table4[i] = __ldg(src + i);
}

// q[k][j] = dot(phi, column k * CS + 4 * c4 + j of the table block that
// starts at float4 column base4 of each row): quantity k of lane 4 * c4 + j
// of a block of CS lanes laid out [det | u*det | v*det | t*det]. Each
// table row is C float4s. All threads read the same float4 at the same
// time, a shared-memory broadcast; ten 16-byte loads feed forty FMAs.
__device__ __forceinline__ void featurized_quads(const float4* table4, int C,
                                                 int base4, int CS4, int c4,
                                                 const float phi[KFEAT],
                                                 float q[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int f = 0; f < KFEAT; ++f) {
      const float4 w = table4[f * C + base4 + k * CS4 + c4];
      acc.x = fmaf(phi[f], w.x, acc.x);
      acc.y = fmaf(phi[f], w.y, acc.y);
      acc.z = fmaf(phi[f], w.z, acc.z);
      acc.w = fmaf(phi[f], w.w, acc.w);
    }
    q[k][0] = acc.x;
    q[k][1] = acc.y;
    q[k][2] = acc.z;
    q[k][3] = acc.w;
  }
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

// int32 bits of a hit's t as a key: +0 for t <= 0 (and for -0.0), so keys
// order as the t's do.
__device__ __forceinline__ int t_key(float t) {
  return __float_as_int(t > 0.f ? t : 0.f);
}

}  // namespace raycore
