// Regroup sweep: one cluster against the rays of SPB subgroups.
//
// Replaces the TPU kernel raycore_tpu/ops/pallas_regroup.py:_kernel and
// _sweep_tbl (launched by run_regrouped; _kernel_contig and the unrolled
// variants compute the same thing).
//
// Per block b with cluster cid = block_cid[b] >= 0: gather the G rays of
// each of the block's SPB subgroups from the ray table, evaluate the four
// featurized Möller–Trumbore quantities (det, u*det, v*det, t*det) of every
// ray against each of the cluster's C triangles, accept a hit with
// barycentric slack [edge_lo, edge_hi] and t in [t_min, t_max], and keep per
// row the smallest int32 bit pattern of max(t, 0) with the smallest lane on
// ties. Row r of block b writes key (INT32_MAX on a miss) and cid*C + lane
// (-1 on a miss). A block with cid < 0 writes the miss sentinels.
//
// What bounds it on this card: arithmetic. Each (ray, triangle) test is 40
// fused multiply-adds (a 10-deep dot for each of 4 quantities: feature rows
// 10-15 of the table are zero by construction and the ray table's t_min and
// t_max columns are not read into the dot) plus an IEEE reciprocal and the
// compares, about 10 G tests at the 1M-ray headline, against 67 TFLOP/s of
// non-tensor float32. Memory traffic is small: 40 KB of cluster table and
// 32 KB of rays per block.
//
// Design: one CTA per block and one thread per row (SPB*G = 512 threads).
// The cluster's 10 x 4C table slice is copied once into shared memory (40 KB
// at C = 256; more than 48 KB takes the opt-in attribute). Every thread
// walks the C lanes in ascending order, four at a time: all threads read the
// same float4 of the table at the same time, a broadcast without bank
// conflicts, so ten 16-byte loads feed forty FMAs. A strict < on the key
// keeps the smallest lane on ties. The reciprocal, the three products and
// u + v use explicitly rounded intrinsics so that nothing is contracted
// into an FMA and the epilogue matches the plain version's rounding; only
// the dot's summation order differs from the plain matrix product.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int FEAT = 16;    // ray-table and feature-table row width
constexpr int KFEAT = 10;   // feature rows that can be nonzero
constexpr int COL_TMIN = 13;
constexpr int COL_TMAX = 14;

__global__ void regroup_sweep_kernel(const int* __restrict__ block_subs,
                                     const int* __restrict__ block_cid,
                                     const float* __restrict__ tbl,
                                     const float* __restrict__ feats,
                                     int* __restrict__ key_out,
                                     int* __restrict__ pair_out, int G,
                                     int SPB, int C, float edge_lo,
                                     float edge_hi) {
  extern __shared__ float4 table4[];   // (KFEAT, 4C) floats as float4
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const size_t out = (size_t)b * blockDim.x + r;
  const int cid = block_cid[b];
  if (cid < 0) {   // uniform over the CTA: no thread reaches the barrier
    key_out[out] = INT_MAX;
    pair_out[out] = -1;
    return;
  }
  // Rows 0..KFEAT-1 of feats[cid] are contiguous: KFEAT * 4C floats.
  const float4* src = reinterpret_cast<const float4*>(
      feats + (size_t)cid * FEAT * 4 * C);
  const int n4 = KFEAT * C;
  for (int i = r; i < n4; i += blockDim.x) table4[i] = __ldg(src + i);

  const int sub = block_subs[(size_t)b * SPB + r / G];
  const float4* row = reinterpret_cast<const float4*>(
      tbl + ((size_t)sub * G + r % G) * FEAT);
  const float4 p0 = row[0], p1 = row[1], p2 = row[2], p3 = row[3];
  const float phi[KFEAT] = {p0.x, p0.y, p0.z, p0.w, p1.x,
                            p1.y, p1.z, p1.w, p2.x, p2.y};
  static_assert(COL_TMIN == 13 && COL_TMAX == 14, "t range in p3.y, p3.z");
  const float t_min = p3.y;
  const float t_max = p3.z;
  __syncthreads();

  const int C4 = C / 4;   // float4 columns per quantity block
  int best = INT_MAX;
  int lane = C;
  for (int c4 = 0; c4 < C4; ++c4) {
    float q[4][4];        // [quantity][lane j of the four]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int f = 0; f < KFEAT; ++f) {
        const float4 w = table4[f * 4 * C4 + k * C4 + c4];
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float rcp = __fdiv_rn(1.0f, q[0][j]);
      const float u = __fmul_rn(q[1][j], rcp);
      const float v = __fmul_rn(q[2][j], rcp);
      const float t = __fmul_rn(q[3][j], rcp);
      const bool ok = (u >= edge_lo) && (u <= edge_hi) && (v >= edge_lo) &&
                      (__fadd_rn(u, v) <= edge_hi) && (t >= t_min) &&
                      (t <= t_max);
      const int kb = ok ? __float_as_int(t > 0.f ? t : 0.f) : INT_MAX;
      if (kb < best) {
        best = kb;
        lane = c4 * 4 + j;
      }
    }
  }
  key_out[out] = best;
  pair_out[out] = (best == INT_MAX) ? -1 : cid * C + lane;
}

}  // namespace

extern "C" {

// block_subs (n_blocks, SPB) int32; block_cid (n_blocks,) int32; tbl
// (n_sub + 1, G, 16) float32; feats (K, 16, 4C) float32; key_out and
// pair_out (n_blocks * SPB * G,) int32. Needs SPB*G <= 1024 threads,
// C % 4 == 0 and 16-byte aligned tbl and feats. Returns cudaGetLastError().
int raycore_regroup_sweep(const void* block_subs, const void* block_cid,
                          const void* tbl, const void* feats, void* key_out,
                          void* pair_out, int n_blocks, int G, int SPB, int C,
                          float edge_lo, float edge_hi, void* stream) {
  const size_t smem = sizeof(float) * KFEAT * 4 * (size_t)C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        regroup_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  regroup_sweep_kernel<<<n_blocks, G * SPB, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block_subs), static_cast<const int*>(block_cid),
      static_cast<const float*>(tbl), static_cast<const float*>(feats),
      static_cast<int*>(key_out), static_cast<int*>(pair_out), G, SPB, C,
      edge_lo, edge_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
