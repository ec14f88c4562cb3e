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

#include "featurized.cuh"

namespace {

using namespace raycore;

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
  stage_table(table4, feats, cid, C);

  const int sub = block_subs[(size_t)b * SPB + r / G];
  const float* row = tbl + ((size_t)sub * G + r % G) * FEAT;
  float phi[KFEAT];
  load_phi(row, phi);
  const float t_min = row[COL_TMIN];
  const float t_max = row[COL_TMAX];
  __syncthreads();

  const int C4 = C / 4;   // float4 columns per quantity block
  int best = INT_MAX;
  int lane = C;
  for (int c4 = 0; c4 < C4; ++c4) {
    float q[4][4];        // [quantity][lane j of the four]
    featurized_quads(table4, C, 0, C4, c4, phi, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t;
      const bool ok = mt_accept(q, j, edge_lo, edge_hi, t_min, t_max, &t);
      const int kb = ok ? t_key(t) : INT_MAX;
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
