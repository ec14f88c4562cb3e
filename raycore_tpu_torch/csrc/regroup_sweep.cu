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
// ties. Row r of block b writes key (INT32_MAX on a miss) and a payload
// (-1 on a miss): cid*C + lane in the prim mode, (b*SPB + r/G)*C + lane in
// the pairrow mode, the (block row, lane) pair the instanced engine decodes
// (ops/instanced.py), since one triangle can be hit through several
// instances. A block with cid < 0 writes the miss sentinels.
//
// What bounds it on this card: arithmetic. Each (ray, triangle) test needs
// 19 fused multiply-adds (the nonzero terms of four dots) and, where it may
// pass, an IEEE reciprocal and the compares; about 10 G tests at the
// 1M-ray headline against 67 TFLOP/s of non-tensor float32. Memory traffic
// is small: 19 KB of cluster table and 32 KB of rays per block.
//
// Design: one CTA per block and one thread per row (SPB*G = 512 threads).
// The cluster's 19 nonzero table rows are staged once in shared memory,
// 19 float4s a lane group (stage_sparse_table; 19 KB at C = 256, 38 KB at
// C = 512), and every thread sweeps the C lanes in ascending order with
// the sweep shared with K5 (featurized.cuh:sweep_lanes): the 19-term
// chain read as broadcasts, the division only where the warp's vote finds
// a lane that quick_reject does not refuse, and no lane at all for a warp
// of dead rows (the dummy subgroup that pads a cluster's last block, a
// fifth of the headline's rows). The result is the 10-deep kernel's, bit
// for bit, on every table the build lays out (featurized.cuh).

#include "featurized.cuh"

namespace {

using namespace raycore;

__global__ void regroup_sweep_kernel(const int* __restrict__ block_subs,
                                     const int* __restrict__ block_cid,
                                     const float* __restrict__ tbl,
                                     const float* __restrict__ feats,
                                     int* __restrict__ key_out,
                                     int* __restrict__ pair_out, int G,
                                     int SPB, int C, int pairrow,
                                     float edge_lo, float edge_hi) {
  extern __shared__ float4 table4[];   // SPARSE_TERMS float4s a lane group
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const size_t out = (size_t)b * blockDim.x + r;
  const int cid = block_cid[b];
  if (cid < 0) {   // uniform over the CTA: no thread reaches the barrier
    key_out[out] = INT_MAX;
    pair_out[out] = -1;
    return;
  }
  stage_sparse_table(table4, feats, cid, C, C);
  const int sub = block_subs[(size_t)b * SPB + r / G];
  const SweepRow row = load_sweep_row(tbl + ((size_t)sub * G + r % G) * FEAT);
  __syncthreads();

  int best = INT_MAX;
  int lane = C;
  sweep_lanes(table4, C / 4, 0, row, edge_lo, edge_hi, best, lane);
  key_out[out] = best;
  // The host checks that n_blocks*SPB*C fits int32 in the pairrow mode.
  const int base = pairrow ? (b * SPB + r / G) * C : cid * C;
  pair_out[out] = (best == INT_MAX) ? -1 : base + lane;
}

}  // namespace

extern "C" {

// block_subs (n_blocks, SPB) int32; block_cid (n_blocks,) int32; tbl
// (n_sub + 1, G, 16) float32; feats (K, 16, 4C) float32; key_out and
// pair_out (n_blocks * SPB * G,) int32; pairrow != 0 selects the pairrow
// payload (n_blocks * SPB * C < 2^31). Needs SPB*G <= 1024 threads,
// C % 4 == 0, 16-byte aligned tbl and feats, and the slack quick_reject
// assumes (REJECT_EDGE_LO, REJECT_EDGE_HI). Returns cudaGetLastError().
int raycore_regroup_sweep(const void* block_subs, const void* block_cid,
                          const void* tbl, const void* feats, void* key_out,
                          void* pair_out, int n_blocks, int G, int SPB, int C,
                          int pairrow, float edge_lo, float edge_hi,
                          void* stream) {
  if (edge_lo < REJECT_EDGE_LO || edge_hi > REJECT_EDGE_HI)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * SPARSE_TERMS * (size_t)C;
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
      pairrow, edge_lo, edge_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
