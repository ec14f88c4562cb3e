// Packed sub-cluster sweep: sub-blocks of SPB_sub subgroups, each against
// the C_eff = C / SUBC triangles of its own sub-cluster.
//
// Replaces the TPU kernel raycore_tpu/ops/pallas_regroup.py:_kernel_packed
// (launched by run_packed), prim payload only.
//
// Per sub-block b with sub-cluster q = block_cid[b] = cluster * SUBC + s
// (q >= 0): the sub-cluster's triangles are columns [s*4*C_eff,
// (s+1)*4*C_eff) of cluster's (16, 4C) feature table, laid out [det | u*det
// | v*det | t*det] x C_eff (sub-chunk-major). Every row of the sub-block
// (SPB_sub * G rays gathered from the ray table by block_subs) is tested
// against those C_eff lanes with K2's featurized test and epilogue: key =
// the int32 bits of max(t, 0) of the closest accepted lane (INT32_MAX on a
// miss) with the smallest lane on ties, pair = q * C_eff + lane, the
// triangle's slot cluster * C + s * C_eff + lane (-1 on a miss). A
// sub-block with q < 0 writes the miss sentinels.
//
// What bounds it on this card: arithmetic, as K2: 19 fused multiply-adds
// per (ray, triangle) test against 67 TFLOP/s of non-tensor float32, the
// division only where the test may pass. Each sub-block moves 64 rows of
// rays (4 KB) and a 4.75 KB slice of table at C_eff = 64.
//
// Design. The TPU kernel packs PACKS sub-blocks into one block-diagonal
// matrix product because its matrix unit costs the same at depth 16 and
// 128; on this card that would only multiply zeros. Here a CTA takes PACKS
// consecutive sub-blocks (PACKS * SPB_sub * G threads, one per row; 512 at
// the defaults), so each thread reads only its own sub-cluster's columns.
// Each sub-block's threads stage its slice lane_chunk lanes at a time, 19
// float4s a lane group (stage_sparse_groups: 4.75 KB a sub-block at 64
// lanes, 38 KB a CTA at PACKS 8), and every thread sweeps the chunk with
// K2's row sweep (sweep_lanes); lanes ascend across chunks, so the strict
// < keeps the smallest lane. A chunk as wide as the slice stages it whole
// (19 KB a sub-block at C_eff = 256). The block count need not be a
// multiple of PACKS: sub-blocks past the end are dead rows, stage nothing
// and write nothing. So a (ray, triangle) test gives the same bits here as
// in K2, K3 and K4.

#include "featurized.cuh"

namespace {

using namespace raycore;

// The largest dynamic shared memory a block of this card can use.
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ int sub_cluster(const int* block_cid, int b,
                                           int n_blocks) {
  return b < n_blocks ? block_cid[b] : -1;
}

__global__ void packed_sweep_kernel(const int* __restrict__ block_subs,
                                    const int* __restrict__ block_cid,
                                    const float* __restrict__ tbl,
                                    const float* __restrict__ feats,
                                    int* __restrict__ key_out,
                                    int* __restrict__ pair_out, int n_blocks,
                                    int G, int SPB, int C_eff, int SUBC,
                                    int CH, float edge_lo, float edge_hi) {
  // PACKS staged slices of CH / 4 lane groups, SPARSE_TERMS float4s each.
  extern __shared__ float4 stage4[];
  const int RSUB = SPB * G;
  const int p = threadIdx.x / RSUB;   // this thread's sub-block in the CTA
  const int r = threadIdx.x % RSUB;   // its row in the sub-block
  const int b = blockIdx.x * (blockDim.x / RSUB) + p;
  const int q = sub_cluster(block_cid, b, n_blocks);
  const int sub = q >= 0 ? block_subs[(size_t)b * SPB + r / G] : 0;
  const SweepRow row =
      q >= 0 ? load_sweep_row(tbl + ((size_t)sub * G + r % G) * FEAT)
             : SweepRow{};
  float4* mine = stage4 + (size_t)p * SPARSE_TERMS * (CH / 4);
  // The slice's first lane group within its cluster's table.
  const int g_slice = q >= 0 ? (q % SUBC) * (C_eff / 4) : 0;

  int best = INT_MAX;
  int lane = 0;
  for (int c0 = 0; c0 < C_eff; c0 += CH) {
    const int n4 = min(CH, C_eff - c0) / 4;   // lane groups this chunk
    __syncthreads();   // every thread is done with the previous chunk
    if (q >= 0)
      stage_sparse_groups(mine, feats, q / SUBC, C_eff * SUBC, C_eff,
                          g_slice + c0 / 4, n4, r, RSUB);
    __syncthreads();
    sweep_lanes(mine, n4, c0, row, edge_lo, edge_hi, best, lane);
  }
  if (b < n_blocks) {
    const size_t out = (size_t)b * RSUB + r;
    key_out[out] = best;
    pair_out[out] = (best == INT_MAX) ? -1 : q * C_eff + lane;
  }
}

}  // namespace

extern "C" {

// block_subs (n_blocks, SPB) int32; block_cid (n_blocks,) int32 sub-cluster
// ids; tbl (n_sub + 1, G, 16) float32; feats (K, 16, 4 * C_eff * SUBC)
// float32, sub-chunk-major; key_out and pair_out (n_blocks * SPB * G,)
// int32. Stages lane_chunk lanes of each slice at a time (a multiple of 4;
// C_eff or more stages whole slices). Needs PACKS * SPB * G <= 1024
// threads, C_eff % 4 == 0, 16-byte aligned tbl and feats, PACKS * 76 *
// min(C_eff, lane_chunk) bytes of shared memory (at most 227 KB) and the
// slack quick_reject assumes (REJECT_EDGE_LO, REJECT_EDGE_HI). Returns
// cudaGetLastError() or the error of the shared-memory opt-in.
int raycore_packed_sweep(const void* block_subs, const void* block_cid,
                         const void* tbl, const void* feats, void* key_out,
                         void* pair_out, int n_blocks, int G, int SPB,
                         int PACKS, int C_eff, int SUBC, int lane_chunk,
                         float edge_lo, float edge_hi, void* stream) {
  if (edge_lo < REJECT_EDGE_LO || edge_hi > REJECT_EDGE_HI ||
      lane_chunk <= 0 || lane_chunk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ch = C_eff < lane_chunk ? C_eff : lane_chunk;
  const size_t smem = sizeof(float) * SPARSE_TERMS * (size_t)ch * PACKS;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n_blocks + PACKS - 1) / PACKS;
  packed_sweep_kernel<<<grid, PACKS * SPB * G, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block_subs), static_cast<const int*>(block_cid),
      static_cast<const float*>(tbl), static_cast<const float*>(feats),
      static_cast<int*>(key_out), static_cast<int*>(pair_out), n_blocks, G,
      SPB, C_eff, SUBC, ch, edge_lo, edge_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
