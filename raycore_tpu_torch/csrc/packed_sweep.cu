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
// What bounds it on this card: arithmetic, as K2: 40 fused multiply-adds
// per (ray, triangle) test against 67 TFLOP/s of non-tensor float32. Each
// sub-block moves 64 rows of rays (4 KB) and a 10 KB slice of table at
// C_eff = 64.
//
// Design. The TPU kernel packs PACKS sub-blocks into one block-diagonal
// matrix product because its matrix unit costs the same at depth 16 and
// 128; on this card that would only multiply zeros. Here a CTA takes PACKS
// consecutive sub-blocks (PACKS * SPB_sub * G threads, one per row; 512 at
// the defaults), so each thread reads only its own sub-cluster's columns.
// A sub-cluster slice is 10 rows x 4 x C_eff floats: 10 KB at C_eff = 64
// but 40 KB at C_eff = 256, and PACKS distinct 40 KB slices do not fit in
// a block's 227 KB. So the CTA stages every sub-block's slice LANE_CHUNK =
// 64 lanes at a time (10 KB per sub-block, 80 KB at PACKS = 8, above the
// 48 KB default: opt in), sweeps those lanes, and moves to the next chunk;
// lanes ascend across chunks, so a strict < keeps the smallest lane. The
// block count need not be a multiple of PACKS: sub-blocks past the end
// stage nothing and write nothing. The dot and the epilogue come from
// featurized.cuh, so a (ray, triangle) test gives the same bits here as in
// K2, K3 and K4.

#include "featurized.cuh"

namespace {

using namespace raycore;

constexpr int COL_TMIN = 13;
constexpr int COL_TMAX = 14;
constexpr int LANE_CHUNK = 64;

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
                                    int G, int SPB, int PACKS, int C_eff,
                                    int SUBC, float edge_lo, float edge_hi) {
  // PACKS staged slices, each (KFEAT, 4 * CH) floats as float4: row f holds
  // the four quantity blocks of CH lanes, CH4 float4s each.
  extern __shared__ float4 stage4[];
  const int RSUB = SPB * G;
  const int p = threadIdx.x / RSUB;   // this thread's sub-block in the CTA
  const int r = threadIdx.x % RSUB;   // its row in the sub-block
  const int b0 = blockIdx.x * PACKS;
  const int b = b0 + p;
  const int q = sub_cluster(block_cid, b, n_blocks);
  const int CH4 = min(C_eff, LANE_CHUNK) / 4;
  const int per4 = KFEAT * 4 * CH4;   // float4s staged per sub-block
  const size_t row4 = (size_t)C_eff * SUBC;   // float4s per table row

  float phi[KFEAT];
  float t_min = 0.f, t_max = 0.f;
  if (q >= 0) {
    const int sub = block_subs[(size_t)b * SPB + r / G];
    const float* row = tbl + ((size_t)sub * G + r % G) * FEAT;
    load_phi(row, phi);
    t_min = row[COL_TMIN];
    t_max = row[COL_TMAX];
  }

  int best = INT_MAX;
  int lane = 0;
  for (int c0 = 0; c0 < C_eff; c0 += 4 * CH4) {
    const int w4 = min(CH4, (C_eff - c0) / 4);   // float4 lanes this chunk
    __syncthreads();   // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < PACKS * per4; i += blockDim.x) {
      const int pp = i / per4;
      const int qq = sub_cluster(block_cid, b0 + pp, n_blocks);
      const int rem = i % per4;
      const int c4 = rem % CH4;
      if (qq < 0 || c4 >= w4) continue;
      const int f = rem / (4 * CH4);
      const int k = (rem / CH4) % 4;
      const float4* src = reinterpret_cast<const float4*>(feats) +
                          ((size_t)(qq / SUBC) * FEAT + f) * row4 +
                          ((qq % SUBC) * 4 * C_eff + k * C_eff + c0) / 4 + c4;
      stage4[i] = __ldg(src);
    }
    __syncthreads();
    if (q < 0) continue;
    const float4* table4 = stage4 + p * per4;
    for (int c4 = 0; c4 < w4; ++c4) {
      float qv[4][4];   // [quantity][lane j of the four]
      featurized_quads(table4, 4 * CH4, 0, CH4, c4, phi, qv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t;
        const bool ok = mt_accept(qv, j, edge_lo, edge_hi, t_min, t_max, &t);
        const int kb = ok ? t_key(t) : INT_MAX;
        if (kb < best) {
          best = kb;
          lane = c0 + c4 * 4 + j;
        }
      }
    }
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
// int32. Needs PACKS * SPB * G <= 1024 threads, C_eff % 4 == 0, 16-byte
// aligned tbl and feats, and PACKS * 10 KB (at most) of shared memory.
// Returns cudaGetLastError() or the error of the shared-memory opt-in.
int raycore_packed_sweep(const void* block_subs, const void* block_cid,
                         const void* tbl, const void* feats, void* key_out,
                         void* pair_out, int n_blocks, int G, int SPB,
                         int PACKS, int C_eff, int SUBC, float edge_lo,
                         float edge_hi, void* stream) {
  const int ch = C_eff < LANE_CHUNK ? C_eff : LANE_CHUNK;
  const size_t smem = sizeof(float) * KFEAT * 4 * (size_t)ch * PACKS;
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
      SPB, PACKS, C_eff, SUBC, edge_lo, edge_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
