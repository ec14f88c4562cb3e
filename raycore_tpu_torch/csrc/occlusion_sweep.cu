// Occlusion sweep: any hit of each ray tile against its candidate clusters.
//
// Replaces the TPU kernel raycore_tpu/ops/pallas_dense.py:_occl_kernel
// (launched by _run_occlusion).
//
// The worklist is the closest-hit one: (tile, cluster) blocks sorted by
// tile, tile t owning blocks [tile_start[t], tile_start[t + 1]). Per ray
// the first accepted triangle wins: the first block in worklist order with
// an accepted lane, and in it the smallest lane in triangle order (lane
// s * CS + j of sub-chunk s). A lane is accepted with barycentric slack
// [edge_lo, edge_hi] and t in [tmin, tmax], the ray's own range. The
// result is the occluder pair cid * C + lane, -1 for a free ray.
//
// What bounds it on this card: arithmetic, as the closest-hit sweeps (19
// fused multiply-adds per (ray, triangle) test at the 67 TFLOP/s
// non-tensor float32 rate), but only for the tests a ray needs: up to its
// first accepted lane.
//
// Design: one CTA per ray tile and one thread per ray, walking the tile's
// blocks in worklist order with the cluster's 19 nonzero table rows staged
// in shared memory (stage_sparse_table) and read as broadcasts, each
// feeding 4 fused multiply-adds (sparse_quads); a warp skips the divisions
// of a lane group when quick_reject shows every one of its tests must fail
// (maybe_lanes; all in featurized.cuh, bit for bit with the 10-deep
// kernel). Before each block a __syncthreads_or over "still free" ends the
// walk once the whole tile is occluded (the reference skips those blocks
// one by one). A thread whose ray is occluded runs no lanes; a free ray
// stops at its first accepted lane in ascending order. Neither shortcut
// changes the result. Unlike the reference, which reads columns k * C + j,
// the kernel reads the sub-chunk-major layout (column s * 4CS + k * CS +
// j), so scenes with sub_chunks > 1 report genuine occluders; for
// sub_chunks == 1 the two are the same column.

#include "featurized.cuh"

namespace {

using namespace raycore;

__global__ void occlusion_sweep_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ cids,
    const float* __restrict__ phi, const float* __restrict__ feats,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int* __restrict__ pair_out, int TILE, int C, int SUB, float edge_lo,
    float edge_hi) {
  extern __shared__ float4 table4[];   // SPARSE_TERMS float4s a lane group
  const int tile = blockIdx.x;
  const size_t row = (size_t)tile * TILE + threadIdx.x;
  const int b0 = tile_start[tile];
  const int b1 = tile_start[tile + 1];
  float ph[KFEAT];
  load_phi(phi + row * FEAT, ph);
  const float t_min = tmin[row];
  const float t_max = tmax[row];
  const bool tmin_nonneg = t_min >= 0.f;
  const bool live = finite_features(ph);   // else no lane can pass
  const int CS = C / SUB;
  const int CS4 = CS / 4;
  int pair = -1;

  for (int b = b0; b < b1; ++b) {   // b0, b1 are uniform over the CTA
    // Also the barrier after the previous block's table reads.
    if (!__syncthreads_or(pair < 0)) break;   // the whole tile is occluded
    const int cid = cids[b];
    stage_sparse_table(table4, feats, cid, C, CS);
    __syncthreads();
    if (!live || pair >= 0) continue;
    int lane = -1;
    for (int s = 0; s < SUB && lane < 0; ++s) {
      for (int c4 = 0; c4 < CS4 && lane < 0; ++c4) {
        float q[4][4];
        sparse_quads(table4 + (size_t)(s * CS4 + c4) * SPARSE_TERMS, ph, q);
        const unsigned may = maybe_lanes(q, tmin_nonneg);
        // Threads leave these loops at different lane groups, so the vote
        // may cover part of the warp. A thread skips only when the vote,
        // its own included, is false: then every lane of its own is
        // refused and the skip changes nothing for it.
        if (!__any_sync(__activemask(), may != 0)) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t;
          if (((may >> j) & 1u) && lane < 0 &&
              mt_accept(q, j, edge_lo, edge_hi, t_min, t_max, &t)) {
            lane = s * CS + c4 * 4 + j;
          }
        }
      }
    }
    if (lane >= 0) pair = cid * C + lane;
  }
  pair_out[row] = pair;
}

}  // namespace

extern "C" {

// tile_start (n_tiles + 1,) int32; cids (n_blocks,) int32; phi (R, 16)
// float32 with R = n_tiles * TILE; feats (K, 16, 4C) float32; tmin, tmax
// (R,) float32; pair_out (R,) int32. Needs TILE <= 1024, (C / SUB) % 4 == 0,
// 16-byte aligned phi and feats, and the slack quick_reject assumes
// (REJECT_EDGE_LO, REJECT_EDGE_HI). Returns cudaGetLastError().
int raycore_occlusion_sweep(const void* tile_start, const void* cids,
                            const void* phi, const void* feats,
                            const void* tmin, const void* tmax, void* pair_out,
                            int n_tiles, int TILE, int C, int SUB,
                            float edge_lo, float edge_hi, void* stream) {
  if (edge_lo < REJECT_EDGE_LO || edge_hi > REJECT_EDGE_HI)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * SPARSE_TERMS * (size_t)C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        occlusion_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  occlusion_sweep_kernel<<<n_tiles, TILE, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(cids),
      static_cast<const float*>(phi), static_cast<const float*>(feats),
      static_cast<const float*>(tmin), static_cast<const float*>(tmax),
      static_cast<int*>(pair_out), TILE, C, SUB, edge_lo, edge_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
