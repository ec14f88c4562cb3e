// Tile-worklist sweep: closest hit of each ray tile against its candidate
// clusters.
//
// Replaces the TPU kernel raycore_tpu/ops/pallas_dense.py:_kernel and
// _kernel_body (launched by _run_worklist).
//
// The worklist lists (tile, cluster) blocks sorted by tile; tile t owns
// blocks [tile_start[t], tile_start[t + 1]). Each ray carries a packed key,
// the bits of its best t with the low `bits` mantissa bits replaced by the
// winning lane within a sub-chunk of CS = C / SUB triangles, and a pair id
// cid * C + s * CS + lane. The walk starts from key0 / pair0. Per block and
// sub-chunk s, every lane is tested with t in [tmin, t of the key held
// before the sub-chunk] (so the result depends on block order at the key's
// granularity, exactly as in the reference); the smallest candidate key
// replaces the held one if it is smaller. For SUB > 1 each ray first runs
// a slab test against the sub-chunk's box on [tmin, held t], and the CTA
// skips the sub-chunk when no ray of the tile enters it. Tiles with no
// block write key0 / pair0 unchanged.
//
// What bounds it on this card: arithmetic. Each (ray, triangle) test needs
// 19 fused multiply-adds (the nonzero terms of four dots) and, where it may
// pass, an IEEE reciprocal and the compares; a query makes blocks x TILE x
// C of them: at the 67 TFLOP/s non-tensor float32 rate at most 1.76 T
// tests per second. Memory traffic is a 19 KB cluster table per block
// (from L2 for clusters shared by neighbouring tiles) and 64 bytes of ray
// features per ray.
//
// Design: one CTA per ray tile and one thread per ray (TILE <= 1024, any
// size: a 1-ray query runs TILE = 8). The CTA walks its tile's blocks in
// worklist order, keeping (key, pair) in registers, so there is no merge
// across CTAs and no atomic: the reference's order of merges, which the
// truncated keys make visible, is kept exactly. The SUB > 1 slab skip ORs
// over every ray of the tile, so a tile stays one CTA. Per block the
// cluster's 19 nonzero table rows are staged in shared memory, 19 float4s
// per lane group (stage_sparse_table), and read as broadcasts, each
// feeding 4 fused multiply-adds (sparse_quads); a warp skips the divisions
// of a lane group when quick_reject shows every one of its tests must fail
// (maybe_lanes). The result is the 10-deep kernel's, bit for bit
// (featurized.cuh). The slab test uses explicitly rounded operations and
// NaN-propagating min/max in the plain version's order, since its skip
// decision changes results (the featurized test has edge slack).

#include "featurized.cuh"

namespace {

using namespace raycore;

__global__ void worklist_sweep_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ cids,
    const float* __restrict__ phi, const float* __restrict__ feats,
    const float* __restrict__ sub_bounds, const float* __restrict__ tmin,
    const int* __restrict__ key0, const int* __restrict__ pair0,
    int* __restrict__ key_out, int* __restrict__ pair_out, int TILE, int C,
    int SUB, int bits, float edge_lo, float edge_hi, float clamp) {
  extern __shared__ float4 table4[];   // SPARSE_TERMS float4s a lane group
  const int tile = blockIdx.x;
  const size_t row = (size_t)tile * TILE + threadIdx.x;
  const int b0 = tile_start[tile];
  const int b1 = tile_start[tile + 1];
  int key = key0[row];
  int pair = pair0[row];

  float ph[KFEAT];
  const float* prow = phi + row * FEAT;
  load_phi(prow, ph);
  const float o[3] = {prow[6], prow[7], prow[8]};
  const float invd[3] = {prow[10], prow[11], prow[12]};
  const float t_min = tmin[row];
  const bool tmin_nonneg = t_min >= 0.f;
  const bool live = finite_features(ph);   // else no lane can pass
  const int mask = (1 << bits) - 1;
  const int CS = C / SUB;
  const int CS4 = CS / 4;

  for (int b = b0; b < b1; ++b) {   // b0, b1 are uniform over the CTA
    const int cid = cids[b];
    __syncthreads();                 // the previous block's reads are done
    stage_sparse_table(table4, feats, cid, C, CS);
    __syncthreads();
    const float* sb = sub_bounds + (size_t)cid * 128;
    for (int s = 0; s < SUB; ++s) {
      const float cur_t = __int_as_float(key & ~mask);
      if (SUB > 1) {
        float lo = t_min;
        float hi = cur_t;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float bmin = sb[s * 6 + a];
          const float bmax = sb[s * 6 + 3 + a];
          const float t0 = __fmul_rn(__fsub_rn(bmin, o[a]), invd[a]);
          const float t1 = __fmul_rn(__fsub_rn(bmax, o[a]), invd[a]);
          const bool wide =
              fabsf(invd[a]) >= clamp && o[a] >= bmin && o[a] <= bmax;
          lo = max_prop(lo, wide ? -INFINITY : min_prop(t0, t1));
          hi = min_prop(hi, wide ? INFINITY : max_prop(t0, t1));
        }
        if (!__syncthreads_or(lo <= hi)) continue;   // uniform
      }
      int kmin = INT_MAX;
      for (int c4 = 0; c4 < CS4; ++c4) {
        float q[4][4];
        sparse_quads(table4 + (size_t)(s * CS4 + c4) * SPARSE_TERMS, ph, q);
        const unsigned may = live ? maybe_lanes(q, tmin_nonneg) : 0u;
        // A thread skips only when the vote, its own included, is false:
        // then every lane of its own is refused and the skip changes
        // nothing for it.
        if (!__any_sync(__activemask(), may != 0)) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t;
          if (((may >> j) & 1u) &&
              mt_accept(q, j, edge_lo, edge_hi, t_min, cur_t, &t)) {
            kmin = min(kmin, (t_key(t) & ~mask) | (c4 * 4 + j));
          }
        }
      }
      if (kmin < key) {
        key = kmin;
        pair = cid * C + s * CS + (kmin & mask);
      }
    }
  }
  key_out[row] = key;
  pair_out[row] = pair;
}

}  // namespace

extern "C" {

// tile_start (n_tiles + 1,) int32; cids (n_blocks,) int32; phi (R, 16)
// float32 with R = n_tiles * TILE; feats (K, 16, 4C) float32; sub_bounds
// (K, 1, 128) float32; tmin (R,) float32; key0, pair0, key_out, pair_out
// (R,) int32. Needs TILE <= 1024, (C / SUB) % 4 == 0, 16-byte aligned
// phi and feats, and the slack quick_reject assumes (REJECT_EDGE_LO,
// REJECT_EDGE_HI). Returns cudaGetLastError().
int raycore_worklist_sweep(const void* tile_start, const void* cids,
                           const void* phi, const void* feats,
                           const void* sub_bounds, const void* tmin,
                           const void* key0, const void* pair0, void* key_out,
                           void* pair_out, int n_tiles, int TILE, int C,
                           int SUB, int bits, float edge_lo, float edge_hi,
                           float clamp, void* stream) {
  if (edge_lo < REJECT_EDGE_LO || edge_hi > REJECT_EDGE_HI)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * SPARSE_TERMS * (size_t)C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        worklist_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  worklist_sweep_kernel<<<n_tiles, TILE, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(cids),
      static_cast<const float*>(phi), static_cast<const float*>(feats),
      static_cast<const float*>(sub_bounds), static_cast<const float*>(tmin),
      static_cast<const int*>(key0), static_cast<const int*>(pair0),
      static_cast<int*>(key_out), static_cast<int*>(pair_out), TILE, C, SUB,
      bits, edge_lo, edge_hi, clamp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
