// Phase A: conservative ray-tile vs cluster-AABB entry bounds.
//
// Replaces the TPU kernel raycore_tpu/ops/pallas_dense.py:_phase_a_kernel
// (launched by _phase_a_fast from phase_a_entry_bounds).
//
// For each (ray tile, cluster) pair it bounds the entry t of any ray in the
// tile into the cluster's AABB by interval arithmetic on the tile's stats
// (origin and inverse-direction ranges, t range): per axis the min and max
// of the 8 corner products, widened to (-inf, inf) where a near-parallel
// ray of the bundle may start inside the slab. +inf marks a culled pair.
//
// What bounds it on this card: the (n_tiles, K) float32 output write, about
// 8 MB at 512 tiles x 4096 clusters, against some 40 flops per element;
// the inputs are a few KB and stay in L1/L2. So it is a store-bandwidth
// kernel of a few microseconds, dominated by launch cost.
//
// Design: one thread per (tile, cluster) element, clusters on gridDim.x
// (K can exceed gridDim.y's 65535 limit) and tiles on gridDim.y with a
// grid-stride loop over tiles. Consecutive threads write consecutive
// clusters of one tile row, so the stores coalesce; the tile's 14 stats are
// the same address for the whole block (a broadcast load). The ragged edge
// of K is masked, so nothing is padded. The arithmetic repeats the plain
// version (ops/dense.py:phase_a_plain) in the same order with explicitly
// rounded operations and PyTorch's NaN-propagating min/max, so the two
// agree bit for bit.

#include "featurized.cuh"

namespace {

using raycore::max_prop;
using raycore::min_prop;

__global__ void phase_a_kernel(const float* __restrict__ stats,
                               const float* __restrict__ bounds,
                               float* __restrict__ entry, int n_tiles, int K,
                               float clamp) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float blo[3], bhi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    blo[a] = bounds[a * K + k];
    bhi[a] = bounds[(3 + a) * K + k];
  }
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const float* st = stats + (size_t)tile * 16;
    float t_lo = -INFINITY;
    float t_hi = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float oc[2] = {st[a], st[3 + a]};
      const float ic[2] = {st[6 + a], st[9 + a]};
      const float bb[2] = {blo[a], bhi[a]};
      float lo8 = INFINITY;
      float hi8 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float diff = __fsub_rn(bb[i], oc[j]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float prod = __fmul_rn(diff, ic[m]);
            lo8 = min_prop(lo8, prod);
            hi8 = max_prop(hi8, prod);
          }
        }
      }
      const bool par = (ic[1] >= clamp) || (ic[0] <= -clamp);
      const bool ovl = (oc[1] >= bb[0]) && (oc[0] <= bb[1]);
      const bool wide = par && ovl;
      t_lo = max_prop(t_lo, wide ? -INFINITY : lo8);
      t_hi = min_prop(t_hi, wide ? INFINITY : hi8);
    }
    const float e = max_prop(t_lo, st[12]);
    const float x = min_prop(t_hi, st[13]);
    entry[(size_t)tile * K + k] = (e <= x) ? e : INFINITY;
  }
}

}  // namespace

extern "C" {

// stats (n_tiles, 16) float32: cols o_lo(0:3) o_hi(3:6) i_lo(6:9)
// i_hi(9:12) t_min_lo(12) t_max_hi(13); bounds (6, K) float32: bmin xyz
// then bmax xyz; entry (n_tiles, K) float32. Returns cudaGetLastError().
int raycore_phase_a(const void* stats, const void* bounds, void* entry,
                    int n_tiles, int K, float clamp, void* stream) {
  const int threads = 256;
  const int grid_y = n_tiles < 65535 ? n_tiles : 65535;
  const dim3 grid((K + threads - 1) / threads, grid_y);
  phase_a_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stats), static_cast<const float*>(bounds),
      static_cast<float*>(entry), n_tiles, K, clamp);
  return static_cast<int>(cudaGetLastError());
}

// Message for a CUDA error code returned by any entry point.
const char* raycore_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
