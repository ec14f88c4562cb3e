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
// 8 MB at 512 tiles x 4096 clusters (2.5 us at 3.35 TB/s); the inputs are a
// few KB and stay in L1/L2. The plain arithmetic (48 NaN-propagating
// min/max, 12 differences and 24 products a pair) made it instruction-
// bound at about 15 times that; the fast arithmetic does 45 float
// operations a pair (1.4 us at 67 TFLOP/s over the same pairs).
//
// Design: a CTA of THREADS threads takes a span of THREADS * CPT clusters
// (CPT a thread, THREADS apart, their boxes in registers) and a strip of
// STRIP tiles, whose stats it stages in shared memory once; each thread
// walks the strip's tiles and writes CPT coalesced row segments a tile.
// The ragged edges are masked. Each pair's entry is entry.cuh's entry_of:
// the fast arithmetic, and the plain version's (ops/dense.py:phase_a_plain)
// outside its proven class or where it finds t_lo = 0. So the kernel
// agrees with the plain version bit for bit; ops/dense.py:phase_a_model
// repeats it.

#include "entry.cuh"

namespace {

using raycore::EntryBox;
using raycore::EntryStats;

constexpr int THREADS = 256;
constexpr int STRIP = 8;
constexpr int CPT = 2;

// Cluster k's box from the (6, K) bounds.
__device__ __forceinline__ EntryBox load_box(const float* bounds, int K,
                                             int k) {
  float blo[3], bhi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    blo[a] = bounds[a * K + k];
    bhi[a] = bounds[(3 + a) * K + k];
  }
  return raycore::make_box(blo, bhi);
}

__global__ void __launch_bounds__(THREADS)
phase_a_kernel(const float* __restrict__ stats,
               const float* __restrict__ bounds,
               float* __restrict__ entry, int n_tiles, int K, float clamp) {
  __shared__ EntryStats tiles[STRIP];
  const int k0 = blockIdx.x * THREADS * CPT + threadIdx.x;
  EntryBox box[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (k0 + c * THREADS < K) box[c] = load_box(bounds, K, k0 + c * THREADS);
  for (int t0 = blockIdx.y * STRIP; t0 < n_tiles; t0 += gridDim.y * STRIP) {
    const int n = min(STRIP, n_tiles - t0);
    __syncthreads();   // every thread is done with the previous strip
    for (int idx = threadIdx.x; idx < n * 16; idx += THREADS)
      tiles[idx / 16].st[idx % 16] = stats[(size_t)t0 * 16 + idx];
    __syncthreads();
    if (threadIdx.x < n) raycore::prepare_stats(tiles[threadIdx.x], clamp);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const EntryStats ts = tiles[j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int k = k0 + c * THREADS;
        if (k >= K) continue;
        entry[(size_t)(t0 + j) * K + k] =
            raycore::entry_of(ts, box[c], clamp);
      }
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// stats (n_tiles, 16) float32: cols o_lo(0:3) o_hi(3:6) i_lo(6:9)
// i_hi(9:12) t_min_lo(12) t_max_hi(13); bounds (6, K) float32: bmin xyz
// then bmax xyz; entry (n_tiles, K) float32. Returns cudaGetLastError().
int raycore_phase_a(const void* stats, const void* bounds, void* entry,
                    int n_tiles, int K, float clamp, void* stream) {
  const int strips = (n_tiles + STRIP - 1) / STRIP;
  const dim3 grid((K + THREADS * CPT - 1) / (THREADS * CPT),
                  strips < 65535 ? strips : 65535);
  phase_a_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stats), static_cast<const float*>(bounds),
      static_cast<float*>(entry), n_tiles, K, clamp);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on a grid of grid_x x grid_y CTAs of `threads`: the
// launch floor that a kernel of that grid cannot go below.
int raycore_empty_launch(int grid_x, int grid_y, int threads, void* stream) {
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Message for a CUDA error code returned by any entry point.
const char* raycore_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
