// K7: the subgroup refine of the regrouped stage 1.
//
// It replaces no TPU kernel: the JAX package runs this refine
// (raycore_tpu/ops/pallas_regroup.py:refine_pairs) as XLA operations. It
// was added because the H100 profile called for it: PyTorch ran the refine
// as about 125 elementwise operations over the (P, SPT) grid, each reading
// strided slices of the gathered stats, which took about 3.5 ms of an
// 11.6 ms 1M-ray shadow query and 1.2 ms of a 1M-ray primary query.
//
// For each coarse (tile, box) pair that phase A kept and each of the tile's
// SPT subgroups it bounds the entry t of any ray of the subgroup into the
// box: ops/regroup.py:refine_pairs_plain, ops/dense.py:interval_entry on the
// subgroup's stats, +inf where the subgroup provably misses the box.
//
// What bounds it on this card: the (P, SPT) float32 output write. At the
// shadow query's 2.85M entries that is 11.4 MB, 3.4 us at 3.35 TB/s; the
// subgroup stats (56 bytes a subgroup, 1.8 MB at 1M rays), the boxes and
// the 8 bytes of ids a pair are read from L2. The fast arithmetic is 45
// float operations an entry, 1.9 us at 67 TFLOP/s.
//
// Design: one thread an entry, THREADS a CTA, over a 1-D grid of P * SPT
// entries, the ragged edge masked. A thread reads its pair's tile and box
// ids (the same for a whole warp where SPT >= 32), its subgroup's stats
// row tid * SPT + s (consecutive threads, consecutive rows), the box's six
// bounds, and writes one float: consecutive threads, consecutive
// addresses. The entry is entry.cuh's entry_of, K1's arithmetic, so the
// kernel agrees with the plain version bit for bit;
// ops/regroup.py:refine_pairs_model repeats it.

#include "entry.cuh"

namespace {

using raycore::EntryBox;
using raycore::EntryStats;

constexpr int THREADS = 256;
constexpr int STATS_COLS = 14;

__global__ void __launch_bounds__(THREADS)
refine_pairs_kernel(const float* __restrict__ stats,
                    const int* __restrict__ tids,
                    const int* __restrict__ cids,
                    const float* __restrict__ bmin,
                    const float* __restrict__ bmax,
                    float* __restrict__ entry, unsigned n, unsigned SPT,
                    float clamp) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned p = i / SPT;
  const unsigned s = i - p * SPT;
  const size_t t = static_cast<unsigned>(__ldg(tids + p));
  const size_t c = static_cast<unsigned>(__ldg(cids + p));
  // A row is 56 bytes, so 8-byte aligned: seven float2 loads.
  const float2* row = reinterpret_cast<const float2*>(
      stats + (t * SPT + s) * STATS_COLS);
  EntryStats ts;
#pragma unroll
  for (int q = 0; q < STATS_COLS / 2; ++q) {
    const float2 v = __ldg(row + q);
    ts.st[2 * q] = v.x;
    ts.st[2 * q + 1] = v.y;
  }
  raycore::prepare_stats(ts, clamp);
  float blo[3], bhi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    blo[a] = __ldg(bmin + c * 3 + a);
    bhi[a] = __ldg(bmax + c * 3 + a);
  }
  const EntryBox b = raycore::make_box(blo, bhi);
  entry[i] = raycore::entry_of(ts, b, clamp);
}

}  // namespace

extern "C" {

// stats (n_sub, 14) float32, n_sub = n_tiles * SPT: cols o_lo(0:3)
// o_hi(3:6) i_lo(6:9) i_hi(9:12) t_min_lo(12) t_max_hi(13); tids, cids
// (P,) int32; bmin, bmax (K, 3) float32; entry (P, SPT) float32. P * SPT
// must fit 32 bits. Returns cudaGetLastError().
int raycore_refine_pairs(const void* stats, const void* tids,
                         const void* cids, const void* bmin,
                         const void* bmax, void* entry, int P, int SPT,
                         float clamp, void* stream) {
  const unsigned n = static_cast<unsigned>(P) * static_cast<unsigned>(SPT);
  if (n == 0) return static_cast<int>(cudaSuccess);
  refine_pairs_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stats), static_cast<const int*>(tids),
      static_cast<const int*>(cids), static_cast<const float*>(bmin),
      static_cast<const float*>(bmax), static_cast<float*>(entry), n,
      static_cast<unsigned>(SPT), clamp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
