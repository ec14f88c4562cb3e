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
// The ragged edges are masked. Every pair takes the fast arithmetic
// (entry_fast); where the tile's stats or the box lie outside the class
// in which that is proven exact, or where it finds t_lo = 0, the pair is
// recomputed with the plain version's arithmetic (entry_plain:
// ops/dense.py:phase_a_plain in the same order with explicitly rounded
// operations and PyTorch's NaN-propagating min/max). So the kernel agrees
// with the plain version bit for bit; ops/dense.py:phase_a_model repeats
// it.

#include "featurized.cuh"

namespace {

using raycore::max_prop;
using raycore::min_prop;

constexpr int THREADS = 256;
constexpr int STRIP = 8;
constexpr int CPT = 2;

// One tile's stats as a CTA stages them: the row itself (o_lo 0:3, o_hi
// 3:6, i_lo 6:9, i_hi 9:12, t_min_lo 12, t_max_hi 13), the origin range
// ordered, and flags: bit a (0-2) where axis a's inverse direction reaches
// the clamp (a bundle parallel to the slab), bit 3 where the tile is in
// entry_fast's class.
struct TileStats {
  float st[16];
  float omn[3], omx[3];
  int flags;
};

constexpr int FAST_TILE = 8;

// The plain version's arithmetic for one pair.
__device__ __forceinline__ float entry_plain(const float* st,
                                             const float blo[3],
                                             const float bhi[3], float clamp) {
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
  return (e <= x) ? e : INFINITY;
}

// The same entry with fewer operations, for a tile whose o_lo, o_hi, i_lo
// and i_hi are finite with i_lo, i_hi != 0 and whose t_min_lo and t_max_hi
// are not NaN, against a box whose six bounds are finite (bmn, bmx: the
// box's bounds ordered). Returns the entry, or NaN (which this arithmetic
// never gives) where the caller must recompute it with entry_plain.
//
// Why it is exact. No product is NaN: a difference of finite numbers is
// finite or +-inf, and i is finite and nonzero. So lo8 and hi8 are the
// min and max of the 8 products as values. x -> RN(x - o) is
// non-decreasing and o -> RN(b - o) non-increasing, so the 4 differences
// lie between dmin = RN(min(blo, bhi) - max(o_lo, o_hi)) and dmax =
// RN(max(blo, bhi) - min(o_lo, o_hi)), both among them; for a fixed i,
// d -> RN(d i) is monotone, so the 8 products' min and max are those of
// the 4 products of {dmin, dmax} x {i_lo, i_hi}. Every value that follows
// (t_lo, t_hi, entry, exit) is then the plain version's as a value, none
// is NaN and the compares agree. A nonzero value has one bit pattern, so
// the bits agree too unless t_lo is zero, whose sign depends on which zero
// each min and max kept: the caller recomputes those pairs. (Where t_lo <
// 0 and t_min_lo is +-0, the entry is t_min_lo's own bits in both.) wide
// is the plain version's test on the same operands.
__device__ __forceinline__ float entry_fast(const TileStats& ts,
                                            const float blo[3],
                                            const float bhi[3],
                                            const float bmn[3],
                                            const float bmx[3]) {
  float t_lo = -INFINITY;
  float t_hi = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dmin = __fsub_rn(bmn[a], ts.omx[a]);
    const float dmax = __fsub_rn(bmx[a], ts.omn[a]);
    const float i_lo = ts.st[6 + a], i_hi = ts.st[9 + a];
    const float p0 = __fmul_rn(dmin, i_lo), p1 = __fmul_rn(dmin, i_hi);
    const float p2 = __fmul_rn(dmax, i_lo), p3 = __fmul_rn(dmax, i_hi);
    const float lo8 = fminf(fminf(p0, p1), fminf(p2, p3));
    const float hi8 = fmaxf(fmaxf(p0, p1), fmaxf(p2, p3));
    const bool wide = ((ts.flags >> a) & 1) && (ts.st[3 + a] >= blo[a]) &&
                      (ts.st[a] <= bhi[a]);
    t_lo = fmaxf(t_lo, wide ? -INFINITY : lo8);
    t_hi = fminf(t_hi, wide ? INFINITY : hi8);
  }
  const float e = fmaxf(t_lo, ts.st[12]);
  const float x = fminf(t_hi, ts.st[13]);
  return t_lo == 0.f ? NAN : ((e <= x) ? e : INFINITY);
}

__device__ __forceinline__ bool is_finite(float v) {
  return fabsf(v) < INFINITY;
}

// One cluster's box as a thread keeps it: the bounds, the bounds ordered,
// and whether entry_fast's class holds for it.
struct Box {
  float blo[3], bhi[3], bmn[3], bmx[3];
  bool fast;
};

__device__ __forceinline__ Box load_box(const float* bounds, int K, int k) {
  Box b;
  b.fast = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.blo[a] = bounds[a * K + k];
    b.bhi[a] = bounds[(3 + a) * K + k];
    b.bmn[a] = fminf(b.blo[a], b.bhi[a]);
    b.bmx[a] = fmaxf(b.blo[a], b.bhi[a]);
    b.fast = b.fast && is_finite(b.blo[a]) && is_finite(b.bhi[a]);
  }
  return b;
}

__global__ void __launch_bounds__(THREADS)
phase_a_kernel(const float* __restrict__ stats,
               const float* __restrict__ bounds,
               float* __restrict__ entry, int n_tiles, int K, float clamp) {
  __shared__ TileStats tiles[STRIP];
  const int k0 = blockIdx.x * THREADS * CPT + threadIdx.x;
  Box box[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (k0 + c * THREADS < K) box[c] = load_box(bounds, K, k0 + c * THREADS);
  for (int t0 = blockIdx.y * STRIP; t0 < n_tiles; t0 += gridDim.y * STRIP) {
    const int n = min(STRIP, n_tiles - t0);
    __syncthreads();   // every thread is done with the previous strip
    for (int idx = threadIdx.x; idx < n * 16; idx += THREADS)
      tiles[idx / 16].st[idx % 16] = stats[(size_t)t0 * 16 + idx];
    __syncthreads();
    if (threadIdx.x < n) {
      TileStats& ts = tiles[threadIdx.x];
      bool fast = !isnan(ts.st[12]) && !isnan(ts.st[13]);
      int flags = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float o_lo = ts.st[a], o_hi = ts.st[3 + a];
        const float i_lo = ts.st[6 + a], i_hi = ts.st[9 + a];
        ts.omn[a] = fminf(o_lo, o_hi);
        ts.omx[a] = fmaxf(o_lo, o_hi);
        fast = fast && is_finite(o_lo) && is_finite(o_hi) &&
               is_finite(i_lo) && is_finite(i_hi) && i_lo != 0.f &&
               i_hi != 0.f;
        flags |= ((i_hi >= clamp) || (i_lo <= -clamp)) << a;
      }
      ts.flags = flags | (fast ? FAST_TILE : 0);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const TileStats ts = tiles[j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int k = k0 + c * THREADS;
        if (k >= K) continue;
        const Box& b = box[c];
        // entry_fast runs on every pair, in its class or not (it cannot
        // trap), so that the common path has no branch.
        float e = entry_fast(ts, b.blo, b.bhi, b.bmn, b.bmx);
        if (!(b.fast & ((ts.flags & FAST_TILE) != 0))) e = NAN;
        if (isnan(e)) e = entry_plain(ts.st, b.blo, b.bhi, clamp);
        entry[(size_t)(t0 + j) * K + k] = e;
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
