// Gather probe (P1): the cost of a per-lane row fetch from a resident table.
//
// Replaces the TPU kernels tools/tpu_gather_probe.py:_loop_kernel (rebuilt
// inline as `k` in run_pallas), _onehot_kernel and _take_kernel.
//
// Per step s: out[s] = the sum of the 512 rows tbl[idx[512 s + i]] of an
// (NN, 128) float32 table (the onehot variant: of the table rounded to
// bfloat16, summed in float32). On the TPU the table sits in VMEM; here a
// 4 MB table (NN = 8,192) does not fit in shared memory but sits in the
// 50 MB L2, so every fetch is an L2 hit after the first pass.
//
// Variants:
//   LOOP    one warp per step walks the step's 512 indices in order; lane l
//           accumulates columns 4l..4l+3 (one float4 per lane, so each row
//           fetch is one coalesced 512-byte read). 2,048 steps make only
//           2,048 warps: the card is far from full, as the TPU's loop is one
//           scalar-indexed read after another.
//   TAKE    one CTA of 8 warps per step: warp w fetches rows w, w + 8, ...
//           (64 rows, four in flight), then the 8 partial sums are added in
//           warp order through shared memory.
//   ONEHOT  the (512, NN) bf16 one-hot tile of a step times the bf16 table
//           on the tensor cores (wgmma m64n128k16 from shared memory,
//           float32 accumulate), the sum over the 512 rows folded into the
//           accumulator, then its last 64 rows added in a fixed order. It
//           does every product of the one-hot matrix: 2 * 512 * NN * 128
//           operations per step, against 512 * 128 additions for the
//           gathers. Design: below, at gather_onehot_kernel.
//
// What bounds it on this card: the gathers (LOOP, TAKE) the L2's latency and
// bandwidth (the table is read from device memory once; the bound counts
// that, the indices and the output, and one addition per fetched element);
// ONEHOT the tensor cores' rate (989 TFLOP/s in bf16). One-hot operands
// built in registers cost about 11 integer instructions a product, so the
// one-hot tile lives in shared memory, where only about 2 of its 512 rows
// change a K-tile; each table tile is staged once for two steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int R = 512;       // fetches per step
constexpr int W = 128;       // table row width (floats)
constexpr int WARPS = 8;     // warps per CTA

enum Variant { LOOP = 0, ONEHOT = 1, TAKE = 2 };

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__global__ void __launch_bounds__(WARPS * 32)
    gather_loop_kernel(const int* __restrict__ idx,
                       const float4* __restrict__ tbl4,
                       float4* __restrict__ out4, int steps) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= steps) return;
  const int* ids = idx + (size_t)s * R;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < R; i0 += 32) {
    const int mine = ids[i0 + lane];   // 32 indices, one per lane
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int row = __shfl_sync(0xffffffffu, mine, j);
      acc = add4(acc, __ldg(tbl4 + (size_t)row * (W / 4) + lane));
    }
  }
  out4[(size_t)s * (W / 4) + lane] = acc;
}

__global__ void __launch_bounds__(WARPS * 32)
    gather_take_kernel(const int* __restrict__ idx,
                       const float4* __restrict__ tbl4,
                       float4* __restrict__ out4) {
  __shared__ float4 part[WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int* ids = idx + (size_t)blockIdx.x * R;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = w; i < R; i += WARPS)
    acc = add4(acc, __ldg(tbl4 + (size_t)ids[i] * (W / 4) + lane));
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0) {
    float4 sum = part[0][lane];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) sum = add4(sum, part[k][lane]);
    out4[(size_t)blockIdx.x * (W / 4) + lane] = sum;
  }
}

// ONEHOT: persistent CTAs of four warpgroups. Warpgroups 0 and 1 each
// take one step of a pair; warpgroups 2 and 3 stream the table, alternate
// tiles each, through a ring of OH_STAGES bf16 K-tiles (KT table rows
// each), which both steps of the pair read, so each staged tile serves two
// steps. Per K-tile t a consumer warpgroup issues 8 x 2 wgmma m64n128k16:
// its step's (512, KT) one-hot tile, 8 blocks of 64 rows, times the (KT,
// 128) table tile, all into one 64 x 128 accumulator (the 512-row sum
// folded into the product). The one-hot tiles live in shared memory as
// zeros, two a warpgroup: while tile t's products run from one, a thread
// clears the 1.0 entries of tile t - 1 in the other (once its products have
// been waited on) and sets those of tile t + 1 among its four rows. So the
// step's indices are bucketed by K-tile with a test of the thread's four
// indices a tile, in registers, and no pass over shared memory. Every
// product of the one-hot matrix is still computed, the zeros included.
constexpr int KT = 32;                    // table rows per K-tile
constexpr int OH_STAGES = 4;              // table tiles in flight
constexpr int OH_PRODUCERS = 2;           // staging warpgroups
constexpr int OH_THREADS = (2 + OH_PRODUCERS) * 128;
constexpr int OH_SYNC = 3 * 128;          // a fill: its producer + 2 consumers
constexpr int ROW_BYTES = KT * 2;         // one K-major bf16 row: 64 B
constexpr int A_BYTES = R * ROW_BYTES;    // (512, 32) one-hot tile: 32 KB
constexpr int B_BYTES = W * ROW_BYTES;    // (32, 128) table tile: 8 KB
constexpr int RED_FLOATS = 4 * W;         // a warpgroup's per-warp sums
constexpr int OH_SMEM = 4 * A_BYTES + OH_STAGES * B_BYTES
                        + 2 * RED_FLOATS * 4 + 1024;
// Named barriers: FULL + s (a producer filled stage s), EMPTY + s (both
// consumers are done with it), WGBAR + w (consumer warpgroup w). Stage s
// is always filled by producer s % OH_PRODUCERS.
constexpr int FULL = 1, EMPTY = FULL + OH_STAGES, WGBAR = EMPTY + OH_STAGES;
constexpr uint16_t BF16_ONE = 0x3F80u;

// Two bf16 values packed as one 32-bit word: lo at the lower address.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Table rows KT t .. KT t + KT - 1 (zeros past NN), rounded to bf16, as
// the K-major (128 columns x KT rows) operand at dst. Thread i of a
// producer warpgroup reads rows KT t + 8 (i % 4) .. + 7 at columns
// 4 (i / 4) .. + 3, all 8 loads in flight, and writes four 16-byte chunks.
__device__ __forceinline__ void stage_table(const float* __restrict__ tbl,
                                            int NN, int t, unsigned char* dst,
                                            int i) {
  const int c = i & 3, q = i >> 2, k0 = t * KT + 8 * c;
  float4 v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    v[r] = k0 + r < NN
               ? __ldg(reinterpret_cast<const float4*>(
                           tbl + (size_t)(k0 + r) * W) + q)
               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 w = make_uint4(pack_bf16(comp(v[0], j), comp(v[1], j)),
                               pack_bf16(comp(v[2], j), comp(v[3], j)),
                               pack_bf16(comp(v[4], j), comp(v[5], j)),
                               pack_bf16(comp(v[6], j), comp(v[7], j)));
    *reinterpret_cast<uint4*>(
        dst + wg::swizzle((4 * q + j) * ROW_BYTES + 16 * c, ROW_BYTES)) = w;
  }
}

// Set (or clear) the one-hot entries of K-tile t among this thread's four
// rows, in the one-hot tile at a.
__device__ __forceinline__ void mark(unsigned char* a, const int tile[4],
                                     const uint32_t off[4], int t,
                                     uint16_t v) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (tile[j] == t) *reinterpret_cast<uint16_t*>(a + off[j]) = v;
}

__global__ void __launch_bounds__(OH_THREADS, 1)
    gather_onehot_kernel(const int* __restrict__ idx,
                         const float* __restrict__ tbl,
                         float* __restrict__ out, int NN, int steps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sA = wg::align1024(smem_raw);   // [2][2][512][64 B]
  unsigned char* const sB = sA + 4 * A_BYTES;          // [stages][128][64 B]
  float* const red = reinterpret_cast<float*>(sB + OH_STAGES * B_BYTES);
  const int tid = threadIdx.x, w = tid >> 7, i = tid & 127;
  const int tiles = (NN + KT - 1) / KT, pairs = (steps + 1) / 2;

  for (int k = tid; k < 4 * A_BYTES / 16; k += OH_THREADS)
    reinterpret_cast<uint4*>(sA)[k] = make_uint4(0u, 0u, 0u, 0u);
  wg::proxy_fence();
  __syncthreads();

  if (w >= 2) {   // producer w - 2: fills it with it % OH_PRODUCERS == w - 2
    int it = 0;
    for (int p = blockIdx.x; p < pairs; p += gridDim.x)
      for (int t = 0; t < tiles; ++t, ++it) {
        if (it % OH_PRODUCERS != w - 2) continue;
        const int s = it % OH_STAGES;
        if (it >= OH_STAGES) wg::bar_sync(EMPTY + s, OH_SYNC);
        stage_table(tbl, NN, t, sB + s * B_BYTES, i);
        wg::proxy_fence();
        wg::bar_arrive(FULL + s, OH_SYNC);
      }
    // Meet the consumers' last releases, so every barrier ends complete.
    for (int k = it < OH_STAGES ? 0 : it - OH_STAGES; k < it; ++k)
      if (k % OH_PRODUCERS == w - 2)
        wg::bar_sync(EMPTY + k % OH_STAGES, OH_SYNC);
    return;
  }

  unsigned char* const a[2] = {sA + 2 * w * A_BYTES,
                               sA + (2 * w + 1) * A_BYTES};
  const uint32_t a_addr = wg::smem_addr(a[0]), b_addr = wg::smem_addr(sB);
  float* const mine = red + w * RED_FLOATS;
  const int warp = i >> 5, lane = i & 31;
  float acc[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = 0.f;
  int it = 0;
  for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
    const int step = 2 * p + w;
    const bool live = step < steps;   // an odd last step leaves one idle
    int tile[4];
    uint32_t off[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = i + 128 * j;
      const int id = live ? idx[(size_t)step * R + row] : 0;
      tile[j] = live ? id / KT : -1;
      off[j] = wg::swizzle(row * ROW_BYTES + (id % KT) * 2, ROW_BYTES);
    }
    mark(a[0], tile, off, 0, BF16_ONE);
    wg::proxy_fence();
    wg::bar_sync(WGBAR + w, 128);                 // tile 0's entries are set
    wg::keep(acc);
    for (int t = 0; t < tiles; ++t, ++it) {
      const int s = it % OH_STAGES;
      wg::bar_sync(FULL + s, OH_SYNC);            // the table tile is staged
      wg::fence();
#pragma unroll
      for (int mb = 0; mb < R / 64; ++mb)
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          wg::mma_bf16_n128(
              acc,
              wg::desc(a_addr + (t & 1) * A_BYTES + mb * 64 * ROW_BYTES +
                           kk * 32, ROW_BYTES),
              wg::desc(b_addr + s * B_BYTES + kk * 32, ROW_BYTES),
              t | mb | kk);
      wg::commit();
      if (t > 0) {   // tile t - 1's products are done: release, clear
        wg::wait<1>();
        wg::bar_sync(WGBAR + w, 128);
        wg::bar_arrive(EMPTY + (it - 1) % OH_STAGES, OH_SYNC);
        mark(a[(t - 1) & 1], tile, off, t - 1, 0);
      }
      if (t + 1 < tiles) mark(a[(t + 1) & 1], tile, off, t + 1, BF16_ONE);
      wg::proxy_fence();
      wg::bar_sync(WGBAR + w, 128);               // tile t + 1's are set
    }
    wg::wait<0>();
    wg::keep(acc);
    wg::bar_sync(WGBAR + w, 128);
    wg::bar_arrive(EMPTY + (it - 1) % OH_STAGES, OH_SYNC);
    mark(a[(tiles - 1) & 1], tile, off, tiles - 1, 0);
    // The 64 rows left: rows g and g + 8 of each warp, then the 8 groups
    // of 4 lanes, then the 4 warps in order.
#pragma unroll
    for (int c = 0; c < W / 8; ++c) {
      float lo = __fadd_rn(acc[4 * c], acc[4 * c + 2]);
      float hi = __fadd_rn(acc[4 * c + 1], acc[4 * c + 3]);
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        lo = __fadd_rn(lo, __shfl_xor_sync(0xffffffffu, lo, m));
        hi = __fadd_rn(hi, __shfl_xor_sync(0xffffffffu, hi, m));
      }
      if (lane < 4) {
        mine[warp * W + 8 * c + 2 * lane] = lo;
        mine[warp * W + 8 * c + 2 * lane + 1] = hi;
      }
    }
    wg::bar_sync(WGBAR + w, 128);
    if (live)
      out[(size_t)step * W + i] = __fadd_rn(
          __fadd_rn(__fadd_rn(mine[i], mine[W + i]), mine[2 * W + i]),
          mine[3 * W + i]);
  }
}

}  // namespace

extern "C" {

// idx (steps * 512,) int32 in [0, NN); tbl (NN, 128) float32, 16-byte
// aligned; out (steps, 128) float32. ONEHOT needs NN % 16 == 0. Returns
// cudaGetLastError().
int raycore_gather_probe(const void* idx, const void* tbl, void* out, int NN,
                         int steps, int variant, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  switch (variant) {
    case LOOP:
      gather_loop_kernel<<<(steps + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
          i, static_cast<const float4*>(tbl), static_cast<float4*>(out),
          steps);
      break;
    case ONEHOT: {
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      const cudaError_t e = cudaFuncSetAttribute(
          gather_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          OH_SMEM);
      if (e != cudaSuccess) return static_cast<int>(e);
      const int pairs = (steps + 1) / 2;
      gather_onehot_kernel<<<pairs < sms ? pairs : sms, OH_THREADS, OH_SMEM,
                             s>>>(i, static_cast<const float*>(tbl),
                                  static_cast<float*>(out), NN, steps);
      break;
    }
    case TAKE:
      gather_take_kernel<<<steps, WARPS * 32, 0, s>>>(
          i, static_cast<const float4*>(tbl), static_cast<float4*>(out));
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
