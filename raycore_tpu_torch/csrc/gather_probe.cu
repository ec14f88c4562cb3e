// Gather probe (P1): the cost of a per-lane row fetch from a resident table.
//
// Replaces the TPU kernels tools/tpu_gather_probe.py:_loop_kernel (rebuilt
// inline as `k` in run_pallas), _onehot_kernel and _take_kernel.
//
// Per step s: out[s] = the sum of the 512 rows tbl[idx[512 s + i]] of an
// (NN, 128) float32 table (the onehot variant: of the table rounded to
// bfloat16, summed in float32). On the TPU the table sits in VMEM, next to
// the compute. Here a 4 MB table (NN = 8,192) does not fit one SM's shared
// memory, but a 4-column slice of it does: LOOP and TAKE keep one slice a
// CTA in shared memory (the shared-memory tier) over the row counts where
// that was measured faster than reading whole rows from the 50 MB L2 (the
// L2 tier). The host picks the tier from NN alone
// (tools/gather_probe.py:gather_tier) and passes it as `cols`: 4 or 0.
//
// Shared-memory tier (4 columns a slice, one float4 a row):
//   A grid of 32 column slices x max(1, SMs / 32) step groups, so that
//   every CTA runs in one wave, one CTA an SM: 32 x 4 on 132 SMs. A CTA
//   stages its slice, NN rows of 16 bytes, once, then walks its group's
//   steps:
//   LOOP    one thread per step adds its 4 columns in index order, 0..511,
//           as the TPU's loop does. A warp's 32 steps read their indices in
//           chunks of 8 through a per-warp ring of 4 chunks in shared
//           memory, filled by cp.async 3 chunks ahead, 32 bytes a step.
//   TAKE    one warp per step: lane l adds rows 128 k + 4 l + j (k, j in
//           0..3, in that order) from four coalesced 16-byte index loads,
//           then a fixed xor-shuffle tree (16, 8, 4, 2, 1) adds the lanes.
// L2 tier (every other NN):
//   LOOP    one warp per step walks the step's 512 indices in order; lane l
//           accumulates columns 4l..4l+3 (one float4 per lane, so each row
//           fetch is one coalesced 512-byte read).
//   TAKE    one CTA of 8 warps per step: warp w fetches rows w, w + 8, ...
//           (64 rows, four in flight), then the 8 partial sums are added in
//           warp order through shared memory.
//   ONEHOT  (either tier) the (512, NN) bf16 one-hot tile of a step times
//           the bf16 table on the tensor cores (wgmma m64n128k16 from
//           shared memory, float32 accumulate), the sum over the 512 rows
//           folded into the accumulator, then its last 64 rows added in a
//           fixed order. It does every product of the one-hot matrix: 2 *
//           512 * NN * 128 operations per step, against 512 * 128 additions
//           for the gathers. Design: below, at gather_onehot_kernel.
// Each output element comes from one fixed sequence of float32 roundings
// (tools/gather_probe.py:run_gather_model), with no atomics.
//
// What bounds it on this card: the function moves the table, the indices
// and the output once (the bound counts that and one addition per fetched
// element), but every fetched row passes an SM's load path: 512 B a fetch,
// 536.9 MB at the tool's defaults, over 132 SMs x 128 B a clock. The L2
// tier reads those bytes from the L2, at about its bandwidth. The
// shared-memory tier reads them from the SMs' own shared memory, where a
// warp's 32 random rows collide in the banks; those conflicts, not the
// index stream (every slice reads every index from the L2, while the
// gathers run), set its time (PERF.md, P1). ONEHOT is bound by the
// tensor cores' rate (989 TFLOP/s in bf16). One-hot operands built in
// registers cost about 11 integer instructions a product, so the one-hot
// tile lives in shared memory, where only about 2 of its 512 rows change
// a K-tile; each table tile is staged once for two steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int R = 512;       // fetches per step
constexpr int W = 128;       // table row width (floats)
constexpr int WARPS = 8;     // warps per CTA

enum Variant { LOOP = 0, ONEHOT = 1, TAKE = 2 };

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
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
      acc = add(acc, __ldg(tbl4 + (size_t)row * (W / 4) + lane));
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
    acc = add(acc, __ldg(tbl4 + (size_t)ids[i] * (W / 4) + lane));
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0) {
    float4 sum = part[0][lane];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) sum = add(sum, part[k][lane]);
    out4[(size_t)blockIdx.x * (W / 4) + lane] = sum;
  }
}

// The shared-memory tier. A slice (SLICE_BYTES a row) and, for LOOP, the
// warps' index rings must fit in the card's opt-in shared memory a block;
// the launch refuses a table whose slice does not.
constexpr int SLICES = W / 4;                    // 4-column slices
constexpr int SLICE_BYTES = 16;                  // a row of a slice
constexpr int SM_WARPS = 16;
constexpr int SM_THREADS = SM_WARPS * 32;
constexpr int CHUNK = 8;                         // indices a step stages
constexpr int RING = 4;                          // chunks a warp's ring holds
constexpr int SLOTS = CHUNK / 4 * 32;            // int4 slots of a chunk
constexpr int SM_IDX_BYTES = SM_WARPS * RING * SLOTS * 16;   // 64 KB

__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ float2 shfl_xor(float2 v, int m) {
  return make_float2(shfl_xor(v.x, m), shfl_xor(v.y, m));
}

// The xor tree m, m / 2, ..., 1 over the warp's lanes of each component:
// at each level a lane adds its partner's value to its own. A lane keeps
// only half of the components it carries at each of the first levels
// (the half its bit m selects) and sends its partner the other half, so
// the tree takes 2 + 1 + 1 + 1 + 1 shuffles for a float4, not 4 x 5; each
// component's sums pair as in the full tree. Component c of a float4
// ends in lane 8 c.
__device__ __forceinline__ float lane_tree(float v, int lane, int m) {
  for (; m > 0; m >>= 1) v = add(v, shfl_xor(v, m));
  return v;
}
__device__ __forceinline__ float lane_tree(float2 v, int lane, int m) {
  const bool hi = lane & m;
  return lane_tree(add(hi ? v.y : v.x, shfl_xor(hi ? v.x : v.y, m)), lane,
                   m >> 1);
}
__device__ __forceinline__ float lane_tree(float4 v, int lane, int m) {
  const bool hi = lane & m;
  const float2 keep = hi ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
  const float2 send = hi ? make_float2(v.x, v.y) : make_float2(v.z, v.w);
  return lane_tree(add(keep, shfl_xor(send, m)), lane, m >> 1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slot of (quad q, step t) in a warp's chunk of 32 steps x CHUNK indices:
// step t reads quad q at slot q * 32 + t' with t' a rotation of t within
// its 8, so that 8 neighbouring lanes, which read one quad of 8 steps or
// (filling) CHUNK / 4 quads of 32 / CHUNK steps, meet 8 distinct 16-byte
// bank groups.
__device__ __forceinline__ int slot(int q, int t) {
  return q * 32 + ((t & ~7) | ((t + q * (32 / CHUNK)) & 7));
}

// The CTA's slice of columns 4 blockIdx.x .. + 3, NN rows of a float4,
// staged into shared memory once.
__device__ __forceinline__ const float4* stage_slice(
    const float* __restrict__ tbl, int NN, unsigned char* smem) {
  float4* slice = reinterpret_cast<float4*>(smem);
  const float4* src = reinterpret_cast<const float4*>(tbl) + blockIdx.x;
#pragma unroll 4
  for (int r = threadIdx.x; r < NN; r += SM_THREADS)
    slice[r] = __ldg(src + (size_t)r * SLICES);
  __syncthreads();
  return slice;
}

// LOOP, shared-memory tier: CTA (slice, group) takes the steps [s0, s1) of
// its group in batches of 32 a warp; thread (step s) adds its 4 columns of
// the step's 512 rows in index order.
__global__ void __launch_bounds__(SM_THREADS, 1)
    gather_loop_slices(const int* __restrict__ idx,
                       const float* __restrict__ tbl, float* __restrict__ out,
                       int NN, int steps, int per) {
  extern __shared__ __align__(16) unsigned char slice_smem[];
  const int s0 = blockIdx.y * per, s1 = min(steps, s0 + per);
  if (s0 >= s1) return;
  const float4* slice = stage_slice(tbl, NN, slice_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4* const ring = reinterpret_cast<int4*>(slice_smem + NN * SLICE_BYTES) +
                     warp * RING * SLOTS;
  for (int b = s0 + 32 * warp; b < s1; b += SM_THREADS) {
    // Chunk k of the 32 steps b..b + 31 into ring slot k % RING, CHUNK / 4
    // lanes a step. A step past s1 copies step s1 - 1's indices, so its
    // lane reads valid rows; it stores nothing.
    const auto fill = [&](int k) {
      int4* dst = ring + (k % RING) * SLOTS;
#pragma unroll
      for (int r = 0; r < CHUNK / 4; ++r) {
        const int u = 32 * r + lane, t = u / (CHUNK / 4), q = u % (CHUNK / 4);
        const int step = min(b + t, s1 - 1);
        cp_async16(dst + slot(q, t),
                   idx + (size_t)step * R + k * CHUNK + 4 * q);
      }
      cp_commit();
    };
    float4 acc{};
#pragma unroll
    for (int k = 0; k < RING - 1; ++k) fill(k);
#pragma unroll 4
    for (int k = 0; k < R / CHUNK; ++k) {
      // Keep RING - 1 chunks in flight; past the last chunk, empty groups.
      if (k + RING - 1 < R / CHUNK) fill(k + RING - 1);
      else cp_commit();
      cp_wait<RING - 1>();
      __syncwarp();
      const int4* src = ring + (k % RING) * SLOTS;
      int4 id[CHUNK / 4];
#pragma unroll
      for (int q = 0; q < CHUNK / 4; ++q) id[q] = src[slot(q, lane)];
      __syncwarp();   // every lane has read slot k % RING before its refill
#pragma unroll
      for (int q = 0; q < CHUNK / 4; ++q) {
        acc = add(acc, slice[id[q].x]);
        acc = add(acc, slice[id[q].y]);
        acc = add(acc, slice[id[q].z]);
        acc = add(acc, slice[id[q].w]);
      }
    }
    if (b + lane < s1)
      reinterpret_cast<float4*>(out + (size_t)(b + lane) * W)[blockIdx.x] =
          acc;
  }
}

// TAKE, shared-memory tier: warp w takes steps s0 + w, s0 + w + 16, ...;
// lane l adds rows 128 k + 4 l + j (k-major, then j) of its slice, then the
// lanes are added by the xor tree 16, 8, 4, 2, 1 (lane_tree). The next
// step's indices are loaded while this step's rows are added.
__global__ void __launch_bounds__(SM_THREADS, 1)
    gather_take_slices(const int* __restrict__ idx,
                       const float* __restrict__ tbl, float* __restrict__ out,
                       int NN, int steps, int per) {
  extern __shared__ __align__(16) unsigned char slice_smem[];
  const int s0 = blockIdx.y * per, s1 = min(steps, s0 + per);
  if (s0 >= s1) return;
  const float4* slice = stage_slice(tbl, NN, slice_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const auto load = [&](int s, int4 (&dst)[4]) {
    const int4* src = reinterpret_cast<const int4*>(idx + (size_t)s * R) + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = __ldg(src + 32 * k);
  };
  int4 id[4];
  if (s0 + warp < s1) load(s0 + warp, id);
  for (int s = s0 + warp; s < s1; s += SM_WARPS) {
    int4 cur[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = id[k];
    if (s + SM_WARPS < s1) load(s + SM_WARPS, id);
    float4 acc{};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc = add(acc, slice[cur[k].x]);
      acc = add(acc, slice[cur[k].y]);
      acc = add(acc, slice[cur[k].z]);
      acc = add(acc, slice[cur[k].w]);
    }
    const float sum = lane_tree(acc, lane, 16);
    if (lane % 8 == 0) out[(size_t)s * W + 4 * blockIdx.x + lane / 8] = sum;
  }
}

cudaError_t launch_slices(int variant, const int* idx, const float* tbl,
                          float* out, int NN, int steps, cudaStream_t s) {
  int dev = 0, sms = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  const int groups = sms / SLICES > 1 ? sms / SLICES : 1;
  const int per = (steps + groups - 1) / groups;
  const size_t smem = (size_t)NN * SLICE_BYTES +
                      (variant == LOOP ? SM_IDX_BYTES : 0);
  if (smem > (size_t)most) return cudaErrorInvalidValue;
  void (*kernel)(const int*, const float*, float*, int, int, int) =
      variant == LOOP ? gather_loop_slices : gather_take_slices;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(SLICES, groups), SM_THREADS, smem, s>>>(idx, tbl, out, NN,
                                                        steps, per);
  return cudaGetLastError();
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

// idx (steps * 512,) int32 in [0, NN); tbl (NN, 128) float32; out (steps,
// 128) float32; all 16-byte aligned. cols: the tier of LOOP and TAKE, 4
// for the shared-memory slices (refused where a slice does not fit) or 0
// for the L2 tier; ONEHOT ignores it and needs NN % 16 == 0. Returns the
// first CUDA error of the launch.
int raycore_gather_probe(const void* idx, const void* tbl, void* out, int NN,
                         int steps, int variant, int cols, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* t = static_cast<const float*>(tbl);
  float* o = static_cast<float*>(out);
  if (cols != 0 && cols != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (cols == 4 && (variant == LOOP || variant == TAKE))
    return static_cast<int>(launch_slices(variant, i, t, o, NN, steps, s));
  switch (variant) {
    case LOOP:
      gather_loop_kernel<<<(steps + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
          i, reinterpret_cast<const float4*>(t), reinterpret_cast<float4*>(o),
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
                             s>>>(i, t, o, NN, steps);
      break;
    }
    case TAKE:
      gather_take_kernel<<<steps, WARPS * 32, 0, s>>>(
          i, reinterpret_cast<const float4*>(t), reinterpret_cast<float4*>(o));
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
