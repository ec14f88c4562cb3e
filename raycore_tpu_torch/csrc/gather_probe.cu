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
//   ONEHOT  one CTA of 8 warps per step: the (512, NN) bf16 one-hot tile
//           times the bf16 table on the tensor cores (mma.sync.m16n8k16,
//           float32 accumulate). Warp w owns output columns 16w..16w+15.
//           The one-hot A fragments are built in registers from the step's
//           indices; the B fragments are read from the float32 table and
//           rounded to bf16 (round to nearest even). All 32 row tiles
//           accumulate into the same accumulator, which folds the sum over
//           the 512 rows into the product; 16 rows are left, and shuffles
//           add them. It does every product of the one-hot matrix: 2 * 512 *
//           NN * 128 operations per step, against 512 * 128 additions for
//           the gathers.
//
// What bounds it on this card: the gathers (LOOP, TAKE) the L2's latency and
// bandwidth (the table is read from device memory once; the bound counts
// that, the indices and the output, and one addition per fetched element);
// ONEHOT the tensor cores' rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values packed as an mma operand register: lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One-hot pair for columns c and c + 1 of a row whose index is c + d.
__device__ __forceinline__ uint32_t onehot_pair(int d) {
  return (d == 0 ? 0x3F80u : 0u) | (d == 1 ? 0x3F800000u : 0u);
}

__global__ void __launch_bounds__(WARPS * 32)
    gather_onehot_kernel(const int* __restrict__ idx,
                         const float* __restrict__ tbl,
                         float* __restrict__ out, int NN) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int* ids = idx + (size_t)blockIdx.x * R;
  // Row g and g + 8 of each of the 32 row tiles: this thread's A rows.
  int id[R / 16][2];
#pragma unroll
  for (int m = 0; m < R / 16; ++m) {
    id[m][0] = ids[m * 16 + g];
    id[m][1] = ids[m * 16 + g + 8];
  }
  float acc[2][4] = {};
  for (int k0 = 0; k0 < NN; k0 += 16) {
    uint32_t b[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* col = tbl + (size_t)(k0 + 2 * t) * W + w * 16 + nt * 8 + g;
      b[nt][0] = pack_bf16(__ldg(col), __ldg(col + W));
      b[nt][1] = pack_bf16(__ldg(col + 8 * W), __ldg(col + 9 * W));
    }
    const int c = k0 + 2 * t;
#pragma unroll
    for (int m = 0; m < R / 16; ++m) {
      const int d0 = id[m][0] - c, d1 = id[m][1] - c;
      const uint32_t a[4] = {onehot_pair(d0), onehot_pair(d1),
                             onehot_pair(d0 - 8), onehot_pair(d1 - 8)};
      mma_bf16(acc[0], a, b[0]);
      mma_bf16(acc[1], a, b[1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    // Columns 2t and 2t + 1: add rows g and g + 8, then the 8 groups.
    float lo = __fadd_rn(acc[nt][0], acc[nt][2]);
    float hi = __fadd_rn(acc[nt][1], acc[nt][3]);
#pragma unroll
    for (int s = 4; s < 32; s <<= 1) {
      lo = __fadd_rn(lo, __shfl_xor_sync(0xffffffffu, lo, s));
      hi = __fadd_rn(hi, __shfl_xor_sync(0xffffffffu, hi, s));
    }
    if (g == 0) {
      float* o = out + (size_t)blockIdx.x * W + w * 16 + nt * 8 + 2 * t;
      o[0] = lo;
      o[1] = hi;
    }
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
    case ONEHOT:
      gather_onehot_kernel<<<steps, WARPS * 32, 0, s>>>(
          i, static_cast<const float*>(tbl), static_cast<float*>(out), NN);
      break;
    case TAKE:
      gather_take_kernel<<<steps, WARPS * 32, 0, s>>>(
          i, static_cast<const float4*>(tbl), static_cast<float4*>(out));
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
