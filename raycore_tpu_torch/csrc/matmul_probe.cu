// Matmul probe (P3): the cost of a small-depth contraction by precision.
//
// Replaces the TPU kernel tools/probe_matmul_shapes.py:make_fn (its inner
// kernel, launched over a grid of `steps`).
//
// Each of `steps` CTAs computes the whole (M, K) x (K, N) product of the
// same two operands and writes its M row sums to out. Every CTA writes the
// same values in the same order of operations, as every TPU grid step
// writes output block (0, 0); the repeated writes are harmless. The product
// accumulates in float32.
//
// How each TPU precision tier maps to Hopper (variant):
//   FMA     highest, float32: float32 fused multiply-adds on the CUDA
//           cores, the arithmetic of the sweep kernels (K2-K5) today;
//   TF32    default, float32: one mma.sync.m16n8k8 TF32 pass, each input
//           rounded to TF32 (cvt.rna), what XLA does for DEFAULT on a GPU;
//   TF32X3  high, float32: 3xTF32, Hopper's error-compensated tier and the
//           counterpart of the TPU's bf16_3x: each input split into a TF32
//           high part and a TF32 low part (x - hi, taken in float32), and
//           the products lo*hi, hi*lo and hi*hi accumulated in that order;
//   BF16    bfloat16 inputs (any tier): one mma.sync.m16n8k16 bf16 pass.
//
// What bounds it on this card: operations, 2*M*K*N per step against the
// tier's unit (67 TFLOP/s float32, 495 TF32 with 3xTF32 counting three
// passes, 989 bf16). The operands (at most 256 KB each) stay in L2 and L1.
//
// Design: 256 threads per CTA. The CTA walks the rows in tiles of 128 and
// the columns in chunks of 64, staging the A tile (128 x K) and the
// transposed B chunk (64 x K) in shared memory with rows padded so that the
// fragment loads hit 32 distinct banks. mma.sync tiers: warp w owns rows
// 16w..16w+15 of the tile and all 64 columns (eight m16n8 accumulators);
// each A fragment is loaded (and split) once per k-step and reused for the
// eight column tiles. FMA tier: thread i owns row i % 128 and 32 columns;
// all lanes of a warp read the same B row at once, a broadcast. Row sums
// are reduced with shuffles or through shared memory in a fixed order, so
// every CTA writes the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MT = 128;   // rows of A per tile
constexpr int NT = 64;    // columns of B per chunk

enum Variant { FMA = 0, TF32 = 1, TF32X3 = 2, BF16 = 3 };

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory row length in elements: K plus 16 bytes of padding.
template <typename T>
__host__ __device__ constexpr int row_len(int K) {
  return K + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__device__ __forceinline__ uint32_t word(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The eight m16n8 accumulators of warp w's 16 rows against the staged
// 64-column chunk, for the mma.sync tiers.
template <typename T, int V>
__device__ __forceinline__ void mma_chunk(const T* sA, const T* sB, int K,
                                          int w, int g, int t,
                                          float acc[8][4]) {
  const int ld = row_len<T>(K);
  const T* a_row = sA + (w * 16 + g) * ld;
  if constexpr (V == BF16) {
    for (int k0 = 0; k0 < K; k0 += 16) {
      const T* pa = a_row + k0 + 2 * t;
      const uint32_t a[4] = {word(pa), word(pa + 8 * ld), word(pa + 8),
                             word(pa + 8 * ld + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const T* pb = sB + (nt * 8 + g) * ld + k0 + 2 * t;
        const uint32_t b[2] = {word(pb), word(pb + 8)};
        mma_bf16(acc[nt], a, b);
      }
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float* pa = a_row + k0 + t;
      const float av[4] = {pa[0], pa[8 * ld], pa[4], pa[8 * ld + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = to_tf32(av[i]);
        if constexpr (V == TF32X3)
          al[i] = to_tf32(__fsub_rn(av[i], __uint_as_float(ah[i])));
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* pb = sB + (nt * 8 + g) * ld + k0 + t;
        const float bv[2] = {pb[0], pb[4]};
        const uint32_t bh[2] = {to_tf32(bv[0]), to_tf32(bv[1])};
        if constexpr (V == TF32X3) {
          const uint32_t bl[2] = {
              to_tf32(__fsub_rn(bv[0], __uint_as_float(bh[0]))),
              to_tf32(__fsub_rn(bv[1], __uint_as_float(bh[1])))};
          mma_tf32(acc[nt], al, bh);
          mma_tf32(acc[nt], ah, bl);
        }
        mma_tf32(acc[nt], ah, bh);
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    matmul_probe_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float halves[2][MT];   // FMA tier: the two column halves
  const int ld = row_len<T>(K);
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + MT * ld;
  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  const int kv = K / VEC;

  for (int m0 = 0; m0 < M; m0 += MT) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < MT * kv; i += THREADS) {
      const int r = i / kv, c = i - r * kv;
      *reinterpret_cast<uint4*>(sA + r * ld + c * VEC) =
          __ldg(reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * K) + c);
    }
    float rs_lo = 0.f, rs_hi = 0.f;   // FMA tier: rs_lo only
    for (int n0 = 0; n0 < N; n0 += NT) {
      if (n0) __syncthreads();   // the previous chunk's readers are done
      for (int i = tid; i < K * NT; i += THREADS) {
        const int k = i / NT, n = i - k * NT;
        sB[n * ld + k] = b[(size_t)k * N + n0 + n];
      }
      __syncthreads();
      if constexpr (V == FMA) {
        const int r = tid & (MT - 1), c0 = (tid / MT) * 32;
        float acc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] = 0.f;
        for (int k0 = 0; k0 < K; k0 += 4) {
          const float4 av =
              *reinterpret_cast<const float4*>(sA + r * ld + k0);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float4 bv =
                *reinterpret_cast<const float4*>(sB + (c0 + j) * ld + k0);
            acc[j] = fmaf(av.x, bv.x, acc[j]);
            acc[j] = fmaf(av.y, bv.y, acc[j]);
            acc[j] = fmaf(av.z, bv.z, acc[j]);
            acc[j] = fmaf(av.w, bv.w, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) rs_lo = __fadd_rn(rs_lo, acc[j]);
      } else {
        float acc[8][4] = {};
        mma_chunk<T, V>(sA, sB, K, w, g, t, acc);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          rs_lo = __fadd_rn(rs_lo, __fadd_rn(acc[nt][0], acc[nt][1]));
          rs_hi = __fadd_rn(rs_hi, __fadd_rn(acc[nt][2], acc[nt][3]));
        }
      }
    }
    if constexpr (V == FMA) {
      halves[tid / MT][tid & (MT - 1)] = rs_lo;
      __syncthreads();
      if (tid < MT) out[m0 + tid] = __fadd_rn(halves[0][tid], halves[1][tid]);
    } else {
      // The four lanes of a group hold one row's column partials.
#pragma unroll
      for (int s = 1; s < 4; s <<= 1) {
        rs_lo = __fadd_rn(rs_lo, __shfl_xor_sync(0xffffffffu, rs_lo, s));
        rs_hi = __fadd_rn(rs_hi, __shfl_xor_sync(0xffffffffu, rs_hi, s));
      }
      if (t == 0) {
        out[m0 + w * 16 + g] = rs_lo;
        out[m0 + w * 16 + g + 8] = rs_hi;
      }
    }
  }
}

template <typename T, int V>
int launch(const void* a, const void* b, void* out, int M, int K, int N,
           int steps, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)(MT + NT) * row_len<T>(K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_probe_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  matmul_probe_kernel<T, V><<<steps, THREADS, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a (M, K) and b (K, N), float32 for variants 0-2 and bfloat16 for 3; out
// (M,) float32. Needs M % 128 == 0, N % 64 == 0, K % 16 == 0, K <= 256,
// 16-byte aligned operands. Returns cudaGetLastError().
int raycore_matmul_probe(const void* a, const void* b, void* out, int M,
                         int K, int N, int steps, int variant, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case FMA: return launch<float, FMA>(a, b, out, M, K, N, steps, s);
    case TF32: return launch<float, TF32>(a, b, out, M, K, N, steps, s);
    case TF32X3: return launch<float, TF32X3>(a, b, out, M, K, N, steps, s);
    case BF16:
      return launch<__nv_bfloat16, BF16>(a, b, out, M, K, N, steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
