// Matmul probe (P3): the cost of a small-depth contraction by precision.
//
// Replaces the TPU kernel tools/probe_matmul_shapes.py:make_fn (its inner
// kernel, launched over a grid of `steps`).
//
// Each of `steps` steps computes the whole (M, K) x (K, N) product of the
// same two operands and writes its M row sums to out, as every TPU grid
// step writes output block (0, 0); every step writes the same bits, so the
// repeated writes are harmless. The product accumulates in float32.
//
// How each TPU precision tier maps to Hopper (variant):
//   FMA     highest, float32: float32 fused multiply-adds on the CUDA
//           cores, the arithmetic of the sweep kernels (K2-K5) today;
//   TF32    default, float32: one TF32 pass on the tensor cores, each
//           input rounded to TF32 (cvt.rna), what XLA does for DEFAULT on
//           a GPU;
//   TF32X3  high, float32: 3xTF32, Hopper's error-compensated tier and the
//           counterpart of the TPU's bf16_3x: each input split into a TF32
//           high part and a TF32 low part (x - hi, taken in float32), and
//           the products lo*hi, hi*lo and hi*hi accumulated in that order;
//   BF16    bfloat16 inputs (any tier): one bf16 pass.
//
// What bounds it on this card: operations, 2*M*K*N per step against the
// tier's unit (67 TFLOP/s float32, 495 TF32 with 3xTF32 counting three
// passes, 989 bf16), and for the tensor-core tiers the M*(N-1) row-sum
// additions at 33.5 T a second, which at K = 16 take about as long as the
// bf16 products. The operands (at most 256 KB each) stay in L2.
//
// Design. Persistent CTAs, about one per SM and resident slot, each
// walking its share of the steps; the loop-invariant product is computed
// anew every step (the FMA tier reloads its operands from shared memory
// after a compiler barrier, the tensor-core products are volatile asm).
// The operands are staged in shared memory once per CTA where they fit
// (every tier at K = 16 up to M = 2048, N = 512, but 3xTF32 at M = 2048);
// otherwise they stream from L2 tile by tile, every step.
//   FMA tier (256 threads, two groups of 128): register-blocked, a thread
//   owns 8 rows x 8 columns of a 128-row tile and a 64-column chunk, so
//   each k reads 4 float4 from shared memory (A transposed, rows
//   contiguous) for 64 FFMAs. Group g takes chunks g, g + 2, ... Each dot
//   is an ascending FMA chain over K; the row sums are added in the fixed
//   order of tools/probe_matmul_shapes.py:_fma_row_sums (a thread's 8
//   columns in turn, the 8 threads of a row as a tree, each group's chunks
//   in turn, then group 0 + group 1), so the tier is bit for bit.
//   Tensor-core tiers (384 threads): wgmma m64nNk8 (TF32) or m64nNk16
//   (bf16), N = 128 (64 where N is not a multiple of 128), A and B in shared
//   memory, K-major and swizzled (csrc/wgmma.cuh). The operands are stored
//   already rounded (cvt.rna) and, for 3xTF32, split into hi and lo once
//   per CTA: the tensor cores read a TF32 operand by dropping its low 13
//   bits, a truncation. Resident operands: the three warpgroups take the
//   (step, 64-row block) items in turn and run independently, each with
//   two accumulators, so that row sums are added while the next products
//   run, its own and the others'.
//   Streamed operands: warpgroups 2 and 3 convert and stage (128-row,
//   K-tile) slices of A and (128-column, K-tile) slices of B into a ring
//   of four stages, alternate stages each, which two consumer warpgroups
//   share, 64 rows each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

enum Variant { FMA = 0, TF32 = 1, TF32X3 = 2, BF16 = 3 };

// Resident operands up to this much dynamic shared memory.
constexpr int SMEM_LIMIT = 220 * 1024;

// Persistent grid: the SMs times the CTAs that fit on one, at most steps.
template <typename F>
int persistent_grid(F kernel, int threads, size_t smem, int steps,
                    int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = steps < sms * per_sm ? steps : sms * per_sm;
  return 0;
}

// ---------------------------------------------------------------- FMA tier

constexpr int FMA_THREADS = 256;
constexpr int FMA_MT = 128;   // rows of a tile
constexpr int FMA_NC = 64;    // columns of a chunk
constexpr int FMA_KT = 32;    // depth of a streamed k-tile

// dst[k * lda + m] = a[(m0 + m) * K + k0 + k] for m < rows, k < kc.
__device__ __forceinline__ void stage_a_t(float* dst, int lda,
                                          const float* __restrict__ a, int K,
                                          int m0, int rows, int k0, int kc) {
  const int n = rows * (kc / 4);
  for (int u = threadIdx.x; u < n; u += FMA_THREADS) {
    const int m = u % rows, kq = u / rows;
    const float4 v = __ldg(
        reinterpret_cast<const float4*>(a + (size_t)(m0 + m) * K + k0) + kq);
    float* d = dst + 4 * kq * lda + m;
    d[0] = v.x;
    d[lda] = v.y;
    d[2 * lda] = v.z;
    d[3 * lda] = v.w;
  }
}

// dst[k * ldb + n] = b[(k0 + k) * N + n0 + n] for n < cols, k < kc.
__device__ __forceinline__ void stage_b(float* dst, int ldb,
                                        const float* __restrict__ b, int N,
                                        int n0, int cols, int k0, int kc) {
  const int nv = cols / 4;
  for (int u = threadIdx.x; u < kc * nv; u += FMA_THREADS) {
    const int k = u / nv, q = u - k * nv;
    *reinterpret_cast<float4*>(dst + k * ldb + 4 * q) = __ldg(
        reinterpret_cast<const float4*>(b + (size_t)(k0 + k) * N + n0) + q);
  }
}

// acc[i][j] = fma chains over k < kc of this thread's rows {4 tr + i,
// 64 + 4 tr + i - 4} of aT and columns {4 tc + j, 32 + 4 tc + j - 4} of bv.
__device__ __forceinline__ void fma_block(const float* aT, int lda,
                                          const float* bv, int ldb, int kc,
                                          int tr, int tc, float acc[8][8]) {
#pragma unroll 4
  for (int k = 0; k < kc; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(aT + k * lda + 4 * tr);
    const float4 a1 =
        *reinterpret_cast<const float4*>(aT + k * lda + 64 + 4 * tr);
    const float4 b0 = *reinterpret_cast<const float4*>(bv + k * ldb + 4 * tc);
    const float4 b1 =
        *reinterpret_cast<const float4*>(bv + k * ldb + 32 + 4 * tc);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
  }
}

// A chunk's dots into the running row sums: per row the thread's 8 columns
// in turn from 0, the 8 threads of the row as a tree (lane bits 0-2).
__device__ __forceinline__ void fma_chunk_sums(const float acc[8][8],
                                               float rsum[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) p = __fadd_rn(p, acc[i][j]);
#pragma unroll
    for (int m = 1; m < 8; m <<= 1)
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, m));
    rsum[i] = __fadd_rn(rsum[i], p);
  }
}

__global__ void __launch_bounds__(FMA_THREADS, 2)
    matmul_fma_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ out,
                      int M, int K, int N, int steps, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rs_sh[2][FMA_MT];
  const int tid = threadIdx.x, grp = tid >> 7, gt = tid & 127;
  const int tr = gt >> 3, tc = gt & 7;
  const int chunks = N / FMA_NC;
  // Resident: aT (K, M) then b (K, N); streamed: aT (KT, 128), b (KT, 128).
  const int lda = resident ? M : FMA_MT, ldb = resident ? N : 2 * FMA_NC;
  float* const sa = reinterpret_cast<float*>(smem);
  float* const sb = sa + (resident ? K * M : FMA_KT * FMA_MT);
  if (resident) {
    stage_a_t(sa, lda, a, K, 0, M, 0, K);
    stage_b(sb, ldb, b, N, 0, N, 0, K);
    __syncthreads();
  }
  for (int s = blockIdx.x; s < steps; s += gridDim.x) {
    // Every step reads its operands and computes its product anew.
    asm volatile("" ::: "memory");
    for (int m0 = 0; m0 < M; m0 += FMA_MT) {
      float rsum[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) rsum[i] = 0.f;
      for (int c0 = 0; c0 < chunks; c0 += 2) {
        const int c = c0 + grp;
        const bool mine = c < chunks;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        if (resident) {
          if (mine)
            fma_block(sa + m0, lda, sb + c * FMA_NC, ldb, K, tr, tc, acc);
        } else {
          const int cols = min(2 * FMA_NC, N - c0 * FMA_NC);
          for (int k0 = 0; k0 < K; k0 += FMA_KT) {
            const int kc = min(FMA_KT, K - k0);
            __syncthreads();   // the previous tile's readers are done
            stage_a_t(sa, lda, a, K, m0, FMA_MT, k0, kc);
            stage_b(sb, ldb, b, N, c0 * FMA_NC, cols, k0, kc);
            __syncthreads();
            if (mine)
              fma_block(sa, lda, sb + grp * FMA_NC, ldb, kc, tr, tc, acc);
          }
        }
        if (mine) fma_chunk_sums(acc, rsum);
      }
      if (tc == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rs_sh[grp][4 * tr + i] = rsum[i];
          rs_sh[grp][64 + 4 * tr + i] = rsum[4 + i];
        }
      }
      __syncthreads();
      if (tid < FMA_MT)
        out[m0 + tid] = __fadd_rn(rs_sh[0][tid], rs_sh[1][tid]);
      __syncthreads();
    }
  }
}

int launch_fma(const void* a, const void* b, void* out, int M, int K, int N,
               int steps, cudaStream_t stream) {
  const size_t whole = (size_t)(M + N) * K * sizeof(float);
  const int resident = whole <= SMEM_LIMIT;
  const size_t smem =
      resident ? whole : (size_t)FMA_KT * (FMA_MT + 2 * FMA_NC) * sizeof(float);
  int grid = 0;
  const int e = persistent_grid(matmul_fma_kernel, FMA_THREADS, smem, steps,
                                &grid);
  if (e) return e;
  matmul_fma_kernel<<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, K, N, steps, resident);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ tensor-core tiers

constexpr int TC_THREADS = 384;   // resident: 3 warpgroups
constexpr int TC_MT = 128;        // rows of a streamed A slice
constexpr int TC_NC = 128;        // most columns of a chunk
// Streamed: 2 consumer warpgroups, 2 stagers filling alternate stages of
// a ring of TC_STAGES; a fill is met by its stager and both consumers.
constexpr int TC_STREAM_THREADS = 512, TC_STAGES = 4, TC_SYNC = 384;
// Named barriers of the streamed ring: FULL + s, EMPTY + s.
constexpr int TC_FULL = 1, TC_EMPTY = TC_FULL + TC_STAGES;
// The most bytes a streamed stage's row takes over its parts (3xTF32's hi
// and lo rows take 64 each).
constexpr int TC_STAGE_ROW = 128;

template <int V>
struct Tier {
  using T = float;
  static constexpr int PARTS = V == TF32X3 ? 2 : 1;   // hi (and lo)
};
template <>
struct Tier<BF16> {
  using T = __nv_bfloat16;
  static constexpr int PARTS = 1;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// 16 bytes of operand, as read, to the stored part(s) at dst and dst +
// part: TF32 rounds each value; TF32X3 stores hi = TF32(x) and lo =
// TF32(x - hi); BF16 copies.
template <int V>
__device__ __forceinline__ void put(unsigned char* dst, int part, uint4 v) {
  if constexpr (V == BF16) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const uint4 hi = make_uint4(to_tf32(__uint_as_float(v.x)),
                                to_tf32(__uint_as_float(v.y)),
                                to_tf32(__uint_as_float(v.z)),
                                to_tf32(__uint_as_float(v.w)));
    *reinterpret_cast<uint4*>(dst) = hi;
    if constexpr (V == TF32X3) {
      const uint4 lo = make_uint4(
          to_tf32(__fsub_rn(__uint_as_float(v.x), __uint_as_float(hi.x))),
          to_tf32(__fsub_rn(__uint_as_float(v.y), __uint_as_float(hi.y))),
          to_tf32(__fsub_rn(__uint_as_float(v.z), __uint_as_float(hi.z))),
          to_tf32(__fsub_rn(__uint_as_float(v.w), __uint_as_float(hi.w))));
      *reinterpret_cast<uint4*>(dst + part) = lo;
    }
  }
}

// Byte offset of byte kb of K-major row r in a region whose K atoms (W
// bytes of every row) lie `atom` bytes apart.
__device__ __forceinline__ uint32_t k_major(int r, int kb, int W, int atom) {
  return (kb / W) * atom + wg::swizzle(r * W + kb % W, W);
}

// Rows r < rows of a K-contiguous source, src[(row0 + r) * ld + k0 + k]
// for k < kc, as K-major rows at dst; thread t of nt.
template <int V>
__device__ __forceinline__ void stage_rows(
    unsigned char* dst, int atom, int part, int W,
    const typename Tier<V>::T* __restrict__ src, int ld, int row0, int rows,
    int k0, int kc, int t, int nt) {
  using T = typename Tier<V>::T;
  constexpr int EPC = 16 / sizeof(T);   // elements in 16 bytes
  const int cpr = kc / EPC;
  for (int u = t; u < rows * cpr; u += nt) {
    const int r = u / cpr, cc = u - r * cpr;
    put<V>(dst + k_major(r, 16 * cc, W, atom), part,
           __ldg(reinterpret_cast<const uint4*>(
               src + (size_t)(row0 + r) * ld + k0 + cc * EPC)));
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One B unit: v[e] holds 16 bytes (EPC values of columns g EPC ..) of
// source row e of K-chunk cc; written as EPC K-major 16-byte chunks, rows
// g EPC + j (a transpose).
template <int V>
__device__ __forceinline__ void put_cols(unsigned char* dst, int atom,
                                         int part, int W, int g, int cc,
                                         const uint4* v) {
  using T = typename Tier<V>::T;
  constexpr int EPC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < EPC; ++j) {
    uint4 c;
    if constexpr (EPC == 4) {   // float32: element j of each row
      c = make_uint4(word(v[0], j), word(v[1], j), word(v[2], j),
                     word(v[3], j));
    } else {                    // bf16: half j % 2 of word j / 2
      const uint32_t sel = j & 1 ? 0x7632u : 0x5410u;
      c = make_uint4(__byte_perm(word(v[0], j / 2), word(v[1], j / 2), sel),
                     __byte_perm(word(v[2], j / 2), word(v[3], j / 2), sel),
                     __byte_perm(word(v[4], j / 2), word(v[5], j / 2), sel),
                     __byte_perm(word(v[6], j / 2), word(v[7], j / 2), sel));
    }
    put<V>(dst + k_major(g * EPC + j, 16 * cc, W, atom), part, c);
  }
}

// Columns n < cols of an N-contiguous source, src[(k0 + k) * ld + col0 + n]
// for k < kc, as K-major rows at dst; thread t of nt, a unit (put_cols) an
// iteration.
template <int V>
__device__ __forceinline__ void stage_cols(
    unsigned char* dst, int atom, int part, int W,
    const typename Tier<V>::T* __restrict__ src, int ld, int col0, int cols,
    int k0, int kc, int t, int nt) {
  using T = typename Tier<V>::T;
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = kc / EPC;
  for (int u = t; u < (cols / EPC) * cpr; u += nt) {
    const int g = u / cpr, cc = u - g * cpr;
    uint4 v[EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e)
      v[e] = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(k0 + cc * EPC + e) * ld + col0 + g * EPC));
    put_cols<V>(dst, atom, part, W, g, cc, v);
  }
}

// One stage of the streamed ring, by the 128 threads of a staging
// warpgroup (thread t): the (TC_MT, KT) slice of A at (m0, k0) and the
// (KT, cols) slice of B at (k0, n0), every load in flight before the first
// store (at most 8 chunks of A and 256 / EPC units of B a thread).
template <int V>
__device__ __forceinline__ void stage_stream(
    unsigned char* st, int part, int W, const typename Tier<V>::T* a, int K,
    int m0, const typename Tier<V>::T* b, int N, int n0, int cols, int k0,
    int KT, int t) {
  using T = typename Tier<V>::T;
  constexpr int EPC = 16 / sizeof(T), NB = 2 * 4 / EPC;
  const int cpr = KT / EPC, na = TC_MT * cpr, nb = cols / EPC * cpr;
  uint4 va[8], vb[NB][EPC];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int u = t + 128 * j, r = u / cpr, cc = u - r * cpr;
    if (u < na)
      va[j] = __ldg(reinterpret_cast<const uint4*>(
          a + (size_t)(m0 + r) * K + k0 + cc * EPC));
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int u = t + 128 * j, g = u / cpr, cc = u - g * cpr;
    if (u < nb)
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        vb[j][e] = __ldg(reinterpret_cast<const uint4*>(
            b + (size_t)(k0 + cc * EPC + e) * N + n0 + g * EPC));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int u = t + 128 * j, r = u / cpr, cc = u - r * cpr;
    if (u < na) put<V>(st + k_major(r, 16 * cc, W, 0), part, va[j]);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int u = t + 128 * j, g = u / cpr;
    if (u < nb)
      put_cols<V>(st + TC_MT * W, 0, part, W, g, u - g * cpr, vb[j]);
  }
}

template <int V, int NC>
__device__ __forceinline__ void mma(float (&d)[NC / 2], uint64_t da,
                                    uint64_t db, int accumulate) {
  const int acc = accumulate;
  if constexpr (V == BF16 && NC == 128) wg::mma_bf16_n128(d, da, db, acc);
  if constexpr (V == BF16 && NC == 64) wg::mma_bf16_n64(d, da, db, acc);
  if constexpr (V != BF16 && NC == 128) wg::mma_tf32_n128(d, da, db, acc);
  if constexpr (V != BF16 && NC == 64) wg::mma_tf32_n64(d, da, db, acc);
}

// Operand views: shared addresses of the hi and lo parts of a 64-row block
// of A or an NC-column chunk of B, and the bytes from one K atom to the
// next.
struct View {
  uint32_t hi, lo;
  int atom;
};

// Issue the products of K atoms [0, katoms) into d (32-byte steps of W),
// the first overwriting d unless accumulate, as one committed group.
template <int V, int NC>
__device__ __forceinline__ void issue(float (&d)[NC / 2], View A, View B,
                                      int katoms, int W, int accumulate) {
  wg::keep(d);
  wg::fence();
  for (int ka = 0; ka < katoms; ++ka)
    for (int kb = 0; kb < W; kb += 32) {
      const uint32_t oa = ka * A.atom + kb, ob = ka * B.atom + kb;
      if constexpr (V == TF32X3) {
        mma<V, NC>(d, wg::desc(A.lo + oa, W), wg::desc(B.hi + ob, W),
                   accumulate);
        mma<V, NC>(d, wg::desc(A.hi + oa, W), wg::desc(B.lo + ob, W), 1);
        mma<V, NC>(d, wg::desc(A.hi + oa, W), wg::desc(B.hi + ob, W), 1);
      } else {
        mma<V, NC>(d, wg::desc(A.hi + oa, W), wg::desc(B.hi + ob, W),
                   accumulate);
      }
      accumulate = 1;
    }
  wg::commit();
}

// Add the chunk's row sums (rows l / 4 and l / 4 + 8 of the warp) to rs0,
// rs1: the thread's column pairs into four partials, those pairwise, then
// the row's 4 lanes.
template <int NC>
__device__ __forceinline__ void row_sums(const float (&d)[NC / 2], float& rs0,
                                         float& rs1) {
  float p0[4], p1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p0[j] = d[4 * j] + d[4 * j + 1];
    p1[j] = d[4 * j + 2] + d[4 * j + 3];
  }
#pragma unroll
  for (int j = 4; j < NC / 8; ++j) {
    p0[j & 3] += d[4 * j] + d[4 * j + 1];
    p1[j & 3] += d[4 * j + 2] + d[4 * j + 3];
  }
  float s0 = (p0[0] + p0[1]) + (p0[2] + p0[3]);
  float s1 = (p1[0] + p1[1]) + (p1[2] + p1[3]);
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, m);
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
  }
  rs0 += s0;
  rs1 += s1;
}

__device__ __forceinline__ void write_rows(float* __restrict__ out, int row0,
                                           int i, float rs0, float rs1) {
  if ((i & 3) == 0) {
    const int r = row0 + (i >> 5) * 16 + ((i & 31) >> 2);
    out[r] = rs0;
    out[r + 8] = rs1;
  }
}

// Resident operands, warpgroup w of nw: this CTA's (step, 64-row block)
// items f = w, w + nw, ... of its steps x M / 64, each as N / NC units (one
// per column chunk) in turn, through two accumulators: the products of
// unit u + 1 run while the row sums of unit u are added. The steady state
// is branch-free, so the compiler can tell which group each wait retires
// (else it serializes every product). A at a_addr: [part][atom][M][W]; B
// at b_addr: [part][atom][N][W].
template <int V, int NC>
__device__ __forceinline__ void resident_units(
    uint32_t a_addr, int a_atom, int a_part, uint32_t b_addr, int b_atom,
    int b_part, int katoms, int W, int M, int N, int steps, int w, int nw,
    int i, float* __restrict__ out) {
  const int chunks = N / NC, blocks = M / 64;
  const int my_steps = (steps - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int items = my_steps * blocks > w
                        ? (my_steps * blocks - w - 1) / nw + 1 : 0;
  const int total = items * chunks;
  if (total == 0) return;
  // Unit u's (block, chunk), walked by two cursors: the next unit to issue
  // and the next to finish.
  struct Cursor {
    int mb, c;
  };
  auto next = [&](Cursor& q) {
    if (++q.c == chunks) {
      q.c = 0;
      for (q.mb += nw; q.mb >= blocks;) q.mb -= blocks;
    }
  };
  Cursor qi = {w % blocks, 0}, qd = qi;
  auto go = [&](float (&d)[NC / 2]) {
    const uint32_t ar = a_addr + qi.mb * 64 * W, br = b_addr + qi.c * NC * W;
    issue<V, NC>(d, View{ar, ar + a_part, a_atom},
                 View{br, br + b_part, b_atom}, katoms, W, 0);
    next(qi);
  };
  float rs0 = 0.f, rs1 = 0.f;
  auto done = [&](const float (&d)[NC / 2]) {
    row_sums<NC>(d, rs0, rs1);
    if (qd.c == chunks - 1) {
      write_rows(out, qd.mb * 64, i, rs0, rs1);
      rs0 = rs1 = 0.f;
    }
    next(qd);
  };
  float d0[NC / 2], d1[NC / 2];
  go(d0);
  int u = 0;
  for (; u + 2 < total; u += 2) {
    go(d1);
    wg::wait<1>();
    wg::keep(d0);
    done(d0);
    go(d0);
    wg::wait<1>();
    wg::keep(d1);
    done(d1);
  }
  if (u + 1 < total) {
    go(d1);
    wg::wait<1>();
    wg::keep(d0);
    done(d0);
    wg::wait<0>();
    wg::keep(d1);
    done(d1);
  } else {
    wg::wait<0>();
    wg::keep(d0);
    done(d0);
  }
}

// One column chunk of a streamed (TC_MT-row) tile for consumer warpgroup
// w: the K-tiles of stages it, it + 1, ... of the ring, then its row sums.
template <int V, int NC>
__device__ __forceinline__ void stream_chunk(uint32_t addr, int stage,
                                             int part, int w, int W,
                                             int ktiles, int& it, float& rs0,
                                             float& rs1) {
  float d[NC / 2];
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int slot = it % TC_STAGES;
    wg::bar_sync(TC_FULL + slot, TC_SYNC);
    const uint32_t st = addr + slot * stage;
    issue<V, NC>(d, View{st + w * 64 * W, st + part + w * 64 * W, 0},
                 View{st + TC_MT * W, st + part + TC_MT * W, 0}, 1, W, kt);
    wg::wait<0>();
    wg::keep(d);
    wg::bar_arrive(TC_EMPTY + slot, TC_SYNC);
  }
  row_sums<NC>(d, rs0, rs1);
}

// Resident operands: all three warpgroups stage A and B once, then each
// computes its share of the (step, 64-row block) items. NC: the columns of
// a chunk, 128, or 64 where N is not a multiple of 128.
template <int V, int NC>
__global__ void __launch_bounds__(TC_THREADS, 1)
    matmul_tc_resident(const typename Tier<V>::T* __restrict__ a,
                       const typename Tier<V>::T* __restrict__ b,
                       float* __restrict__ out, int M, int K, int N,
                       int steps, int W) {
  using T = typename Tier<V>::T;
  constexpr int P = Tier<V>::PARTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = wg::align1024(smem_raw);
  const uint32_t addr = wg::smem_addr(base);
  const int tid = threadIdx.x;
  const int katoms = K * static_cast<int>(sizeof(T)) / W;
  const int a_atom = M * W, a_part = katoms * a_atom;
  const int b_atom = N * W, b_part = katoms * b_atom;
  stage_rows<V>(base, a_atom, a_part, W, a, K, 0, M, 0, K, tid, TC_THREADS);
  stage_cols<V>(base + P * a_part, b_atom, b_part, W, b, N, 0, N, 0, K, tid,
                TC_THREADS);
  wg::proxy_fence();
  __syncthreads();
  resident_units<V, NC>(addr, a_atom, a_part, addr + P * a_part, b_atom,
                        b_part, katoms, W, M, N, steps, tid >> 7,
                        TC_THREADS / 128, tid & 127, out);
}

// Streamed operands: warpgroups 2 and 3 stage, per step, (TC_MT-row,
// K-tile) slices of A and (NC-column, K-tile) slices of B into a ring of
// TC_STAGES, alternate stages each (stage s by stager s % 2); warpgroups
// 0 and 1 take 64 rows of each.
template <int V, int NC>
__global__ void __launch_bounds__(TC_STREAM_THREADS, 1)
    matmul_tc_streamed(const typename Tier<V>::T* __restrict__ a,
                       const typename Tier<V>::T* __restrict__ b,
                       float* __restrict__ out, int M, int K, int N,
                       int steps, int W) {
  using T = typename Tier<V>::T;
  constexpr int P = Tier<V>::PARTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = wg::align1024(smem_raw);
  const uint32_t addr = wg::smem_addr(base);
  const int tid = threadIdx.x, w = tid >> 7, i = tid & 127;
  const int KT = W / static_cast<int>(sizeof(T));   // K of one tile
  // A stage holds, per part, TC_MT rows of A then TC_NC of B.
  const int part = (TC_MT + TC_NC) * W, stage = P * part;
  const int ktiles = K / KT;
  int it = 0;
  if (w >= 2) {
    for (int s = blockIdx.x; s < steps; s += gridDim.x)
      for (int m0 = 0; m0 < M; m0 += TC_MT)
        for (int n0 = 0; n0 < N; n0 += NC)
          for (int kt = 0; kt < ktiles; ++kt, ++it) {
            if ((it & 1) != w - 2) continue;
            const int slot = it % TC_STAGES;
            if (it >= TC_STAGES) wg::bar_sync(TC_EMPTY + slot, TC_SYNC);
            unsigned char* const st = base + slot * stage;
            stage_stream<V>(st, part, W, a, K, m0, b, N, n0, NC, kt * KT,
                            KT, i);
            wg::proxy_fence();
            wg::bar_arrive(TC_FULL + slot, TC_SYNC);
          }
    // Meet the consumers' last releases, so every barrier ends complete.
    for (int k = it < TC_STAGES ? 0 : it - TC_STAGES; k < it; ++k)
      if ((k & 1) == w - 2) wg::bar_sync(TC_EMPTY + k % TC_STAGES, TC_SYNC);
    return;
  }
  for (int s = blockIdx.x; s < steps; s += gridDim.x)
    for (int m0 = 0; m0 < M; m0 += TC_MT) {
      float rs0 = 0.f, rs1 = 0.f;
      for (int n0 = 0; n0 < N; n0 += NC)
        stream_chunk<V, NC>(addr, stage, part, w, W, ktiles, it, rs0, rs1);
      write_rows(out, m0 + w * 64, i, rs0, rs1);
    }
}

template <int V, int NC>
int launch_tc_nc(const void* a, const void* b, void* out, int M, int K, int N,
              int steps, cudaStream_t stream) {
  using T = typename Tier<V>::T;
  constexpr int P = Tier<V>::PARTS;
  const int kb = K * static_cast<int>(sizeof(T));
  const size_t whole = (size_t)P * (M + N) * kb + 1024;
  const int resident = whole <= SMEM_LIMIT;
  // Rows of W bytes (a swizzle atom's width) that divide K's bytes; a
  // streamed stage keeps to TC_STAGE_ROW bytes a row over its parts.
  int W = kb % 128 == 0 ? 128 : kb % 64 == 0 ? 64 : 32;
  if (!resident && W * P > TC_STAGE_ROW) W = TC_STAGE_ROW / P;
  const size_t smem =
      resident ? whole
               : (size_t)TC_STAGES * P * (TC_MT + TC_NC) * W + 1024;
  const auto kernel =
      resident ? matmul_tc_resident<V, NC> : matmul_tc_streamed<V, NC>;
  const int threads = resident ? TC_THREADS : TC_STREAM_THREADS;
  int grid = 0;
  const int e = persistent_grid(kernel, threads, smem, steps, &grid);
  if (e) return e;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), M, K, N, steps, W);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_tc(const void* a, const void* b, void* out, int M, int K, int N,
              int steps, cudaStream_t stream) {
  return N % 128 == 0
             ? launch_tc_nc<V, 128>(a, b, out, M, K, N, steps, stream)
             : launch_tc_nc<V, 64>(a, b, out, M, K, N, steps, stream);
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
    case FMA: return launch_fma(a, b, out, M, K, N, steps, s);
    case TF32: return launch_tc<TF32>(a, b, out, M, K, N, steps, s);
    case TF32X3: return launch_tc<TF32X3>(a, b, out, M, K, N, steps, s);
    case BF16: return launch_tc<BF16>(a, b, out, M, K, N, steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
