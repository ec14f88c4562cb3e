// The register-blocked float32 contraction of the probes P2 and P4.
//
// A block's R rows of features (R <= 1024) meet one (depth, 4C) table, C =
// 128 lanes in four quantity blocks [det | udet | vdet | tdet]. A thread
// owns RM = 8 rows by RL = 2 lanes and, for each lane, all four
// quantities: 64 accumulators, each one ascending fused-multiply-add
// chain over the features, so the kernels keep the bits of the plain
// versions' `fma` chains, and an epilogue needs no exchange between
// threads until the min over lanes.
//
// Shared memory holds the rows transposed, rowT[f * pitch + r], and the
// table with each lane's four quantities side by side, tab[f * C + lane] a
// float4. A thread's rows are 4 g + i and half + 4 g + i (i < 4) of row
// group g, so one feature step reads two float4 of rows and two float4 of
// table for 64 FFMAs; the 8 row groups of a warp read 8 neighbouring
// float4, one wavefront.
//
// Threads: a row group's `tl` threads (a power of two, at most 32) are
// neighbours in a warp and take the lane pairs s, s + tl, ... in turn, so
// a shuffle over `tl` lanes, or a shared-memory slot a row, reduces a
// row's lanes. Row groups are a multiple of 8, the rows padded to a
// multiple of 64; the padded rows are computed and never written.
//
// P4's exact epilogue (three divisions) runs only on the pairs that
// uv_may_pass lets through, about 1 in 12 on the tool's data: a warp
// appends its survivors to a ring in shared memory (Ring, append) and
// tests them 32 at a time, one a thread (drain), so the divisions run
// dense. A warp vote would not do: with 1 pair in 12 surviving, nearly
// every warp of 32 pairs holds one.

#pragma once
#include <cuda_runtime.h>

namespace fma_block {

constexpr int C = 128;     // lanes
constexpr int RM = 8;      // rows a thread
constexpr int RL = 2;      // lanes a thread
constexpr int LANE_PAIRS = C / RL;

struct Layout {
  int n_rg;    // row groups of RM rows, a multiple of 8
  int half;    // 4 * n_rg
  int pitch;   // floats between features of rowT: 8 n_rg + 4 (staggers
               // the banks of a copy that writes 16 features of a row)
  int tl;      // threads a row group
};

__host__ __device__ inline Layout layout(int rows, int threads) {
  Layout L;
  L.n_rg = ((rows + RM - 1) / RM + 7) / 8 * 8;
  L.half = 4 * L.n_rg;
  L.pitch = 8 * L.n_rg + 4;
  int tl = 1;
  while (tl < 32 && 2 * tl * L.n_rg <= threads) tl *= 2;
  L.tl = tl;
  return L;
}

// The row index of a thread's i-th row (i < RM) in row group g.
__device__ __forceinline__ int row_of(const Layout& L, int g, int i) {
  return (i < 4 ? 0 : L.half) + 4 * g + (i & 3);
}

// acc[i][j] = (det, udet, vdet, tdet) of row row_of(g, i) and lane 2 p +
// j: for f < DEPTH in turn, acc = fma(row[f], tab[f][lane], acc), from 0.
// UNROLL feature steps are unrolled at a time (fewer live registers).
template <int DEPTH, int UNROLL = DEPTH>
__device__ __forceinline__ void contract(const float* rowT, int pitch,
                                         const float4* tab, int g, int half,
                                         int p, float4 acc[RM][RL]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RL; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll UNROLL
  for (int f = 0; f < DEPTH; ++f) {
    const float4 a0 = *reinterpret_cast<const float4*>(rowT + f * pitch +
                                                       4 * g);
    const float4 a1 = *reinterpret_cast<const float4*>(rowT + f * pitch +
                                                       half + 4 * g);
    const float a[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float4 w[RL] = {tab[f * C + RL * p], tab[f * C + RL * p + 1]};
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        acc[i][j].x = __fmaf_rn(a[i], w[j].x, acc[i][j].x);
        acc[i][j].y = __fmaf_rn(a[i], w[j].y, acc[i][j].y);
        acc[i][j].z = __fmaf_rn(a[i], w[j].z, acc[i][j].z);
        acc[i][j].w = __fmaf_rn(a[i], w[j].w, acc[i][j].w);
      }
  }
}

// Asynchronous 4-byte copies to shared memory (cp.async), so that P4's
// next block arrives while this one computes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// int32 bits of max(t, 0): +0 for t <= 0.
__device__ __forceinline__ int t_key(float t) {
  return __float_as_int(t > 0.f ? t : 0.f);
}

// The division-free pre-test of one pair q = (det, udet, vdet, tdet): with
// a = |det| and su, sv the numerators with det's sign turned into their
// own, lo = -RN(a m_lo), hi = RN(a m_hi) and hv = RN(a m_v), a pair may
// pass only where lo <= su <= hi and lo <= sv <= hv. With u = RN(udet /
// det) = RN(su / a) and v likewise (also for det = +-0 and +-inf), m_lo
// and m_hi the float32 values just above eps and one_eps, and m_v the
// least float32 at or above m_hi + eps, it is false only where the pair
// must fail P4's clauses u >= -eps, u <= one_eps, v >= -eps and u + v <=
// one_eps (NaN included).
//
// Why a refusal is safe. For a float s and h = RN(y) finite, s > h gives s
// > y: s is at least the next float above h, and y rounds to h, so it is
// below the midpoint between them; likewise s < h gives s < y. RN is
// monotone.
// - su > hi: if hi is infinite (a = inf, or a m_hi overflows) nothing is
//   refused. Else su > a m_hi: for a = 0, su > 0 and u = +inf; for a > 0,
//   su / a > m_hi, so u >= RN(m_hi) = m_hi > one_eps (or +inf).
// - su < lo: if lo = -inf nothing is refused. Else su < -a m_lo: for a =
//   0, u = -inf; for a > 0, su / a < -m_lo, so u <= -m_lo < -eps. sv < lo
//   likewise fails v >= -eps.
// - sv > hv: as for su, v >= m_v (or +inf). Then u < -eps fails, or u +
//   v >= m_v - eps >= the float above one_eps, so RN(u + v) > one_eps.
//   (v <= one_eps is no clause of the tool: u = -eps and v = 1 + 1.5 eps
//   pass.)
// - su, sv or a NaN: the compares fail, and u or v is NaN.
// Subnormal products need no case of their own: RN onto the subnormal grid
// is still rounding to the nearest float.

__device__ __forceinline__ bool uv_may_pass(const float4& q, float m_lo,
                                            float m_hi, float m_v) {
  const unsigned sign = __float_as_uint(q.x) & 0x80000000u;
  const float su = __uint_as_float(__float_as_uint(q.y) ^ sign);
  const float sv = __uint_as_float(__float_as_uint(q.z) ^ sign);
  const float a = fabsf(q.x);
  const float lo = -__fmul_rn(a, m_lo);
  return (su >= lo) & (su <= __fmul_rn(a, m_hi)) & (sv >= lo) &
         (sv <= __fmul_rn(a, m_v));
}

// A warp's ring of survivors in shared memory: QCAP entries of the pair's
// quantities and its row << 7 | lane, with cursors that are the same in
// every thread of the warp.
constexpr int QCAP = 128;   // a power of two, at least 32 + 64

struct Ring {
  float4* q;
  int* idx;
  int head, tail;
};

// The survivors head .. head + n (n <= 32) through accept(q, idx), one a
// thread.
template <class Accept>
__device__ __forceinline__ void drain(Ring& R, int n, Accept& accept) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < n) {
    const int e = (R.head + lane) & (QCAP - 1);
    accept(R.q[e], R.idx[e]);
  }
  __syncwarp();
  R.head += n;
}

template <class Accept>
__device__ __forceinline__ void flush(Ring& R, Accept& accept) {
  while (R.tail > R.head) drain(R, min(32, R.tail - R.head), accept);
}

// A task's survivors (bit RL i + j of mask: pair acc[i][j], row row_of(g,
// i), lane RL p + j) into the ring after those of the warp's threads
// before this one (a scan of the counts), then a drain of every 32. Where
// the ring cannot hold a task's survivors (on adversarial tables nearly
// every pair survives) it is emptied, and a task that alone overflows it
// tests its survivors where they are.
template <class Accept>
__device__ __forceinline__ void append(Ring& R, unsigned mask,
                                       const float4 (&acc)[RM][RL],
                                       const Layout& L, int g, int p,
                                       Accept& accept) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int count = __popc(mask);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(full, incl, 31);
  if (R.tail - R.head + total > QCAP) {
    flush(R, accept);
    if (total > QCAP) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j)
          if ((mask >> (RL * i + j)) & 1u)
            accept(acc[i][j], (row_of(L, g, i) << 7) | (RL * p + j));
      return;
    }
  }
  int pos = R.tail + incl - count;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      const bool mine = (mask >> (RL * i + j)) & 1u;
      const int e = pos & (QCAP - 1);
      if (mine) {
        R.q[e] = acc[i][j];
        R.idx[e] = (row_of(L, g, i) << 7) | (RL * p + j);
      }
      pos += mine;
    }
  for (R.tail += total; R.tail - R.head >= 32;) drain(R, 32, accept);
}

// The pre-test's mask over a task's pairs, bit RL i + j; rows at or past
// `rows` (padding) and threads past the row groups take none.
__device__ __forceinline__ unsigned may_mask(const float4 (&acc)[RM][RL],
                                             const Layout& L, int g,
                                             int rows, float m_lo,
                                             float m_hi, float m_v) {
  unsigned mask = 0;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const bool valid = (g < L.n_rg) & (row_of(L, g, i) < rows);
#pragma unroll
    for (int j = 0; j < RL; ++j)
      mask |= unsigned(valid & uv_may_pass(acc[i][j], m_lo, m_hi, m_v))
              << (RL * i + j);
  }
  return mask;
}

}  // namespace fma_block
