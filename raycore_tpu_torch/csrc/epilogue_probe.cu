// Epilogue probe (P2): the per-block cost of the worklist sweep's epilogue.
//
// Replaces the TPU kernel tools/epilogue_experiments.py:make_kernel
// (launched by run).
//
// Block b works on tile tids[b] = b % n_tiles (0 for every block with
// same_tile): its TILE rows of phi (TILE, 16) against feats[tids[b]]
// (16, 4C), C lanes per row in four quantity blocks [det | udet | vdet |
// tdet], then one of seven epilogues, and writes one int32 per row:
//   MATMUL_ONLY  min over lanes of the bits of tdet;
//   VPU_ONLY     the 19 nonzero coefficients summed in the tool's order
//                (det: rows 0-2; udet, vdet: rows 0-5; tdet: rows 6-9),
//                each as a product and an addition, then the min over
//                lanes of the bits of det + udet + vdet + tdet;
//   FULL         the 16-deep dot, r = 1 / det, u, v, t = udet*r, vdet*r,
//                tdet*r, acceptance against the row's t_min and the t
//                decoded from key0 (bits & ~127), the packed key (t bits
//                with the lane in the low 7 bits), min with key0;
//   VPU_FULL     VPU_ONLY's quantities with FULL's epilogue;
//   NO_DIVIDE    exact acceptance multiplied through by |det| (the sign
//                applied to the numerators), t from an approximate
//                reciprocal for the key only;
//   APPROX_RECIP FULL with r from the approximate reciprocal;
//   RECIP_ONLY   FULL's u, v, t, then the min over lanes of the bits of
//                u + v + t.
// The tool's approximate reciprocal (pl.reciprocal(approx=True)) is
// rcp.approx.ftz.f32 here, the special-function unit's reciprocal, at most
// 1 ulp from the exact one (PTX ISA). The exact reciprocal is rcp_fast,
// equal to the correctly rounded one, every other operation an explicitly
// rounded intrinsic and the dot a 16-step fused multiply-add chain in
// ascending feature order, which the plain version emulates, so the two
// agree bit for bit except in the approximate variants.
//
// Several blocks work on the same tile and write its rows with the same
// values: the key is min(key over lanes, key0), and key0 is an input, not a
// value carried from block to block. On the card those writes race
// harmlessly.
//
// What bounds it on this card: arithmetic, 4 * 16 fused multiply-adds per
// (row, lane) against 67 TFLOP/s of float32; the VPU variants' 19
// products and 15 additions are each rounded, so no FFMA fuses them: 34
// issue slots of the float32 pipe. The tiles' rows and tables are read
// from memory once and then hit L2.
//
// Design: one CTA of 256 threads per block, 128 for tiles of at most 256
// rows (a CTA that walked several blocks, staging the next with cp.async,
// measured slower: its loop state pushed the contraction past 255
// registers). The CTA stages the tile's table with each lane's four
// quantities side by side (32 KB) and its rows transposed. The product is
// the register-blocked contraction of fma_block.cuh: a thread owns 8 rows
// by 2 lanes, so one feature step reads 4 float4 for 64 FFMAs (the VPU
// variants: the same loads for their 34 rounded operations a pair), then
// runs the epilogue on each of its 16 (row, lane) pairs and keeps a min a
// row. The exact reciprocal is rcp_fast, which has no branch, so a row's
// pairs' epilogues overlap; dets outside its range take a division after
// a warp vote. The min over lanes is a min of int32 keys (the accepting
// variants carry the lane in the low 7 bits), which is order-free, so the
// `tl` threads of a row reduce by shuffles and give the bits of a
// lane-by-lane walk.

#include <climits>
#include <cuda_runtime.h>

#include "fma_block.cuh"

namespace {

using fma_block::C;
using fma_block::Layout;
using fma_block::RL;
using fma_block::RM;
using fma_block::row_of;
using fma_block::t_key;

constexpr int FEAT = 16;
constexpr int LANE_MASK = 127;

enum Variant {
  MATMUL_ONLY = 0, VPU_ONLY = 1, FULL = 2, VPU_FULL = 3, NO_DIVIDE = 4,
  APPROX_RECIP = 5, RECIP_ONLY = 6
};


__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// RN(1 / d) with no branch, for |d| in [2^-125, 2^125] (rcp_fast_ok): the
// special-function unit's approximation y0, then one Newton step with a
// fused residual, y0 + y0 (1 - d y0). It equals the correctly rounded
// reciprocal on every significand at every exponent that
// raycore_epilogue_rcp_check sweeps (tests/test_torch_kernels.py). A
// division's own fast path ends in a branch to its slow path, which cuts
// the 16 pairs of a thread into 16 blocks the compiler cannot interleave.
__device__ __forceinline__ float rcp_fast(float d) {
  const float y0 = rcp_approx(d);
  return __fmaf_rn(y0, __fmaf_rn(-d, y0, 1.0f), y0);
}

__device__ __forceinline__ bool rcp_fast_ok(float d) {
  const float a = fabsf(d);
  return (a >= 0x1p-125f) & (a <= 0x1p125f);
}

// torch.maximum on the card: NaN propagates.
__device__ __forceinline__ float max_prop(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// The tool's `comb` for every quantity at once: det over features 0-2,
// udet and vdet over 0-5, tdet over 6-9, each the first product, then
// each further product added, every step rounded (no FFMA fuses them).
__device__ __forceinline__ void vpu_block(const float* rowT, int pitch,
                                          const float4* tab, int g, int half,
                                          int p, float4 acc[RM][RL]) {
#pragma unroll
  for (int f = 0; f < 10; ++f) {
    const float4 a0 =
        *reinterpret_cast<const float4*>(rowT + f * pitch + 4 * g);
    const float4 a1 =
        *reinterpret_cast<const float4*>(rowT + f * pitch + half + 4 * g);
    const float a[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float4 w[RL] = {tab[f * C + RL * p], tab[f * C + RL * p + 1]};
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        float4& q = acc[i][j];
        if (f < 3) {
          const float m = __fmul_rn(a[i], w[j].x);
          q.x = f == 0 ? m : __fadd_rn(q.x, m);
        }
        if (f < 6) {
          const float mu = __fmul_rn(a[i], w[j].y);
          const float mv = __fmul_rn(a[i], w[j].z);
          q.y = f == 0 ? mu : __fadd_rn(q.y, mu);
          q.z = f == 0 ? mv : __fadd_rn(q.z, mv);
        }
        if (f >= 6) {
          const float m = __fmul_rn(a[i], w[j].w);
          q.w = f == 6 ? m : __fadd_rn(q.w, m);
        }
      }
  }
}

// Variants that take the exact reciprocal.
template <int V>
constexpr bool EXACT_RCP = V == FULL || V == VPU_FULL || V == RECIP_ONLY;

// The key of one (row, lane) pair under variant V; `sink` collects what
// MATMUL_ONLY does not read. The exact-reciprocal variants take rcp_fast
// and mark `slow` (key INT_MAX) where det lies outside its range, unless
// EXACT, which divides.
template <int V, bool EXACT = false>
__device__ __forceinline__ int pair_key(const float4& q, int lane, float tmin,
                                        float cur_t, float eps, float one_eps,
                                        unsigned& sink, bool& slow) {
  const float det = q.x, udet = q.y, vdet = q.z, tdet = q.w;
  slow = false;
  if constexpr (V == MATMUL_ONLY) {
    sink ^= __float_as_uint(det) ^ __float_as_uint(udet) ^
            __float_as_uint(vdet);
    return __float_as_int(tdet);
  } else if constexpr (V == VPU_ONLY) {
    return __float_as_int(
        __fadd_rn(__fadd_rn(__fadd_rn(det, udet), vdet), tdet));
  } else if constexpr (V == NO_DIVIDE) {
    const float sd = det < 0.f ? -1.f : 1.f;
    const float ad = __fmul_rn(det, sd);
    const float us = __fmul_rn(udet, sd), vs = __fmul_rn(vdet, sd),
                ts = __fmul_rn(tdet, sd);
    const float ead = __fmul_rn(eps, ad);
    const float hi = __fadd_rn(ad, ead);
    const bool ok = (us >= -ead) && (us <= hi) && (vs >= -ead) &&
                    (__fadd_rn(us, vs) <= hi) &&
                    (ts >= __fmul_rn(tmin, ad)) &&
                    (ts <= __fmul_rn(cur_t, ad));
    const float t = __fmul_rn(ts, rcp_approx(max_prop(ad, 1e-30f)));
    return ok ? ((t_key(t) & ~LANE_MASK) | lane) : INT_MAX;
  } else {
    float rr;
    if constexpr (V == APPROX_RECIP) {
      rr = rcp_approx(det);
    } else if constexpr (EXACT) {
      rr = __fdiv_rn(1.0f, det);
    } else {
      rr = rcp_fast(det);
      slow = !rcp_fast_ok(det);
    }
    const float u = __fmul_rn(udet, rr), v = __fmul_rn(vdet, rr),
                t = __fmul_rn(tdet, rr);
    int key;
    if constexpr (V == RECIP_ONLY) {
      key = __float_as_int(__fadd_rn(__fadd_rn(u, v), t));
    } else {
      const bool ok = (u >= -eps) && (u <= one_eps) && (v >= -eps) &&
                      (__fadd_rn(u, v) <= one_eps) && (t >= tmin) &&
                      (t <= cur_t);
      key = ok ? ((t_key(t) & ~LANE_MASK) | lane) : INT_MAX;
    }
    return slow ? INT_MAX : key;
  }
}

template <int V, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
    epilogue_probe_kernel(const float* __restrict__ phi_all,
                          const float* __restrict__ feats,
                          const float* __restrict__ tmin_all,
                          const int* __restrict__ key0_all,
                          int* __restrict__ out, int n_tiles, int TILE,
                          int same_tile, float eps, float one_eps) {
  constexpr bool ACCEPTS =
      V == FULL || V == VPU_FULL || V == NO_DIVIDE || V == APPROX_RECIP;
  extern __shared__ float4 smem4[];
  float4* const tab = smem4;   // (16, C) float4: a lane's 4 quantities
  const Layout L = fma_block::layout(TILE, THREADS);
  float* const rowT = reinterpret_cast<float*>(smem4 + FEAT * C);
  // ACCEPTS: each padded row's t_min and carried t.
  float* const tmin_s = rowT + FEAT * L.pitch;
  float* const curt_s = tmin_s + 2 * L.half;

  const int tid = threadIdx.x;
  const int tile = same_tile ? 0 : blockIdx.x % n_tiles;
  const size_t row0 = (size_t)tile * TILE;
  const float* src = feats + (size_t)tile * FEAT * 4 * C;
  for (int i = tid; i < FEAT * C; i += THREADS) {
    const float* s = src + (i / C) * 4 * C + i % C;
    tab[i] = make_float4(__ldg(s), __ldg(s + C), __ldg(s + 2 * C),
                         __ldg(s + 3 * C));
  }
  const float4* phi4 = reinterpret_cast<const float4*>(phi_all) + row0 * 4;
  for (int i = tid; i < 4 * TILE; i += THREADS) {
    const int m = i % TILE, kq = i / TILE;
    const float4 v = __ldg(phi4 + (size_t)m * 4 + kq);
    float* d = rowT + 4 * kq * L.pitch + m;
    d[0] = v.x;
    d[L.pitch] = v.y;
    d[2 * L.pitch] = v.z;
    d[3 * L.pitch] = v.w;
  }
  if constexpr (ACCEPTS) {
    for (int m = tid; m < TILE; m += THREADS) {
      tmin_s[m] = tmin_all[row0 + m];
      curt_s[m] = __int_as_float(key0_all[row0 + m] & ~LANE_MASK);
    }
  }
  __syncthreads();

  const int g = tid / L.tl, s = tid % L.tl;
  int best[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) best[i] = INT_MAX;
  unsigned sink = 0;
  // A warp with a thread of a row group in use runs the lane loop whole,
  // so that its votes see every thread; threads past the row groups write
  // nothing.
  if ((tid & ~31) / L.tl < L.n_rg) {
    const int gc = min(g, L.n_rg - 1);
    for (int p = s; p < fma_block::LANE_PAIRS; p += L.tl) {
      float4 acc[RM][RL];
      if constexpr (V == VPU_ONLY || V == VPU_FULL)
        vpu_block(rowT, L.pitch, tab, gc, L.half, p, acc);
      else
        fma_block::contract<FEAT>(rowT, L.pitch, tab, gc, L.half, p, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = row_of(L, gc, i);
        const float tmin = ACCEPTS ? tmin_s[r] : 0.f;
        const float cur_t = ACCEPTS ? curt_s[r] : 0.f;
        bool slow[RL];
#pragma unroll
        for (int j = 0; j < RL; ++j)
          best[i] = min(best[i], pair_key<V>(acc[i][j], RL * p + j, tmin,
                                             cur_t, eps, one_eps, sink,
                                             slow[j]));
        // Dets outside rcp_fast's range (none on the tool's data): divide.
        if (EXACT_RCP<V> && __any_sync(0xffffffffu, slow[0] | slow[1])) {
#pragma unroll
          for (int j = 0; j < RL; ++j)
            if (slow[j]) {
              bool sl;
              best[i] = min(best[i], pair_key<V, true>(
                                         acc[i][j], RL * p + j, tmin, cur_t,
                                         eps, one_eps, sink, sl));
            }
        }
      }
    }
  }
  // MATMUL_ONLY: the TPU's matrix unit computes all four quantities. eps
  // is positive, so this never happens, but it keeps the compiler from
  // dropping the three quantities the key does not read (a logic
  // operation or two per pair's 64 fused multiply-adds).
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (V == MATMUL_ONLY && eps < 0.f) best[i] = static_cast<int>(sink);
    for (int m = 1; m < L.tl; m <<= 1)
      best[i] = min(best[i], __shfl_xor_sync(0xffffffffu, best[i], m));
  }
  if (g < L.n_rg && s == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = row_of(L, g, i);
      if (r < TILE)
        out[row0 + r] = ACCEPTS ? min(best[i], key0_all[row0 + r]) : best[i];
    }
  }
}

template <int V, int THREADS>
int launch_with(const float* phi, const float* feats, const float* tmin,
                const int* key0, int* out, int n_tiles, int TILE,
                int n_blocks, int same_tile, float eps, float one_eps,
                cudaStream_t stream) {
  const Layout L = fma_block::layout(TILE, THREADS);
  const size_t smem = sizeof(float4) * FEAT * C +
                      sizeof(float) * (FEAT * L.pitch + 4 * L.half);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        epilogue_probe_kernel<V, THREADS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  epilogue_probe_kernel<V, THREADS><<<n_blocks, THREADS, smem, stream>>>(
      phi, feats, tmin, key0, out, n_tiles, TILE, same_tile, eps, one_eps);
  return static_cast<int>(cudaGetLastError());
}

// 256 threads a block, 128 for tiles of at most 256 rows: a small tile's
// CTA stages a whole table for little work, so more of them share an SM
// and one's staging overlaps another's arithmetic.
template <int V>
int launch(const float* phi, const float* feats, const float* tmin,
           const int* key0, int* out, int n_tiles, int TILE, int n_blocks,
           int same_tile, float eps, float one_eps, cudaStream_t stream) {
  return TILE <= 256
             ? launch_with<V, 128>(phi, feats, tmin, key0, out, n_tiles, TILE,
                                   n_blocks, same_tile, eps, one_eps, stream)
             : launch_with<V, 256>(phi, feats, tmin, key0, out, n_tiles, TILE,
                                   n_blocks, same_tile, eps, one_eps,
                                   stream);
}

// Counts, over every significand of the dets 2^e (1 + m 2^-23), m < 2^23,
// of both signs, those where rcp_fast differs from the correctly rounded
// reciprocal (counts[0]) and those in rcp_fast_ok's range (counts[1]).
__global__ void rcp_check_kernel(int e, unsigned long long* counts) {
  const unsigned m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (1u << 24)) return;
  const float d = __uint_as_float(((m & 1u) << 31) |
                                  (static_cast<unsigned>(e + 127) << 23) |
                                  (m >> 1));
  if (!rcp_fast_ok(d)) return;
  atomicAdd(counts + 1, 1ull);
  if (__float_as_uint(rcp_fast(d)) != __float_as_uint(__frcp_rn(d)))
    atomicAdd(counts, 1ull);
}

}  // namespace

extern "C" {

// rcp_check_kernel for exponent e in [-126, 127]; counts (2,) uint64,
// zeroed by the caller.
int raycore_epilogue_rcp_check(int e, void* counts, void* stream) {
  if (e < -126 || e > 127) return static_cast<int>(cudaErrorInvalidValue);
  rcp_check_kernel<<<(1 << 24) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      e, static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}


// phi (n_tiles * TILE, 16), feats (n_tiles, 16, 4C) and tmin (n_tiles *
// TILE,) float32; key0 and out (n_tiles * TILE,) int32. Needs 1 <= TILE <=
// 1024, C == 128, 16-byte aligned phi and feats. Rows of tiles that no
// block visits are left as they are. Returns cudaGetLastError().
int raycore_epilogue_probe(const void* phi, const void* feats,
                           const void* tmin, const void* key0, void* out,
                           int n_tiles, int TILE, int lanes, int n_blocks,
                           int same_tile, int variant, float eps,
                           float one_eps, void* stream) {
  if (lanes != C || TILE < 1 || TILE > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(phi);
  const float* f = static_cast<const float*>(feats);
  const float* tm = static_cast<const float*>(tmin);
  const int* k0 = static_cast<const int*>(key0);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAYCORE_EPILOGUE(V)                                                   \
  case V:                                                                     \
    return launch<V>(p, f, tm, k0, o, n_tiles, TILE, n_blocks, same_tile,    \
                     eps, one_eps, s);
  switch (variant) {
    RAYCORE_EPILOGUE(MATMUL_ONLY)
    RAYCORE_EPILOGUE(VPU_ONLY)
    RAYCORE_EPILOGUE(FULL)
    RAYCORE_EPILOGUE(VPU_FULL)
    RAYCORE_EPILOGUE(NO_DIVIDE)
    RAYCORE_EPILOGUE(APPROX_RECIP)
    RAYCORE_EPILOGUE(RECIP_ONLY)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RAYCORE_EPILOGUE
}

}  // extern "C"
