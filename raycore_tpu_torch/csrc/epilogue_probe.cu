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
// 1 ulp from the exact one (PTX ISA). Every other operation is an
// explicitly rounded intrinsic and the dot a 16-step fused multiply-add
// chain in ascending feature order, which the plain version emulates, so
// the two agree bit for bit except in those two variants.
//
// Several blocks work on the same tile and write its rows with the same
// values: the key is min(key over lanes, key0), and key0 is an input, not a
// value carried from block to block. On the card those writes race
// harmlessly.
//
// What bounds it on this card: arithmetic, 4 * 16 fused multiply-adds (the
// VPU variants 19 products and 15 additions) per (row, lane) against 67
// TFLOP/s of float32; the tiles' rows and tables are read from memory once
// and then hit L2.
//
// Design: one CTA per block, one thread per row (TILE <= 1024). The tile's
// (16, 4C) table is staged in shared memory (32 KB at C = 128); every
// thread walks the C lanes four at a time, all threads reading the same
// float4 at once, a broadcast; a strict < keeps the smallest lane.

#include <climits>
#include <cuda_runtime.h>

namespace {

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

// torch.maximum on the card: NaN propagates.
__device__ __forceinline__ float max_prop(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// int32 bits of max(t, 0) as a key: +0 for t <= 0.
__device__ __forceinline__ int t_key(float t) {
  return __float_as_int(t > 0.f ? t : 0.f);
}

// The sum of phi[k] * table[k][column] for k = K0, Ks... in that order, as
// the tool's `comb`: the first product, then each further product added,
// every step rounded. `col` is the column's float index within a row.
template <int K0, int... Ks>
__device__ __forceinline__ float comb(const float phi[FEAT], const float* w,
                                      int row_len, int col) {
  float acc = __fmul_rn(phi[K0], w[K0 * row_len + col]);
  ((acc = __fadd_rn(acc, __fmul_rn(phi[Ks], w[Ks * row_len + col]))), ...);
  return acc;
}

template <int V>
__global__ void __launch_bounds__(1024)
    epilogue_probe_kernel(const float* __restrict__ phi_all,
                          const float* __restrict__ feats,
                          const float* __restrict__ tmin_all,
                          const int* __restrict__ key0_all,
                          int* __restrict__ out, int n_tiles, int C,
                          int same_tile, float eps, float one_eps) {
  extern __shared__ float4 table4[];   // (16, 4C) floats as float4
  const int TILE = blockDim.x;
  const int tile = same_tile ? 0 : blockIdx.x % n_tiles;
  const int r = threadIdx.x;
  const float4* src =
      reinterpret_cast<const float4*>(feats + (size_t)tile * FEAT * 4 * C);
  for (int i = r; i < FEAT * C; i += TILE) table4[i] = __ldg(src + i);

  const size_t row = (size_t)tile * TILE + r;
  float phi[FEAT];
  const float4* p = reinterpret_cast<const float4*>(phi_all + row * FEAT);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = p[i];
    phi[4 * i] = v.x; phi[4 * i + 1] = v.y;
    phi[4 * i + 2] = v.z; phi[4 * i + 3] = v.w;
  }
  const float tmin = tmin_all[row];
  const int cur_key = key0_all[row];
  const float cur_t = __int_as_float(cur_key & ~LANE_MASK);
  __syncthreads();

  const int C4 = C / 4;
  int best = INT_MAX;
  int sink = 0;
  for (int c4 = 0; c4 < C4; ++c4) {
    float q[4][4];   // [det, udet, vdet, tdet][lane j of the four]
    if constexpr (V == VPU_ONLY || V == VPU_FULL) {
      const float* w = reinterpret_cast<const float*>(table4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * c4 + j;
        q[0][j] = comb<0, 1, 2>(phi, w, 4 * C, col);
        q[1][j] = comb<0, 1, 2, 3, 4, 5>(phi, w, 4 * C, C + col);
        q[2][j] = comb<0, 1, 2, 3, 4, 5>(phi, w, 4 * C, 2 * C + col);
        q[3][j] = comb<6, 7, 8, 9>(phi, w, 4 * C, 3 * C + col);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int f = 0; f < FEAT; ++f) {
          const float4 w = table4[f * C + k * C4 + c4];
          acc.x = __fmaf_rn(phi[f], w.x, acc.x);
          acc.y = __fmaf_rn(phi[f], w.y, acc.y);
          acc.z = __fmaf_rn(phi[f], w.z, acc.z);
          acc.w = __fmaf_rn(phi[f], w.w, acc.w);
        }
        q[k][0] = acc.x; q[k][1] = acc.y; q[k][2] = acc.z; q[k][3] = acc.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lane = c4 * 4 + j;
      const float det = q[0][j], udet = q[1][j], vdet = q[2][j],
                  tdet = q[3][j];
      int key;
      if constexpr (V == MATMUL_ONLY) {
        sink ^= __float_as_int(det) ^ __float_as_int(udet) ^
                __float_as_int(vdet);
        key = __float_as_int(tdet);
      } else if constexpr (V == VPU_ONLY) {
        key = __float_as_int(
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
        key = ok ? ((t_key(t) & ~LANE_MASK) | lane) : INT_MAX;
      } else {
        const float rr = (V == APPROX_RECIP) ? rcp_approx(det)
                                             : __fdiv_rn(1.0f, det);
        const float u = __fmul_rn(udet, rr), v = __fmul_rn(vdet, rr),
                    t = __fmul_rn(tdet, rr);
        if constexpr (V == RECIP_ONLY) {
          key = __float_as_int(__fadd_rn(__fadd_rn(u, v), t));
        } else {
          const bool ok = (u >= -eps) && (u <= one_eps) && (v >= -eps) &&
                          (__fadd_rn(u, v) <= one_eps) && (t >= tmin) &&
                          (t <= cur_t);
          key = ok ? ((t_key(t) & ~LANE_MASK) | lane) : INT_MAX;
        }
      }
      best = min(best, key);
    }
  }
  if constexpr (V == FULL || V == VPU_FULL || V == NO_DIVIDE ||
                V == APPROX_RECIP)
    best = min(best, cur_key);
  // MATMUL_ONLY: the TPU's matrix unit computes all four quantities. eps
  // is positive, so this store never happens, but it keeps the compiler
  // from dropping the three quantities the key does not read (a logic
  // operation or two per lane's 64 fused multiply-adds, on the integer
  // pipe).
  if (V == MATMUL_ONLY && eps < 0.f) best = sink;
  out[row] = best;
}

template <int V>
int launch(const float* phi, const float* feats, const float* tmin,
           const int* key0, int* out, int n_tiles, int TILE, int C,
           int n_blocks, int same_tile, float eps, float one_eps,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * FEAT * 4 * (size_t)C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        epilogue_probe_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  epilogue_probe_kernel<V><<<n_blocks, TILE, smem, stream>>>(
      phi, feats, tmin, key0, out, n_tiles, C, same_tile, eps, one_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// phi (n_tiles * TILE, 16), feats (n_tiles, 16, 4C) and tmin (n_tiles *
// TILE,) float32; key0 and out (n_tiles * TILE,) int32. Needs TILE <= 1024,
// C % 4 == 0, 16-byte aligned phi and feats. Rows of tiles that no block
// visits are left as they are. Returns cudaGetLastError().
int raycore_epilogue_probe(const void* phi, const void* feats,
                           const void* tmin, const void* key0, void* out,
                           int n_tiles, int TILE, int C, int n_blocks,
                           int same_tile, int variant, float eps,
                           float one_eps, void* stream) {
  const float* p = static_cast<const float*>(phi);
  const float* f = static_cast<const float*>(feats);
  const float* tm = static_cast<const float*>(tmin);
  const int* k0 = static_cast<const int*>(key0);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAYCORE_EPILOGUE(V)                                                   \
  case V:                                                                     \
    return launch<V>(p, f, tm, k0, o, n_tiles, TILE, C, n_blocks, same_tile, \
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
