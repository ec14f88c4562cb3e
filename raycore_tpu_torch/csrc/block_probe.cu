// Block probe (P4): ablations of the regroup sweep's per-block cost.
//
// Replaces the TPU kernel tools/probe_block_overhead.py:make_kernel
// (launched by run_variant).
//
// Block b gathers SPB subgroups of G rows, rows = tbl[subs[b * SPB + s]]
// of an (n_sub + 1, G, 16) table (CONTIG: rows b * ROWS.. of an (n_blocks,
// ROWS, 16) table, ROWS = SPB * G), and takes the featurized product of
// each row, with its columns >= 13 zeroed, against the (16, 4C) table
// feats[max(cids[b], 0)]: det, udet, vdet, tdet for C lanes. The
// epilogue (FULL, CONTIG, NO_MATMUL) divides, u = udet / det, v, t
// likewise, accepts u, v >= -eps, u <= 1 + eps, u + v <= 1 + eps and t in
// [row column 13, row column 14], and writes per row the min over lanes of
// the bits of max(t, 0) (INT32_MAX when nothing is accepted) and the
// smallest lane that attains it (lane 0 when nothing is accepted).
// MM_ONLY computes the product and writes the bits of lane 0's det and
// lane 0. NO_MATMUL replaces the product with row column 0 + feats row 0
// and keeps the epilogue.
//
// This is not K2's function, so it does not use featurized.cuh: the
// tool's tables are random normals, so all 13 feature rows the zeroed
// columns leave are nonzero (K2's tables have 10), the epilogue divides
// where K2 multiplies by a rounded reciprocal, and a row without a hit
// reports lane 0. The dot is a 13-step fused multiply-add chain in
// ascending feature order and every epilogue operation an explicitly
// rounded intrinsic, which the plain version emulates bit for bit.
//
// What bounds it on this card: arithmetic, 4 * 13 fused multiply-adds per
// (row, lane) against 67 TFLOP/s of float32 (K2 at the headline does 4 *
// 10); the gathered rows (64 B each) and the tables (26 KB a cluster) are
// read once.
//
// Design: as K2's kernel, one CTA per block and one thread per row (ROWS <=
// 1024). The cluster's 13 used feature rows are staged in shared memory (26
// KB at C = 128); every thread walks the C lanes four at a time, all
// threads reading the same float4 at once, a broadcast.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int FEAT = 16;
constexpr int DEPTH = 13;   // columns below COL_TMIN enter the product
constexpr int COL_TMIN = 13;
constexpr int COL_TMAX = 14;

enum Variant { FULL = 0, CONTIG = 1, MM_ONLY = 2, NO_MATMUL = 3 };

// int32 bits of max(t, 0): +0 for t <= 0.
__device__ __forceinline__ int t_key(float t) {
  return __float_as_int(t > 0.f ? t : 0.f);
}

template <int V>
__global__ void __launch_bounds__(1024)
    block_probe_kernel(const int* __restrict__ subs,
                       const int* __restrict__ cids,
                       const float* __restrict__ tbl,
                       const float* __restrict__ feats,
                       int* __restrict__ key_out, int* __restrict__ lane_out,
                       int G, int SPB, int C, float eps, float one_eps) {
  extern __shared__ float4 table4[];   // (DEPTH or 1, 4C) floats as float4
  const int ROWS = blockDim.x;
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int cid = max(cids[b], 0);
  const float4* src =
      reinterpret_cast<const float4*>(feats + (size_t)cid * FEAT * 4 * C);
  const int staged = (V == NO_MATMUL ? 1 : DEPTH) * C;
  for (int i = r; i < staged; i += ROWS) table4[i] = __ldg(src + i);

  const float* row =
      V == CONTIG ? tbl + ((size_t)b * ROWS + r) * FEAT
                  : tbl + ((size_t)subs[(size_t)b * SPB + r / G] * G + r % G) *
                              FEAT;
  float phi[FEAT];
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = p[i];
    phi[4 * i] = v.x; phi[4 * i + 1] = v.y;
    phi[4 * i + 2] = v.z; phi[4 * i + 3] = v.w;
  }
  const float t_min = phi[COL_TMIN];
  const float t_max = phi[COL_TMAX];
  __syncthreads();

  const int C4 = C / 4;
  int best = INT_MAX;
  int lane = 0;
  int mm_key = 0;
  int sink = 0;   // MM_ONLY: every lane's quantities, folded
  for (int c4 = 0; c4 < C4; ++c4) {
    float q[4][4];   // [det, udet, vdet, tdet][lane j of the four]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (V == NO_MATMUL) {
        const float4 w = table4[k * C4 + c4];
        q[k][0] = __fadd_rn(phi[0], w.x); q[k][1] = __fadd_rn(phi[0], w.y);
        q[k][2] = __fadd_rn(phi[0], w.z); q[k][3] = __fadd_rn(phi[0], w.w);
      } else {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int f = 0; f < DEPTH; ++f) {
          const float4 w = table4[f * C + k * C4 + c4];
          acc.x = __fmaf_rn(phi[f], w.x, acc.x);
          acc.y = __fmaf_rn(phi[f], w.y, acc.y);
          acc.z = __fmaf_rn(phi[f], w.z, acc.z);
          acc.w = __fmaf_rn(phi[f], w.w, acc.w);
        }
        q[k][0] = acc.x; q[k][1] = acc.y; q[k][2] = acc.z; q[k][3] = acc.w;
      }
    }
    if constexpr (V == MM_ONLY) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sink ^= __float_as_int(q[k][0]) ^ __float_as_int(q[k][1]) ^
                __float_as_int(q[k][2]) ^ __float_as_int(q[k][3]);
      if (c4 == 0) mm_key = __float_as_int(q[0][0]);
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = __fdiv_rn(q[1][j], q[0][j]);
      const float v = __fdiv_rn(q[2][j], q[0][j]);
      const float t = __fdiv_rn(q[3][j], q[0][j]);
      const bool ok = (u >= -eps) && (u <= one_eps) && (v >= -eps) &&
                      (__fadd_rn(u, v) <= one_eps) && (t >= t_min) &&
                      (t <= t_max);
      const int kb = ok ? t_key(t) : INT_MAX;
      if (kb < best) {
        best = kb;
        lane = c4 * 4 + j;
      }
    }
  }
  // MM_ONLY: the TPU's matrix unit computes every lane. eps is positive,
  // so this store never happens, but it keeps the compiler from dropping
  // the lanes the variant does not write (a few logic operations per 208
  // fused multiply-adds, on the integer pipe).
  if (V == MM_ONLY && eps < 0.f) lane = sink;
  const size_t out = (size_t)b * ROWS + r;
  key_out[out] = V == MM_ONLY ? mm_key : best;
  lane_out[out] = lane;
}

template <int V>
int launch(const int* subs, const int* cids, const float* tbl,
           const float* feats, int* key, int* lane, int n_blocks, int G,
           int SPB, int C, float eps, float one_eps, cudaStream_t stream) {
  const size_t smem =
      sizeof(float4) * (V == NO_MATMUL ? 1 : DEPTH) * (size_t)C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_probe_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  block_probe_kernel<V><<<n_blocks, G * SPB, smem, stream>>>(
      subs, cids, tbl, feats, key, lane, G, SPB, C, eps, one_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// subs (n_blocks * SPB,) and cids (n_blocks,) int32; tbl (n_sub + 1, G, 16)
// float32, or for CONTIG (n_blocks, G * SPB, 16); feats (K, 16, 4C)
// float32; key and lane (n_blocks * G * SPB,) int32. Needs G * SPB <= 1024,
// C % 4 == 0 and 16-byte aligned tables. Returns cudaGetLastError().
int raycore_block_probe(const void* subs, const void* cids, const void* tbl,
                        const void* feats, void* key, void* lane,
                        int n_blocks, int G, int SPB, int C, int variant,
                        float eps, float one_eps, void* stream) {
  const int* s = static_cast<const int*>(subs);
  const int* c = static_cast<const int*>(cids);
  const float* t = static_cast<const float*>(tbl);
  const float* f = static_cast<const float*>(feats);
  int* k = static_cast<int*>(key);
  int* l = static_cast<int*>(lane);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case FULL:
      return launch<FULL>(s, c, t, f, k, l, n_blocks, G, SPB, C, eps,
                          one_eps, st);
    case CONTIG:
      return launch<CONTIG>(s, c, t, f, k, l, n_blocks, G, SPB, C, eps,
                            one_eps, st);
    case MM_ONLY:
      return launch<MM_ONLY>(s, c, t, f, k, l, n_blocks, G, SPB, C, eps,
                             one_eps, st);
    case NO_MATMUL:
      return launch<NO_MATMUL>(s, c, t, f, k, l, n_blocks, G, SPB, C, eps,
                               one_eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
