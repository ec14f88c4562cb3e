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
// read once. Three correctly rounded divisions a pair would cost about as
// much as the contraction.
//
// Design. Persistent CTAs, one an SM (512 threads where their shared
// memory fits, else 256), each walking blocks blockIdx.x, + gridDim.x,
// ...: while it computes one block, cp.async stages the next block's
// gathered rows (transposed, the 15 columns it reads) and cluster table
// (each lane's four quantities side by side) into the other of two
// buffers; the next block's ids are read into registers during the block
// and stored after it. The product is the register-blocked contraction of
// fma_block.cuh (8 rows by 2 lanes a thread). The epilogue divides only
// where uv_may_pass says the pair may pass (on the tool's data about 1
// pair in 12): each warp appends its survivors to a ring in shared memory
// (a scan of the threads' counts) and, 32 at a time, divides them one a
// thread, so the divisions run dense. A surviving pair that is accepted
// takes the atomic min of (key << 7 | lane) into its row's slot, which
// gives the smallest key and, on a tie, the smallest lane, the lane-by-
// lane walk's answer, in any order.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "fma_block.cuh"

namespace {

using fma_block::C;
using fma_block::Layout;
using fma_block::QCAP;
using fma_block::RL;
using fma_block::RM;
using fma_block::row_of;
using fma_block::t_key;

constexpr int FEAT = 16;
constexpr int DEPTH = 13;   // columns below COL_TMIN enter the product
constexpr int STAGED = 15;  // row columns staged: the product's, t_min, t_max
constexpr int COL_TMIN = 13;
constexpr int COL_TMAX = 14;
constexpr unsigned FULL_MASK = 0xffffffffu;
// Dynamic shared memory a block may opt in to on sm_90.
constexpr size_t SMEM_OPTIN = 232448;
// A row's slot before any pair is accepted: key INT_MAX, lane 0.
constexpr unsigned long long EMPTY_SLOT = (unsigned long long)INT_MAX << 7;

enum Variant { FULL = 0, CONTIG = 1, MM_ONLY = 2, NO_MATMUL = 3 };

// Byte offsets of the shared-memory regions.
struct Plan {
  size_t tab, ring, rows, slots, ring_idx, ids, total;
};

__host__ __device__ inline Plan plan(const Layout& L, int depth, int SPB,
                                     int threads) {
  const int WARPS = threads / 32;
  Plan m;
  size_t o = 0;
  m.tab = o;        // 2 x (depth, C) float4
  o += 2 * sizeof(float4) * depth * C;
  m.ring = o;       // WARPS x QCAP float4: a survivor's quantities
  o += sizeof(float4) * WARPS * QCAP;
  m.rows = o;       // 2 x (STAGED, pitch) float
  o += 2 * sizeof(float) * STAGED * L.pitch;
  m.slots = o;      // 2 half unsigned long long: a row's (key << 7 | lane)
  o += sizeof(unsigned long long) * 2 * L.half;
  m.ring_idx = o;   // WARPS x QCAP int: a survivor's row << 7 | lane
  o += sizeof(int) * WARPS * QCAP;
  m.ids = o;        // 2 x (SPB + 1) int: a block's subgroups, then its cid
  o += sizeof(int) * 2 * (SPB + 1);
  m.total = o;
  return m;
}

struct Args {
  const int* subs;
  const int* cids;
  const float* tbl;
  const float* feats;
  int* key_out;
  int* lane_out;
  int n_blocks, G, SPB;
  float eps, one_eps, m_lo, m_hi, m_v;
};

// Issue the copies of block b's rows and table into one buffer; `ids`
// holds b's subgroups and cid.
template <int V, int THREADS>
__device__ __forceinline__ void stage(const Args& A, const Layout& L, int b,
                                      const int* ids, float* tab,
                                      float* rowT) {
  const int tid = threadIdx.x, ROWS = A.G * A.SPB;
  const int depth = V == NO_MATMUL ? 1 : DEPTH;
  const float* fsrc = A.feats + (size_t)max(ids[A.SPB], 0) * FEAT * 4 * C;
  // tab float i = lane (i >> 2)'s quantity i & 3 of feature i >> 9.
  for (int i = tid; i < depth * 4 * C; i += THREADS)
    fma_block::cp_async4(tab + i, fsrc + (i >> 9) * 4 * C + (i & 3) * C +
                           ((i >> 2) & (C - 1)));
  // Row r = i >> 4, feature f = i & 15 (f < STAGED); r steps by THREADS /
  // 16 a turn.
  constexpr int RSTEP = THREADS / FEAT;
  const int f = tid & 15;
  int r = f < STAGED ? tid >> 4 : ROWS, rq = r / A.G, rr = r - rq * A.G;
  for (; r < ROWS; r += RSTEP) {
    const float* src =
        V == CONTIG ? A.tbl + ((size_t)b * ROWS + r) * FEAT
                    : A.tbl + ((size_t)ids[rq] * A.G + rr) * FEAT;
    fma_block::cp_async4(rowT + f * L.pitch + r, src + f);
    for (rr += RSTEP; rr >= A.G; rr -= A.G) ++rq;
  }
}

// The tool's test of one surviving pair: the three divisions, the clauses
// and, where it is accepted, the atomic min of (key << 7 | lane) into its
// row's slot.
__device__ __forceinline__ void accept_pair(const Args& A, const Layout& L,
                                            const float* rowT,
                                            const float4& q, int idx,
                                            unsigned long long* slots) {
  const int row = idx >> 7;
  const float u = __fdiv_rn(q.y, q.x);
  const float v = __fdiv_rn(q.z, q.x);
  const float t = __fdiv_rn(q.w, q.x);
  const bool ok = (u >= -A.eps) && (u <= A.one_eps) && (v >= -A.eps) &&
                  (__fadd_rn(u, v) <= A.one_eps) &&
                  (t >= rowT[COL_TMIN * L.pitch + row]) &&
                  (t <= rowT[COL_TMAX * L.pitch + row]);
  if (ok)
    atomicMin(slots + row,
              ((unsigned long long)(unsigned)t_key(t) << 7) | (idx & 127));
}

template <int V, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
    block_probe_kernel(const Args A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ROWS = A.G * A.SPB;
  const int depth = V == NO_MATMUL ? 1 : DEPTH;
  const Layout L = fma_block::layout(ROWS, THREADS);
  const Plan P = plan(L, depth, A.SPB, THREADS);
  float4* const tab0 = reinterpret_cast<float4*>(smem + P.tab);
  float* const rows0 = reinterpret_cast<float*>(smem + P.rows);
  unsigned long long* const slots =
      reinterpret_cast<unsigned long long*>(smem + P.slots);
  int* const ids0 = reinterpret_cast<int*>(smem + P.ids);
  const int tid = threadIdx.x, warp = tid >> 5;
  fma_block::Ring ring{reinterpret_cast<float4*>(smem + P.ring) + warp * QCAP,
                       reinterpret_cast<int*>(smem + P.ring_idx) + warp * QCAP,
                       0, 0};
  auto tab_of = [&](int s) { return tab0 + s * depth * C; };
  auto rows_of = [&](int s) { return rows0 + s * STAGED * L.pitch; };
  auto ids_of = [&](int s) { return ids0 + s * (A.SPB + 1); };
  // Block b's id i (subgroup i < SPB, then the cid at i = SPB).
  auto id_of = [&](int b, int i) {
    return i < A.SPB ? (V == CONTIG ? 0 : A.subs[(size_t)b * A.SPB + i])
                     : A.cids[b];
  };

  for (int r = tid; r < 2 * L.half; r += THREADS) slots[r] = EMPTY_SLOT;
  const int b0 = blockIdx.x, grid = gridDim.x;
  for (int i = tid; i <= A.SPB; i += THREADS) {
    ids_of(0)[i] = id_of(b0, i);
    if (b0 + grid < A.n_blocks) ids_of(1)[i] = id_of(b0 + grid, i);
  }
  __syncthreads();
  stage<V, THREADS>(A, L, b0, ids_of(0), reinterpret_cast<float*>(tab_of(0)),
           rows_of(0));
  fma_block::cp_commit();

  const int g = tid / L.tl, sl = tid % L.tl;
  const int gc = min(g, L.n_rg - 1);
  // A warp with a thread of a row group in use runs the lane loop whole,
  // so that its ballots see every thread.
  const bool warp_active = (tid & ~31) / L.tl < L.n_rg;
  unsigned sink = 0;   // MM_ONLY: every pair's quantities, folded
  for (int k = 0, b = b0; b < A.n_blocks; ++k, b += grid) {
    const int buf = k & 1;
    const int nb = b + grid, nnb = nb + grid;
    if (nb < A.n_blocks)
      stage<V, THREADS>(A, L, nb, ids_of(buf ^ 1),
               reinterpret_cast<float*>(tab_of(buf ^ 1)), rows_of(buf ^ 1));
    fma_block::cp_commit();
    // The ids of the block after next, read now and stored after this
    // block, so their latency hides behind it.
    const bool one_id = A.SPB < THREADS;
    int next_id = 0;
    if (one_id && nnb < A.n_blocks && tid <= A.SPB) next_id = id_of(nnb, tid);
    fma_block::cp_wait_one();
    __syncthreads();

    const float* rowT = rows_of(buf);
    const float4* tab = tab_of(buf);
    auto accept = [&](const float4& q, int idx) {
      accept_pair(A, L, rowT, q, idx, slots);
    };
    if (warp_active) {
      for (int p = sl; p < fma_block::LANE_PAIRS; p += L.tl) {
        float4 acc[RM][RL];
        if constexpr (V == NO_MATMUL) {
          const float4 a0 = *reinterpret_cast<const float4*>(rowT + 4 * gc);
          const float4 a1 =
              *reinterpret_cast<const float4*>(rowT + L.half + 4 * gc);
          const float a[RM] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int j = 0; j < RL; ++j) {
            const float4 w = tab[RL * p + j];
#pragma unroll
            for (int i = 0; i < RM; ++i)
              acc[i][j] = make_float4(__fadd_rn(a[i], w.x),
                                      __fadd_rn(a[i], w.y),
                                      __fadd_rn(a[i], w.z),
                                      __fadd_rn(a[i], w.w));
          }
        } else {
          fma_block::contract<DEPTH, THREADS == 512 ? 4 : DEPTH>(
              rowT, L.pitch, tab, gc, L.half, p, acc);
        }
        if constexpr (V == MM_ONLY) {
#pragma unroll
          for (int i = 0; i < RM; ++i) {
#pragma unroll
            for (int j = 0; j < RL; ++j)
              sink ^= __float_as_uint(acc[i][j].x) ^
                      __float_as_uint(acc[i][j].y) ^
                      __float_as_uint(acc[i][j].z) ^
                      __float_as_uint(acc[i][j].w);
            const int r = row_of(L, g, i);
            if (p == 0 && g < L.n_rg && r < ROWS) {
              A.key_out[(size_t)b * ROWS + r] = __float_as_int(acc[i][0].x);
              A.lane_out[(size_t)b * ROWS + r] = 0;
            }
          }
          continue;
        }
        fma_block::append(ring,
                          fma_block::may_mask(acc, L, g, ROWS, A.m_lo, A.m_hi,
                                              A.m_v),
                          acc, L, g, p, accept);
      }
      fma_block::flush(ring, accept);
    }
    if (one_id) {
      if (nnb < A.n_blocks && tid <= A.SPB) ids_of(buf)[tid] = next_id;
    } else if (nnb < A.n_blocks) {
      for (int i = tid; i <= A.SPB; i += THREADS)
        ids_of(buf)[i] = id_of(nnb, i);
    }
    __syncthreads();
    if constexpr (V != MM_ONLY) {
      for (int r = tid; r < ROWS; r += THREADS) {
        const unsigned long long s = slots[r];
        A.key_out[(size_t)b * ROWS + r] = static_cast<int>(s >> 7);
        A.lane_out[(size_t)b * ROWS + r] = static_cast<int>(s & 127);
        slots[r] = EMPTY_SLOT;
      }
    }
  }
  // MM_ONLY: the TPU's matrix unit computes every lane. eps is positive,
  // so this store never happens, but it keeps the compiler from dropping
  // the lanes the variant does not write (a few logic operations per 208
  // fused multiply-adds, on the integer pipe).
  if (V == MM_ONLY && A.eps < 0.f) A.lane_out[0] = static_cast<int>(sink);
}

template <int V, int THREADS>
int launch_with(const Args& A, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      block_probe_kernel<V, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, block_probe_kernel<V, THREADS>, THREADS, smem)) !=
          cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = min(A.n_blocks, sms * per_sm);
  block_probe_kernel<V, THREADS><<<grid, THREADS, smem, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

// 512 threads an SM where their shared memory fits (every shape the tool
// runs but ROWS 1024), else 256: more warps hide the epilogue's latency.
template <int V>
int launch(const Args& A, cudaStream_t stream) {
  const int depth = V == NO_MATMUL ? 1 : DEPTH;
  const int rows = A.G * A.SPB;
  const size_t wide =
      plan(fma_block::layout(rows, 512), depth, A.SPB, 512).total;
  if (wide <= SMEM_OPTIN) return launch_with<V, 512>(A, wide, stream);
  return launch_with<V, 256>(
      A, plan(fma_block::layout(rows, 256), depth, A.SPB, 256).total,
      stream);
}

}  // namespace

extern "C" {

// subs (n_blocks * SPB,) and cids (n_blocks,) int32; tbl (n_sub + 1, G, 16)
// float32, or for CONTIG (n_blocks, G * SPB, 16); feats (K, 16, 4C)
// float32; key and lane (n_blocks * G * SPB,) int32. Needs 1 <= G * SPB <=
// 1024, C == 128 and 16-byte aligned tables. Returns cudaGetLastError().
int raycore_block_probe(const void* subs, const void* cids, const void* tbl,
                        const void* feats, void* key, void* lane,
                        int n_blocks, int G, int SPB, int lanes, int variant,
                        float eps, float one_eps, void* stream) {
  if (lanes != C || G < 1 || SPB < 1 || G * SPB > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  // The pre-test's margins (fma_block.cuh:uv_may_pass).
  const float m_hi = nextafterf(one_eps, INFINITY);
  const double v_lo = (double)m_hi + (double)eps;
  float m_v = static_cast<float>(v_lo);
  if ((double)m_v < v_lo) m_v = nextafterf(m_v, INFINITY);
  const Args A{static_cast<const int*>(subs), static_cast<const int*>(cids),
               static_cast<const float*>(tbl),
               static_cast<const float*>(feats), static_cast<int*>(key),
               static_cast<int*>(lane), n_blocks, G, SPB, eps, one_eps,
               nextafterf(eps, INFINITY), m_hi, m_v};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case FULL: return launch<FULL>(A, st);
    case CONTIG: return launch<CONTIG>(A, st);
    case MM_ONLY: return launch<MM_ONLY>(A, st);
    case NO_MATMUL: return launch<NO_MATMUL>(A, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
