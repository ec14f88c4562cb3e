// K8: the instanced frame's affine arithmetic.
//
// It replaces no TPU kernel: the JAX package computes the instance
// refresh (raycore_tpu/scene/instanced.py:refresh_instances) and the
// instanced engine's local rays (raycore_tpu/ops/pallas_instanced.py) as
// XLA operations, whose compiler fuses their products into fused
// multiply-adds. The port's plain versions emulate each of those float32
// fused multiply-adds with about 17 float64 PyTorch operations
// (core/triangle.py:fma), so on the card a frame of the 128-instance
// scene ran about 357 launches of that emulation: 199 in the refresh and
// 79 in each of the engine's two local-ray calls. The card has fmaf in
// hardware, bit for bit the operation the emulation computes.
//
// Two entry points, one thread each a row; the products are affine.cuh's,
// so the kernel agrees with the plain versions (ops/affine.py) bit for bit.
//
// raycore_instance_refresh, one thread an instance: the inverse of its
// row-major 3x4 transform as core/transforms.py:mat3x4_inverse(fused=True)
// computes it (the rows of the 3x3 inverse are the fused cross products of
// columns (1, 2), (2, 0) and (0, 1) divided by det = dot3(col0, row 0);
// the translation is -dot3(row, t)), and the world box of its local root
// box as accel/tlas_build.py:transformed_aabbs computes it (corner i takes
// hi on axis a where bit a of i is set; each world coordinate is
// dot3(R_row, corner) + t_row; min and max over the 8 corners in the order
// of PyTorch's amin and amax on the card, which decides the sign of a zero
// face). The frame's refresh is 128 threads, bound by its launch.
//
// raycore_local_rays, one thread a row: a ray into an instance's local
// space, o_l = R o + t and d_l = R d, with R and t the instance's inverse.
// In pair mode (stage 1) row q*G + lane is ray sub[q]*G + lane through the
// inverse of instance inst[q] (int32 ids), a -0 in d_l becomes +0, and the
// ray's t_min and t_max are copied beside it. In ray mode (the finalize)
// row r is ray r through the inverse of instance max(inst[r], 0) (int64
// ids), and d_l keeps a -0. What bounds it on this card: its bytes, 24 read
// and 24 written a row plus 16 more in pair mode; at the refit frame's
// 1.2M pair rows and 1M rays that is about 0.03 ms at 3.35 TB/s.

#include <cstdint>

#include "affine.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
instance_refresh_kernel(const float* __restrict__ tf,
                        const float* __restrict__ lmin,
                        const float* __restrict__ lmax,
                        float* __restrict__ inv, float* __restrict__ wmin,
                        float* __restrict__ wmax, unsigned n) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = tf[size_t(i) * 12 + k];

  // The inverse: rows col1 x col2, col2 x col0, col0 x col1 over det.
  float col[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < 3; ++r) col[k][r] = m[r * 4 + k];
  float C[3][3];
  raycore::fcross(col[1], col[2], C[0]);
  raycore::fcross(col[2], col[0], C[1]);
  raycore::fcross(col[0], col[1], C[2]);
  const float det = raycore::fdot3(col[0][0], col[0][1], col[0][2], C[0][0],
                                   C[0][1], C[0][2]);
  float* out = inv + size_t(i) * 12;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float B[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) B[j] = __fdiv_rn(C[r][j], det);
#pragma unroll
    for (int j = 0; j < 3; ++j) out[r * 4 + j] = B[j];
    out[r * 4 + 3] = -raycore::fdot3(B[0], B[1], B[2], m[3], m[7], m[11]);
  }

  // The world box: per axis the 8 corners' coordinates, reduced as
  // PyTorch's amin and amax over 8 values reduce them on the card: four
  // accumulators take values k and k + 4, then fold in order.
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = lmin[size_t(i) * 3 + a];
    hi[a] = lmax[size_t(i) * 3 + a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float x[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float p[3] = {(c & 1) ? hi[0] : lo[0], (c & 2) ? hi[1] : lo[1],
                          (c & 4) ? hi[2] : lo[2]};
      x[c] = raycore::affine_row(m + a * 4, p);
    }
    float mn[4], mx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mn[k] = raycore::torch_min_step(x[k], x[k + 4]);
      mx[k] = raycore::torch_max_step(x[k], x[k + 4]);
    }
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      mn[0] = raycore::torch_min_step(mn[0], mn[k]);
      mx[0] = raycore::torch_max_step(mx[0], mx[k]);
    }
    wmin[size_t(i) * 3 + a] = mn[0];
    wmax[size_t(i) * 3 + a] = mx[0];
  }
}

template <bool PAIRS>
__global__ void __launch_bounds__(THREADS)
local_rays_kernel(const float* __restrict__ inv, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ t_min,
                  const float* __restrict__ t_max,
                  const int* __restrict__ sub, const void* __restrict__ inst,
                  float* __restrict__ o_l, float* __restrict__ d_l,
                  float* __restrict__ tmin_l, float* __restrict__ tmax_l,
                  unsigned n, unsigned G) {
  const unsigned row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  size_t ray, k;
  if (PAIRS) {
    const unsigned q = row / G;
    ray = size_t(static_cast<unsigned>(__ldg(sub + q))) * G + (row - q * G);
    k = static_cast<unsigned>(__ldg(static_cast<const int*>(inst) + q));
  } else {
    ray = row;
    const long long v = __ldg(static_cast<const long long*>(inst) + row);
    k = v > 0 ? static_cast<size_t>(v) : 0;
  }
  float m[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) m[j] = __ldg(inv + k * 12 + j);
  float p[3], v[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = __ldg(o + ray * 3 + a);
    v[a] = __ldg(d + ray * 3 + a);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* r = m + a * 4;
    o_l[size_t(row) * 3 + a] = raycore::affine_row(r, p);
    float dl = raycore::fdot3(r[0], r[1], r[2], v[0], v[1], v[2]);
    if (PAIRS) dl = (dl == 0.f) ? 0.f : dl;
    d_l[size_t(row) * 3 + a] = dl;
  }
  if (PAIRS) {
    tmin_l[row] = __ldg(t_min + ray);
    tmax_l[row] = __ldg(t_max + ray);
  }
}

}  // namespace

extern "C" {

// tf (n, 3, 4), lmin and lmax (n, 3), inv (n, 3, 4), wmin and wmax (n, 3),
// all float32. Returns cudaGetLastError().
int raycore_instance_refresh(const void* tf, const void* lmin,
                             const void* lmax, void* inv, void* wmin,
                             void* wmax, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned u = static_cast<unsigned>(n);
  instance_refresh_kernel<<<(u + THREADS - 1) / THREADS, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tf), static_cast<const float*>(lmin),
      static_cast<const float*>(lmax), static_cast<float*>(inv),
      static_cast<float*>(wmin), static_cast<float*>(wmax), u);
  return static_cast<int>(cudaGetLastError());
}

// inv (I, 3, 4), o and d (R, 3) float32; n output rows. pairs != 0: sub
// and inst (n / G,) int32, t_min and t_max (R,) float32, and tmin_l, tmax_l
// (n,) written; pairs == 0: inst (n,) int64, n == R, and t_min, t_max,
// sub, tmin_l, tmax_l unused. o_l and d_l (n, 3) float32. Returns
// cudaGetLastError().
int raycore_local_rays(const void* inv, const void* o, const void* d,
                       const void* t_min, const void* t_max, const void* sub,
                       const void* inst, void* o_l, void* d_l, void* tmin_l,
                       void* tmax_l, int n, int G, int pairs, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned u = static_cast<unsigned>(n);
  const dim3 grid((u + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fi = static_cast<const float*>(inv);
  const float* fo = static_cast<const float*>(o);
  const float* fd = static_cast<const float*>(d);
  if (pairs) {
    local_rays_kernel<true><<<grid, THREADS, 0, s>>>(
        fi, fo, fd, static_cast<const float*>(t_min),
        static_cast<const float*>(t_max), static_cast<const int*>(sub), inst,
        static_cast<float*>(o_l), static_cast<float*>(d_l),
        static_cast<float*>(tmin_l), static_cast<float*>(tmax_l), u,
        static_cast<unsigned>(G));
  } else {
    local_rays_kernel<false><<<grid, THREADS, 0, s>>>(
        fi, fo, fd, nullptr, nullptr, nullptr, inst, static_cast<float*>(o_l),
        static_cast<float*>(d_l), nullptr, nullptr, u, 1u);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
