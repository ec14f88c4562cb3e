// Dense brute-force sweep: every ray against every triangle of a small mesh.
//
// Replaces the TPU kernel raycore_tpu/ops/pallas_brute.py:_kernel (launched
// by _run).
//
// Per ray i: the closest triangle of the (9, T) component-major table
// (rows v0 xyz, v1 xyz, v2 xyz) under the scalar Möller–Trumbore test
// with no edge slack: u >= 0, u <= 1, v >= 0, u + v <= 1 and t in [t_min,
// t_max]; the smallest t wins and the lowest index among equal t. Writes
// t, the index, u and v (0, -1, 0, 0 on a miss). A zero (padding) triangle
// gives det = 0, 1/det = inf and u = 0 * inf = NaN, so it never hits.
//
// Arithmetic order. The reference's compiled CPU code contracts each cross
// product component a*b - c*d into fma(a, b, -(c*d)) and each 3-term dot
// into fma(a2, b2, fma(a1, b1, a0*b0)); the port's plain version and its
// oracle (core/triangle.py: cross, dot3, fast_intersect_triangle) evaluate
// exactly those chains. This kernel evaluates the same chains with
// __fmaf_rn, and every other operation with an explicitly rounded
// intrinsic (nvcc would otherwise contract a*b + c on its own), so it
// agrees with its plain version bit for bit.
//
// What bounds it on this card: arithmetic, against 67 TFLOP/s (17.0 G
// tests for 262,144 rays against 65,024 triangles). A test stops once u
// (then v) fails: 24 float32 operations up to u, 46 in full, and most
// tests of a ray stop at u. The table (2.4 MB) and the rays are read once.
//
// Design: one thread per ray (RAY_TILE = 256 rays per CTA), the ray and its
// best (t, index, u, v) in registers. The CTA stages the table 512
// triangles at a time in shared memory as v0, e1 = v1 - v0 and e2 = v2 -
// v0 (the same rounded differences the test computes), 12 floats per
// triangle in three float4 rows, 24 KB; every thread then reads the same
// triangle at the same time, a broadcast. Triangles go in ascending order
// and a strict t < best_t keeps the lowest index, as the TPU kernel's
// per-block argmin does. A ray whose u (then v) already fails skips the
// rest of its test; that changes no result.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TRI_BLOCK = 512;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// a1*b2 - a2*b1 as the reference's compiler fuses it.
__device__ __forceinline__ float cross_c(float a1, float b2, float a2,
                                         float b1) {
  return fma_(a1, b2, -__fmul_rn(a2, b1));
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return fma_(a2, b2, fma_(a1, b1, __fmul_rn(a0, b0)));
}

__global__ void brute_sweep_kernel(const float* __restrict__ tbl, int T,
                                   const float* __restrict__ o,
                                   const float* __restrict__ d,
                                   const float* __restrict__ t_min,
                                   const float* __restrict__ t_max,
                                   float* __restrict__ t_out,
                                   int* __restrict__ idx_out,
                                   float* __restrict__ u_out,
                                   float* __restrict__ v_out, int R) {
  // Per triangle: (v0x, v0y, v0z, e1x), (e1y, e1z, e2x, e2y), (e2z, -, -, -).
  __shared__ float4 tri[3][TRI_BLOCK];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float lo = 0.f, hi = -1.f;
  if (live) {
    ox = o[3 * (size_t)i];
    oy = o[3 * (size_t)i + 1];
    oz = o[3 * (size_t)i + 2];
    dx = d[3 * (size_t)i];
    dy = d[3 * (size_t)i + 1];
    dz = d[3 * (size_t)i + 2];
    lo = t_min[i];
    hi = t_max[i];
  }
  float best_t = INFINITY, best_u = 0.f, best_v = 0.f;
  int best_i = -1;
  for (int base = 0; base < T; base += TRI_BLOCK) {
    const int n = min(TRI_BLOCK, T - base);
    __syncthreads();   // every thread is done with the previous block
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float* c = tbl + base + j;   // component k at c[k * T]
      const float v0x = c[0], v0y = c[(size_t)T], v0z = c[2 * (size_t)T];
      const float e1x = __fsub_rn(c[3 * (size_t)T], v0x);
      const float e1y = __fsub_rn(c[4 * (size_t)T], v0y);
      const float e1z = __fsub_rn(c[5 * (size_t)T], v0z);
      const float e2x = __fsub_rn(c[6 * (size_t)T], v0x);
      const float e2y = __fsub_rn(c[7 * (size_t)T], v0y);
      const float e2z = __fsub_rn(c[8 * (size_t)T], v0z);
      tri[0][j] = make_float4(v0x, v0y, v0z, e1x);
      tri[1][j] = make_float4(e1y, e1z, e2x, e2y);
      tri[2][j] = make_float4(e2z, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float4 a = tri[0][j], b = tri[1][j], c = tri[2][j];
      const float v0x = a.x, v0y = a.y, v0z = a.z;
      const float e1x = a.w, e1y = b.x, e1z = b.y;
      const float e2x = b.z, e2y = b.w, e2z = c.x;
      // s1 = d x e2; det = s1 . e1
      const float s1x = cross_c(dy, e2z, dz, e2y);
      const float s1y = cross_c(dz, e2x, dx, e2z);
      const float s1z = cross_c(dx, e2y, dy, e2x);
      const float det = dot3(s1x, s1y, s1z, e1x, e1y, e1z);
      const float invd = __fdiv_rn(1.0f, det);
      const float px = __fsub_rn(ox, v0x);
      const float py = __fsub_rn(oy, v0y);
      const float pz = __fsub_rn(oz, v0z);
      const float u = __fmul_rn(dot3(px, py, pz, s1x, s1y, s1z), invd);
      if (!(u >= 0.f && u <= 1.f)) continue;
      // s2 = p x e1
      const float s2x = cross_c(py, e1z, pz, e1y);
      const float s2y = cross_c(pz, e1x, px, e1z);
      const float s2z = cross_c(px, e1y, py, e1x);
      const float v = __fmul_rn(dot3(dx, dy, dz, s2x, s2y, s2z), invd);
      if (!(v >= 0.f && __fadd_rn(u, v) <= 1.f)) continue;
      const float t = __fmul_rn(dot3(e2x, e2y, e2z, s2x, s2y, s2z), invd);
      if (t >= lo && t <= hi && t < best_t) {
        best_t = t;
        best_i = base + j;
        best_u = u;
        best_v = v;
      }
    }
  }
  if (live) {
    const bool miss = best_i < 0;
    t_out[i] = miss ? 0.f : best_t;
    idx_out[i] = best_i;
    u_out[i] = miss ? 0.f : best_u;
    v_out[i] = miss ? 0.f : best_v;
  }
}

}  // namespace

extern "C" {

// tbl (9, T) float32; o and d (R, 3) float32; t_min and t_max (R,) float32;
// t_out, u_out, v_out (R,) float32 and idx_out (R,) int32. Any R and T.
// Returns cudaGetLastError().
int raycore_brute_sweep(const void* tbl, const void* o, const void* d,
                        const void* t_min, const void* t_max, void* t_out,
                        void* idx_out, void* u_out, void* v_out, int R, int T,
                        int ray_tile, void* stream) {
  const int grid = (R + ray_tile - 1) / ray_tile;
  brute_sweep_kernel<<<grid, ray_tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), T, static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(t_min),
      static_cast<const float*>(t_max), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
