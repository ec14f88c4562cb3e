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
// tests for 262,144 rays against 65,024 triangles). Every test computes
// s1 = d x e2, det, p = o - v0 and u's numerator p . s1 (15 float
// instructions); under 1% of tests pass u. The table (2.4 MB) and the rays
// are read once.
//
// Design. One ray a thread, RAYS_PER_CTA rays a CTA, the ray and its best
// (t, index, u, v) in registers. The CTA stages the table TRI_BLOCK
// triangles at a time in shared memory as v0, e1 = v1 - v0 and e2 = v2 -
// v0 (the same rounded differences the test computes), two float4 rows
// and e2z a triangle; every thread then reads the same triangle at the
// same time, a broadcast. Per (ray, triangle) the kernel computes det and
// u's numerator and, without dividing, decides whether u may pass
// (u_may_pass). The warp votes once for TB triangles, then once for each
// of them if that vote finds a ray that may pass; only then does it pay
// for the division, u, v and t. Computing the TB tests ahead of one vote,
// with no branch among them, lets the compiler overlap their loads and
// dependent chains; the sweep is bound by that latency, so the kernel asks
// for MIN_CTAS CTAs an SM (40 registers a thread, no spills). Triangles go
// in ascending order and a strict t < best_t keeps the lowest index, as
// the TPU kernel's per-block argmin does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TRI_BLOCK = 512;
constexpr int RAYS_PER_CTA = 256;
constexpr int TB = 4;         // triangles a vote
constexpr int MIN_CTAS = 6;   // CTAs an SM: at most 42 registers a thread
constexpr unsigned FULL = 0xffffffffu;

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

// False only where the exact test must reject u, that is where u =
// RN(unum * RN(1/det)) is below 0, above 1 or NaN; the kernel then skips
// the division. With a = |det|, su = unum with det's sign flipped into
// its own (so u = RN(su * RN(1/a))), p = RN(a 2^-20) and q = RN(a (1 +
// 2^-20)), u may pass only where -p <= su < q.
//
// Why a refusal is safe, for every det (eps = 2^-24; RN is monotone):
// - su NaN (unum NaN) or a NaN (det NaN): u is NaN. Refused, as the
//   compares fail.
// - a = +inf: p = q = inf, so only su = +inf or NaN is refused, where u =
//   su * 0 is NaN (u = su * 0 is +-0 otherwise, which passes u).
// - a = 0 (det = +-0, as the table's zero padding): p = q = 0, so every su
//   is refused; RN(1/a) = inf and u = su * inf is +-inf or NaN.
// - su < -p: su < 0, and u < 0 must hold, not u = -0, which passes u >= 0:
//   RN(x) < 0 iff x < -2^-150. If a <= 2^-60, RN(1/a) >= 2^60 (or inf) and
//   |su| >= 2^-149, so |x| >= 2^-89. If 2^-60 <= a <= 2^126, p = a 2^-20
//   exactly, 1/a is normal and |x| >= (|su|/a)(1 - eps) > 2^-20 (1 - eps).
//   If a > 2^126, 1/a is subnormal with relative error at most 2^-149 /
//   2^-128 = 2^-21, p = a 2^-20 exactly, and |x| > 2^-20 (1 - 2^-21).
// - su >= q > 0: u > 1 must hold, RN(x) > 1 iff x > 1 + 2^-24. If a is a
//   normal number below 2^126, q >= a (1 + 2^-20)(1 - eps) and x >=
//   (su/a)(1 - eps) >= (1 + 2^-20)(1 - eps)^2 > 1 + 2^-21. If a is
//   subnormal: for a below about 2^-128, RN(1/a) = inf and x = inf; else
//   1/a is normal, q is within 2^-150 <= a 2^-22 of a (1 + 2^-20), and x >=
//   (1 + 3 2^-22)(1 - eps) > 1 + 2^-24. If a > 2^126, either q = inf and su
//   = inf gives x = inf, or x >= (1 + 2^-20)(1 - eps)(1 - 2^-21) > 1 +
//   2^-22.
__device__ __forceinline__ bool u_may_pass(float det, float unum) {
  const float a = fabsf(det);
  const unsigned sign = __float_as_uint(det) & 0x80000000u;
  const float su = __uint_as_float(__float_as_uint(unum) ^ sign);
  const float p = __fmul_rn(a, 0x1p-20f);
  const float q = __fmul_rn(a, 0x1.00001p0f);
  return (su >= -p) & (su < q);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, lo, hi;
  bool live;   // a ray in the batch whose t range is not empty
  float best_t, best_u, best_v;
  int best_i;
};

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// What every test computes before u: s1 = d x e2, det = s1 . e1, p = o -
// v0 and u's numerator p . s1.
struct Head {
  float s1x, s1y, s1z, det, px, py, pz, unum;
};

__device__ __forceinline__ Head head(const Ray& r, const Tri& c) {
  Head h;
  h.s1x = cross_c(r.dy, c.e2z, r.dz, c.e2y);
  h.s1y = cross_c(r.dz, c.e2x, r.dx, c.e2z);
  h.s1z = cross_c(r.dx, c.e2y, r.dy, c.e2x);
  h.det = dot3(h.s1x, h.s1y, h.s1z, c.e1x, c.e1y, c.e1z);
  h.px = __fsub_rn(r.ox, c.v0x);
  h.py = __fsub_rn(r.oy, c.v0y);
  h.pz = __fsub_rn(r.oz, c.v0z);
  h.unum = dot3(h.px, h.py, h.pz, h.s1x, h.s1y, h.s1z);
  return h;
}

// The rest of the exact test and the best-hit update.
__device__ __forceinline__ void finish(Ray& r, const Tri& c, const Head& h,
                                       int idx) {
  const float invd = __fdiv_rn(1.0f, h.det);
  const float u = __fmul_rn(h.unum, invd);
  if (!(u >= 0.f && u <= 1.f)) return;
  // s2 = p x e1
  const float s2x = cross_c(h.py, c.e1z, h.pz, c.e1y);
  const float s2y = cross_c(h.pz, c.e1x, h.px, c.e1z);
  const float s2z = cross_c(h.px, c.e1y, h.py, c.e1x);
  const float v = __fmul_rn(dot3(r.dx, r.dy, r.dz, s2x, s2y, s2z), invd);
  if (!(v >= 0.f && __fadd_rn(u, v) <= 1.f)) return;
  const float t = __fmul_rn(dot3(c.e2x, c.e2y, c.e2z, s2x, s2y, s2z), invd);
  if (t >= r.lo && t <= r.hi && t < r.best_t) {
    r.best_t = t;
    r.best_i = idx;
    r.best_u = u;
    r.best_v = v;
  }
}

// One staged block of triangles: (v0x, v0y, v0z, e1x) and (e1y, e1z, e2x,
// e2y) as float4 rows, and e2z.
struct Block {
  float4 a[TRI_BLOCK], b[TRI_BLOCK];
  float z[TRI_BLOCK];
};

__device__ __forceinline__ Tri staged(const Block& s, int j) {
  const float4 a = s.a[j], b = s.b[j];
  return Tri{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, s.z[j]};
}

// Triangle g of the table, as it is staged.
__device__ __forceinline__ Tri fetch(const float* tbl, int T, int g) {
  const float* c = tbl + g;   // component k at c[k * T]
  const float v0x = c[0], v0y = c[(size_t)T], v0z = c[2 * (size_t)T];
  return Tri{v0x, v0y, v0z,
             __fsub_rn(c[3 * (size_t)T], v0x),
             __fsub_rn(c[4 * (size_t)T], v0y),
             __fsub_rn(c[5 * (size_t)T], v0z),
             __fsub_rn(c[6 * (size_t)T], v0x),
             __fsub_rn(c[7 * (size_t)T], v0y),
             __fsub_rn(c[8 * (size_t)T], v0z)};
}

__device__ __forceinline__ void store(Block& s, int j, const Tri& c) {
  s.a[j] = make_float4(c.v0x, c.v0y, c.v0z, c.e1x);
  s.b[j] = make_float4(c.e1y, c.e1z, c.e2x, c.e2y);
  s.z[j] = c.e2z;
}

// The tests of one staged block of n triangles (a whole number of TB;
// zero triangles pad it), TB triangles a step: one vote for the TB
// triangles and one for each of them where that finds a ray that may pass
// u; finish() runs only for a ray that may.
__device__ __forceinline__ void test_block(const Block& s, int n, int base,
                                           Ray& r) {
  for (int j0 = 0; j0 < n; j0 += TB) {
    bool may[TB];
    bool any = false;
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      const Head h = head(r, staged(s, j0 + t));
      // & and |, not && and ||: a branch here would keep the compiler
      // from overlapping the TB tests.
      may[t] = r.live & u_may_pass(h.det, h.unum);
      any |= may[t];
    }
    if (!__any_sync(FULL, any)) continue;
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (!__any_sync(FULL, may[t])) continue;
      const Tri c = staged(s, j0 + t);
      if (may[t]) finish(r, c, head(r, c), base + j0 + t);
    }
  }
}

__global__ void __launch_bounds__(RAYS_PER_CTA, MIN_CTAS)
brute_sweep_kernel(const float* __restrict__ tbl, int T,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_min,
                   const float* __restrict__ t_max, float* __restrict__ t_out,
                   int* __restrict__ idx_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int R) {
  static_assert(TRI_BLOCK % TB == 0, "TB must divide TRI_BLOCK");
  __shared__ Block blk;
  const int i = blockIdx.x * RAYS_PER_CTA + threadIdx.x;
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f, false, INFINITY, 0.f, 0.f,
        -1};
  if (i < R) {
    r.ox = o[3 * (size_t)i];
    r.oy = o[3 * (size_t)i + 1];
    r.oz = o[3 * (size_t)i + 2];
    r.dx = d[3 * (size_t)i];
    r.dy = d[3 * (size_t)i + 1];
    r.dz = d[3 * (size_t)i + 2];
    r.lo = t_min[i];
    r.hi = t_max[i];
    // An accepted t has lo <= t <= hi; a NaN bound fails both.
    r.live = r.lo <= r.hi;
  }
  for (int base = 0; base < T; base += TRI_BLOCK) {
    const int n = min(TRI_BLOCK, T - base);
    const int padded = (n + TB - 1) / TB * TB;
    __syncthreads();   // every thread is done with the previous block
    // Zero triangles pad the block to whole steps: det = 0, so every
    // test of theirs is refused, and none hits.
    for (int j = threadIdx.x; j < padded; j += RAYS_PER_CTA)
      store(blk, j, j < n ? fetch(tbl, T, base + j) : Tri{});
    __syncthreads();
    test_block(blk, padded, base, r);
  }
  if (i < R) {
    const bool miss = r.best_i < 0;
    t_out[i] = miss ? 0.f : r.best_t;
    idx_out[i] = r.best_i;
    u_out[i] = miss ? 0.f : r.best_u;
    v_out[i] = miss ? 0.f : r.best_v;
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
                        void* stream) {
  const int grid = (R + RAYS_PER_CTA - 1) / RAYS_PER_CTA;
  brute_sweep_kernel<<<grid, RAYS_PER_CTA, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), T, static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(t_min),
      static_cast<const float*>(t_max), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
