// The interval entry of a ray bundle into a box, shared by phase A (K1
// phase_a.cu) and the subgroup refine (K7 refine_pairs.cu).
//
// A bundle's stats row: o_lo 0:3, o_hi 3:6, i_lo 6:9, i_hi 9:12, t_min_lo
// 12, t_max_hi 13 (the origin and inverse-direction ranges, the t range).
// Per axis the slab interval is the min and max of the 8 corner products,
// widened to (-inf, inf) where a near-parallel ray of the bundle may start
// inside the slab; +inf marks a bundle that provably misses the box
// (ops/dense.py:interval_entry). Every entry takes the fast arithmetic
// (entry_fast); where the stats or the box lie outside the class in which
// that is proven exact, or where it finds t_lo = 0, it is recomputed with
// the plain version's arithmetic (entry_plain: interval_entry in the same
// order with explicitly rounded operations and PyTorch's NaN-propagating
// min/max). So both kernels agree with interval_entry bit for bit;
// ops/dense.py:interval_entry_paths repeats them.
#pragma once

#include "featurized.cuh"

namespace raycore {

// One bundle's stats as the kernels keep them: the row itself (cols 14
// and 15 unused), the origin range ordered, and flags: bit a (0-2) where
// axis a's inverse direction reaches the clamp (a bundle parallel to the
// slab), bit 3 (FAST_STATS) where the row is in entry_fast's class.
struct EntryStats {
  float st[16];
  float omn[3], omx[3];
  int flags;
};

constexpr int FAST_STATS = 8;

__device__ __forceinline__ bool is_finite(float v) {
  return fabsf(v) < INFINITY;
}

// Fill omn, omx and flags from st[0:14].
__device__ __forceinline__ void prepare_stats(EntryStats& ts, float clamp) {
  bool fast = !isnan(ts.st[12]) && !isnan(ts.st[13]);
  int flags = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float o_lo = ts.st[a], o_hi = ts.st[3 + a];
    const float i_lo = ts.st[6 + a], i_hi = ts.st[9 + a];
    ts.omn[a] = fminf(o_lo, o_hi);
    ts.omx[a] = fmaxf(o_lo, o_hi);
    fast = fast && is_finite(o_lo) && is_finite(o_hi) && is_finite(i_lo) &&
           is_finite(i_hi) && i_lo != 0.f && i_hi != 0.f;
    flags |= ((i_hi >= clamp) || (i_lo <= -clamp)) << a;
  }
  ts.flags = flags | (fast ? FAST_STATS : 0);
}

// The plain version's arithmetic for one bundle and box.
__device__ __forceinline__ float entry_plain(const float* st,
                                             const float blo[3],
                                             const float bhi[3], float clamp) {
  float t_lo = -INFINITY;
  float t_hi = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float oc[2] = {st[a], st[3 + a]};
    const float ic[2] = {st[6 + a], st[9 + a]};
    const float bb[2] = {blo[a], bhi[a]};
    float lo8 = INFINITY;
    float hi8 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float diff = __fsub_rn(bb[i], oc[j]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float prod = __fmul_rn(diff, ic[m]);
          lo8 = min_prop(lo8, prod);
          hi8 = max_prop(hi8, prod);
        }
      }
    }
    const bool par = (ic[1] >= clamp) || (ic[0] <= -clamp);
    const bool ovl = (oc[1] >= bb[0]) && (oc[0] <= bb[1]);
    const bool wide = par && ovl;
    t_lo = max_prop(t_lo, wide ? -INFINITY : lo8);
    t_hi = min_prop(t_hi, wide ? INFINITY : hi8);
  }
  const float e = max_prop(t_lo, st[12]);
  const float x = min_prop(t_hi, st[13]);
  return (e <= x) ? e : INFINITY;
}

// The same entry with fewer operations, for stats whose o_lo, o_hi, i_lo
// and i_hi are finite with i_lo, i_hi != 0 and whose t_min_lo and
// t_max_hi are not NaN, against a box whose six bounds are finite (bmn,
// bmx: the box's bounds ordered). Returns the entry, or NaN (which this
// arithmetic never gives) where the caller must recompute it with
// entry_plain.
//
// Why it is exact. No product is NaN: a difference of finite numbers is
// finite or +-inf, and i is finite and nonzero. So lo8 and hi8 are the
// min and max of the 8 products as values. x -> RN(x - o) is
// non-decreasing and o -> RN(b - o) non-increasing, so the 4 differences
// lie between dmin = RN(min(blo, bhi) - max(o_lo, o_hi)) and dmax =
// RN(max(blo, bhi) - min(o_lo, o_hi)), both among them; for a fixed i,
// d -> RN(d i) is monotone, so the 8 products' min and max are those of
// the 4 products of {dmin, dmax} x {i_lo, i_hi}. Every value that follows
// (t_lo, t_hi, entry, exit) is then the plain version's as a value, none
// is NaN and the compares agree. A nonzero value has one bit pattern, so
// the bits agree too unless t_lo is zero, whose sign depends on which zero
// each min and max kept: the caller recomputes those entries. (Where t_lo
// < 0 and t_min_lo is +-0, the entry is t_min_lo's own bits in both.)
// wide is the plain version's test on the same operands.
__device__ __forceinline__ float entry_fast(const EntryStats& ts,
                                            const float blo[3],
                                            const float bhi[3],
                                            const float bmn[3],
                                            const float bmx[3]) {
  float t_lo = -INFINITY;
  float t_hi = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dmin = __fsub_rn(bmn[a], ts.omx[a]);
    const float dmax = __fsub_rn(bmx[a], ts.omn[a]);
    const float i_lo = ts.st[6 + a], i_hi = ts.st[9 + a];
    const float p0 = __fmul_rn(dmin, i_lo), p1 = __fmul_rn(dmin, i_hi);
    const float p2 = __fmul_rn(dmax, i_lo), p3 = __fmul_rn(dmax, i_hi);
    const float lo8 = fminf(fminf(p0, p1), fminf(p2, p3));
    const float hi8 = fmaxf(fmaxf(p0, p1), fmaxf(p2, p3));
    const bool wide = ((ts.flags >> a) & 1) && (ts.st[3 + a] >= blo[a]) &&
                      (ts.st[a] <= bhi[a]);
    t_lo = fmaxf(t_lo, wide ? -INFINITY : lo8);
    t_hi = fminf(t_hi, wide ? INFINITY : hi8);
  }
  const float e = fmaxf(t_lo, ts.st[12]);
  const float x = fminf(t_hi, ts.st[13]);
  return t_lo == 0.f ? NAN : ((e <= x) ? e : INFINITY);
}

// A box as the kernels keep it: the bounds, the bounds ordered, and
// whether entry_fast's class holds for it.
struct EntryBox {
  float blo[3], bhi[3], bmn[3], bmx[3];
  bool fast;
};

__device__ __forceinline__ EntryBox make_box(const float blo[3],
                                             const float bhi[3]) {
  EntryBox b;
  b.fast = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.blo[a] = blo[a];
    b.bhi[a] = bhi[a];
    b.bmn[a] = fminf(blo[a], bhi[a]);
    b.bmx[a] = fmaxf(blo[a], bhi[a]);
    b.fast = b.fast && is_finite(blo[a]) && is_finite(bhi[a]);
  }
  return b;
}

// The entry of a bundle into a box, bit for bit interval_entry's.
// entry_fast runs on every pair, in its class or not (it cannot trap), so
// that the common path has no branch.
__device__ __forceinline__ float entry_of(const EntryStats& ts,
                                          const EntryBox& b, float clamp) {
  float e = entry_fast(ts, b.blo, b.bhi, b.bmn, b.bmx);
  if (!(b.fast & ((ts.flags & FAST_STATS) != 0))) e = NAN;
  if (isnan(e)) e = entry_plain(ts.st, b.blo, b.bhi, clamp);
  return e;
}

}  // namespace raycore
