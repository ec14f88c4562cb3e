// The fused products of the instanced frame's affine arithmetic, shared by
// the refresh and the local rays of K8 (instance_affine.cu).
//
// Each is written with explicitly rounded intrinsics, so that nvcc's
// default contraction (-fmad=true) cannot fuse or split an operation: a
// product and a sum that the plain version rounds apart stay apart, and a
// fused multiply-add is one __fmaf_rn, the card's fmaf.
// core/triangle.py:fma emulates that fmaf on tensors, and core/triangle.py
// dot3 and cross build these same chains from it, so the kernel and the
// plain version agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace raycore {

// core/triangle.py:dot3: fma(a2, b2, fma(a1, b1, a0*b0)).
__device__ __forceinline__ float fdot3(float a0, float a1, float a2, float b0,
                                       float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// core/triangle.py:cross: component k is fma(a_i, b_j, -(a_j*b_i)) for
// (k, i, j) = (0, 1, 2), (1, 2, 0), (2, 0, 1).
__device__ __forceinline__ void fcross(const float a[3], const float b[3],
                                       float c[3]) {
  c[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  c[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  c[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// One row of a row-major 3x4 applied to a point: R_row . p + t_row, the
// dot fused and the translation added apart
// (core/transforms.py:_apply_mat3_fused, then + t).
__device__ __forceinline__ float affine_row(const float* row, const float p[3]) {
  return __fadd_rn(fdot3(row[0], row[1], row[2], p[0], p[1], p[2]), row[3]);
}

// PyTorch's min and max reductions on the card (amin, amax): the
// accumulator a is kept where it is NaN or strictly below (above) b, so of
// two equal values the later one is kept, and a -0 and a +0 keep the
// later.
__device__ __forceinline__ float torch_min_step(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float torch_max_step(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

}  // namespace raycore
