// Correctly rounded division by a small constant, shared by the
// reprojection kernels (csrc/reprojection.cu) and the card test that checks
// it (tests/div_by_check.cu).
#pragma once

#include <cuda_runtime.h>

// x / D, correctly rounded: the product with RN(1/D) is within one ulp of
// the quotient, its residual x - Dq is exact in one FMA, and one more FMA
// rounds q + residual / D correctly (Markstein's theorem; for D = 9 and 3
// tests/test_torch_port_cuda.py checks all 2^32 bit patterns against the
// IEEE division on the card). Three instructions instead of the ten of a
// division's range-checked path.
template <int D>
__device__ __forceinline__ float div_by(float x) {
  constexpr float r = 1.0f / D;
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, (float)D, x), r, q);
}
