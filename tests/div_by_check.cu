// Test-only check of `div_by` (the port's csrc/div_by.cuh): the kernels'
// divisions by 9 and 3 against the IEEE division on every float. Built and
// run by tests/test_torch_port_cuda.py on the card.

#include <cuda_runtime.h>

#include "div_by.cuh"

namespace {

// Counts the finite floats x (all 2^32 bit patterns) whose div_by<9>(x) or
// div_by<3>(x) is not the IEEE quotient (+0 and -0 count as equal).
__global__ void division_check_kernel(unsigned long long* count) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  unsigned n = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float((unsigned)i);
    const float want9 = __fdiv_rn(x, 9.0f), got9 = div_by<9>(x);
    const float want3 = __fdiv_rn(x, 3.0f), got3 = div_by<3>(x);
    n += isfinite(x) && __float_as_uint(want9) != __float_as_uint(got9) && want9 != got9;
    n += isfinite(x) && __float_as_uint(want3) != __float_as_uint(got3) && want3 != got3;
  }
  if (n) atomicAdd(count, (unsigned long long)n);
}

}  // namespace

// Adds to *count (device memory, zeroed by the caller) the number of finite
// floats on which the division by 9, and then by 3, differs from the IEEE
// division. Returns the cudaError_t of the launch.
extern "C" int division_mismatches(unsigned long long* count, void* stream) {
  division_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(count);
  return (int)cudaGetLastError();
}
