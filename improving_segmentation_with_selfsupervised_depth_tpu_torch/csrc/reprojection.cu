// Fused SSIM + L1 reprojection error, forward (K2).
//
// Replaces the Pallas TPU kernel
//   improving_segmentation_with_selfsupervised_depth_tpu/ops/pallas/reprojection.py
//   ::fused_reprojection_error
// Per pixel (n, y, x) it computes
//   0.85 * mean_c clip((1 - SSIM_c) / 2, 0, 1) + 0.15 * mean_c |target - pred|
// where SSIM_c uses 3x3 mean windows over reflect-padded inputs with
// C1 = 0.01^2 and C2 = 0.03^2 (passed in by the caller).
//
// Design. One thread per output pixel, looping over the channels and the 3x3
// window. Reflect indexing (-1 -> 1, H -> H-2) happens in the kernel, so no
// padded copy of either input exists in memory. The TPU kernel's row bands and
// DMA staging only serve its scratch memory; here the nine overlapping window
// reads of neighbouring threads are served by L1.
//
// Bound. Bytes: each input value is read from device memory about once (the
// window overlap is cached), 2*C floats in and one float out per pixel, and
// ~60 flops per pixel and channel, far below the card's compute rate.
//
// The window sums run in the same order as the plain version's avg_pool2d
// (row-major over the window, starting from zero) and the build turns off FMA
// contraction: the variance terms E[x^2] - mu^2 cancel in flat regions, where
// a last-bit difference would otherwise be amplified by 1/C2.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__global__ void reprojection_error_kernel(const float* __restrict__ pred,
                                          const float* __restrict__ target,
                                          float* __restrict__ out, int c, int h,
                                          int w, float c1, float c2,
                                          long long total) {
  long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)h * w;
  const long long ni = idx / plane;
  const int pix = (int)(idx - ni * plane);
  const int y = pix / w;
  const int x = pix - y * w;

  int rows[3], cols[3];
  for (int d = 0; d < 3; ++d) {
    rows[d] = reflect(y + d - 1, h) * w;
    cols[d] = reflect(x + d - 1, w);
  }

  float ssim_sum = 0.0f;
  float l1_sum = 0.0f;
  const float* xp = pred + ni * c * plane;
  const float* yp = target + ni * c * plane;
  for (int ci = 0; ci < c; ++ci) {
    float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int o = rows[dy] + cols[dx];
        const float a = __ldg(xp + o);
        const float b = __ldg(yp + o);
        sx += a;
        sy += b;
        sxx += a * a;
        syy += b * b;
        sxy += a * b;
      }
    }
    const float mu_x = sx / 9.0f;
    const float mu_y = sy / 9.0f;
    const float sigma_x = sxx / 9.0f - mu_x * mu_x;
    const float sigma_y = syy / 9.0f - mu_y * mu_y;
    const float sigma_xy = sxy / 9.0f - mu_x * mu_y;
    const float ssim_n = (2.0f * mu_x * mu_y + c1) * (2.0f * sigma_xy + c2);
    const float ssim_d =
        (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2);
    const float s = (1.0f - ssim_n / ssim_d) * 0.5f;
    ssim_sum += fminf(fmaxf(s, 0.0f), 1.0f);
    l1_sum += fabsf(__ldg(yp + pix) - __ldg(xp + pix));
    xp += plane;
    yp += plane;
  }
  out[idx] = 0.85f * (ssim_sum / (float)c) + 0.15f * (l1_sum / (float)c);
}

}  // namespace

// pred, target (n, c, h, w); out (n, 1, h, w). Needs h >= 2 and w >= 2.
// Returns the cudaError_t of the launch.
extern "C" int reprojection_error_f32(const float* pred, const float* target,
                                      float* out, int n, int c, int h, int w,
                                      float c1, float c2, void* stream) {
  long long total = (long long)n * h * w;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  reprojection_error_kernel<<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(pred, target, out, c, h,
                                                      w, c1, c2, total);
  return (int)cudaGetLastError();
}
