// Fused SSIM + L1 reprojection error: forward (K2) and its gradient (K3).
//
// K2 replaces the Pallas TPU kernel
//   improving_segmentation_with_selfsupervised_depth_tpu/ops/pallas/reprojection.py
//   ::fused_reprojection_error
// K3 replaces, in the same file, ::fused_reprojection_error_grad (kernel
// _reproj_bwd_kernel and the reflect fold and L1 term after it).
//
// Per pixel (m, y, x) K2 computes
//   e = 0.85 * mean_c clip((1 - SSIM_c) / 2, 0, 1) + 0.15 * mean_c |target - pred|
// where SSIM_c uses 3x3 mean windows over reflect-padded inputs with
// C1 = 0.01^2 and C2 = 0.03^2 (passed in by the caller). K3 computes
// d/d(pred) of sum(g * e) for an upstream gradient g (one plane per image).
//
// Both take `reps` pred images per target image: pred image m is compared
// with target image m / reps. The photometric loss warps one source frame at
// all its scales in one K1 launch, so the S scale predictions of a frame are
// one contiguous (N*S, C, H, W) tensor against the (N, C, H, W) target, and
// one launch of each kernel covers all scales.
//
// Numerics. The window sums run in the plain versions' order (row-major
// over the window, from zero) and the build turns off FMA contraction
// (-fmad=false): the variance terms E[x^2] - mu^2 cancel in flat regions,
// where a last-bit difference is amplified by 1/C2 (forward) or 1/C2^2
// (gradient). K3's subgradients are JAX's: the clip's is 1 strictly inside,
// 0.5 at an exact bound (identical windows give SSIM == 1 exactly) and 0
// outside; |u| has slope +1 at u == 0.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// ---------------------------------------------------------------------------
// K2. One thread per output pixel, looping over the channels and the 3x3
// window. Reflect indexing (-1 -> 1, H -> H-2) happens in the kernel, so no
// padded copy of either input exists in memory. The TPU kernel's row bands
// and DMA staging only serve its scratch memory; here the nine overlapping
// window reads of neighbouring threads are served by L1.
// Bound: bytes. Each input value is read from device memory about once (the
// window overlap is cached), 2*C floats in and one float out per pixel, and
// ~60 flops per pixel and channel, far below the card's compute rate.
// ---------------------------------------------------------------------------
__global__ void reprojection_error_kernel(const float* __restrict__ pred,
                                          const float* __restrict__ target,
                                          float* __restrict__ out, int c, int h,
                                          int w, int reps, float c1, float c2,
                                          long long total) {
  long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)h * w;
  const long long mi = idx / plane;
  const int pix = (int)(idx - mi * plane);
  const int y = pix / w;
  const int x = pix - y * w;

  int rows[3], cols[3];
  for (int d = 0; d < 3; ++d) {
    rows[d] = reflect(y + d - 1, h) * w;
    cols[d] = reflect(x + d - 1, w);
  }

  float ssim_sum = 0.0f;
  float l1_sum = 0.0f;
  const float* xp = pred + mi * c * plane;
  const float* yp = target + (mi / reps) * c * plane;
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

// ---------------------------------------------------------------------------
// K3. With window statistics ux, uy, vx, vy, vxy at a center and
// A1 = 2 ux uy + C1, A2 = 2 vxy + C2, B1 = ux^2 + uy^2 + C1, B2 = vx + vy + C2,
// S = A1 A2 / (B1 B2), each center carries five coefficient planes
//   P1 = E * 2 A2 (uy B1 - ux A1) / (B1^2 B2),  P2 = E * (-A1 A2 / (B1 B2^2)),
//   P3 = E * 2 A1 / (B1 B2),  P2u = P2 ux,  P3u = P3 uy,
// with E = g * (-0.85 / (2C)) * clip'. On the reflect-padded grid, position P
// gets dxp(P) = (1/9) sum over the 3x3 centers whose window holds P of
// [P1 + 2 x_P P2 - 2 P2u + y_P P3 - P3u]. The pad's gradient then folds onto
// its sources: padded row 0 onto image row 1, padded row H+1 onto H-2, and
// the same for columns (columns first, as the TPU code does). So an output at
// row 1 (or H-2, column 1, W-2) also sums the centers of a second padded
// position; rows 0 and H-1 receive no fold.
//
// Design. One block per (TH x TW) output tile of one channel plane. It stages
// the (TH+4) x (TW+4) window of padded pred and target in shared memory,
// computes the five coefficient planes for the (TH+2) x (TW+2) centers around
// the tile into shared memory, and each thread then sums the 3x3 centers of
// its padded position(s). Centers outside the image carry zero.
// Bound: bytes, barely. pred and dpred move 4 B per value, target 4 B per
// value once for its `reps` preds, g 4 B per pixel; ~185 f32 operations per
// value (the coefficients of 1.3 centers, the five box sums, fold and L1
// term), so at the card's f32 rate the operations take ~90% of the time the
// bytes do. Staging pred, target and the coefficient planes in shared
// memory keeps the window reads and the center overlap off device memory.
// ---------------------------------------------------------------------------
constexpr int TW = 32;
constexpr int TH = 8;
constexpr int SW = TW + 4;  // staged padded-grid columns [x0 - 1, x0 + TW + 3)
constexpr int SH = TH + 4;  // staged padded-grid rows    [y0 - 1, y0 + TH + 3)
constexpr int CW = TW + 2;  // centers, image columns [x0 - 1, x0 + TW + 1)
constexpr int CH = TH + 2;  // centers, image rows    [y0 - 1, y0 + TH + 1)

__global__ void __launch_bounds__(TW * TH)
reprojection_error_grad_kernel(const float* __restrict__ pred,
                               const float* __restrict__ target,
                               const float* __restrict__ g,
                               float* __restrict__ dpred, int c, int h, int w,
                               int reps, float c1, float c2, float kssim,
                               float kl1) {
  __shared__ float xs[SH][SW];
  __shared__ float ys[SH][SW];
  __shared__ float p1[CH][CW];
  __shared__ float p2[CH][CW];
  __shared__ float p2u[CH][CW];
  __shared__ float p3[CH][CW];
  __shared__ float p3u[CH][CW];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int plane = blockIdx.z;  // m * c + ci
  const int m = plane / c;
  const int ci = plane - m * c;
  const long long hw = (long long)h * w;
  const float* xp = pred + (long long)plane * hw;
  const float* yp = target + ((long long)(m / reps) * c + ci) * hw;
  const float* gp = g + (long long)m * hw;
  const int tid = threadIdx.y * TW + threadIdx.x;

  // 1. pred and target on the padded grid; outside it, zeros (read only by
  //    centers outside the image, whose coefficients are zero)
  for (int k = tid; k < SH * SW; k += TW * TH) {
    const int i = k / SW;
    const int j = k - i * SW;
    const int pr = y0 - 1 + i;
    const int pc = x0 - 1 + j;
    float a = 0.0f, b = 0.0f;
    if (pr >= 0 && pr < h + 2 && pc >= 0 && pc < w + 2) {
      const long long o = (long long)reflect(pr - 1, h) * w + reflect(pc - 1, w);
      a = __ldg(xp + o);
      b = __ldg(yp + o);
    }
    xs[i][j] = a;
    ys[i][j] = b;
  }
  __syncthreads();

  // 2. coefficient planes of the centers; center (i, j) has its window at
  //    staged rows i..i+2 and columns j..j+2
  for (int k = tid; k < CH * CW; k += TW * TH) {
    const int i = k / CW;
    const int j = k - i * CW;
    const int cr = y0 - 1 + i;
    const int cc = x0 - 1 + j;
    float q1 = 0.0f, q2 = 0.0f, q2u = 0.0f, q3 = 0.0f, q3u = 0.0f;
    if (cr >= 0 && cr < h && cc >= 0 && cc < w) {
      float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) {
          const float a = xs[i + dy][j + dx];
          const float b = ys[i + dy][j + dx];
          sx += a;
          sy += b;
          sxx += a * a;
          syy += b * b;
          sxy += a * b;
        }
      }
      const float mu_x = sx / 9.0f;
      const float mu_y = sy / 9.0f;
      const float vx = sxx / 9.0f - mu_x * mu_x;
      const float vy = syy / 9.0f - mu_y * mu_y;
      const float vxy = sxy / 9.0f - mu_x * mu_y;
      const float a1 = 2.0f * mu_x * mu_y + c1;
      const float a2 = 2.0f * vxy + c2;
      const float b1 = mu_x * mu_x + mu_y * mu_y + c1;
      const float b2 = vx + vy + c2;
      const float s = (a1 * a2) / (b1 * b2);
      const float inner = (1.0f - s) * 0.5f;
      const float live = (inner > 0.0f && inner < 1.0f)
                             ? 1.0f
                             : ((inner == 0.0f || inner == 1.0f) ? 0.5f : 0.0f);
      const float e = __ldg(gp + (long long)cr * w + cc) * kssim * live;
      q1 = e * (2.0f * a2 * (mu_y * b1 - mu_x * a1) / (b1 * b1 * b2));
      q2 = e * (-(a1 * a2) / (b1 * b2 * b2));
      q3 = e * (2.0f * a1 / (b1 * b2));
      q2u = q2 * mu_x;
      q3u = q3 * mu_y;
    }
    p1[i][j] = q1;
    p2[i][j] = q2;
    p2u[i][j] = q2u;
    p3[i][j] = q3;
    p3u[i][j] = q3u;
  }
  __syncthreads();

  const int qx = x0 + threadIdx.x;
  const int qy = y0 + threadIdx.y;
  if (qx >= w || qy >= h) return;

  // gradient at padded position (pr, pc): its centers are image rows
  // pr-2..pr and columns pc-2..pc; those not staged lie outside the image
  auto dxp = [&](int pr, int pc) -> float {
    float b1s = 0.0f, b2s = 0.0f, b2us = 0.0f, b3s = 0.0f, b3us = 0.0f;
    for (int dy = 0; dy < 3; ++dy) {
      const int i = pr - 1 - y0 + dy;
      if (i < 0 || i >= CH) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int j = pc - 1 - x0 + dx;
        if (j < 0 || j >= CW) continue;
        b1s += p1[i][j];
        b2s += p2[i][j];
        b2us += p2u[i][j];
        b3s += p3[i][j];
        b3us += p3u[i][j];
      }
    }
    const float xv = xs[pr - y0 + 1][pc - x0 + 1];
    const float yv = ys[pr - y0 + 1][pc - x0 + 1];
    return (b1s + 2.0f * xv * b2s - 2.0f * b2us + yv * b3s - b3us) / 9.0f;
  };
  const int pr = qy + 1;
  const int pc = qx + 1;
  auto col_folded = [&](int r) -> float {
    float v = dxp(r, pc);
    if (pc == 2) v += dxp(r, 0);
    if (pc == w - 1) v += dxp(r, w + 1);
    return v;
  };
  float out = col_folded(pr);
  if (pr == 2) out += col_folded(0);
  if (pr == h - 1) out += col_folded(h + 1);

  const long long o = (long long)qy * w + qx;
  const float u = __ldg(yp + o) - __ldg(xp + o);
  out += __ldg(gp + o) * kl1 * (u >= 0.0f ? -1.0f : 1.0f);
  dpred[(long long)plane * hw + o] = out;
}

}  // namespace

// pred (m, c, h, w), target (m / reps, c, h, w); out (m, 1, h, w).
// Needs h >= 2 and w >= 2. Returns the cudaError_t of the launch.
extern "C" int reprojection_error_f32(const float* pred, const float* target,
                                      float* out, int m, int c, int h, int w,
                                      int reps, float c1, float c2,
                                      void* stream) {
  long long total = (long long)m * h * w;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  reprojection_error_kernel<<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(pred, target, out, c, h,
                                                      w, reps, c1, c2, total);
  return (int)cudaGetLastError();
}

// pred (m, c, h, w), target (m / reps, c, h, w), g (m, 1, h, w);
// dpred (m, c, h, w). kssim = -0.85 / (2c), kl1 = 0.15 / c. Needs h >= 2,
// w >= 2 and m * c <= 65535. Returns the cudaError_t of the launch.
extern "C" int reprojection_error_grad_f32(const float* pred, const float* target,
                                           const float* g, float* dpred, int m,
                                           int c, int h, int w, int reps,
                                           float c1, float c2, float kssim,
                                           float kl1, void* stream) {
  if ((long long)m * c * h * w == 0) return 0;
  dim3 block(TW, TH);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, m * c);
  reprojection_error_grad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pred, target, g, dpred, c, h, w, reps, c1, c2, kssim, kl1);
  return (int)cudaGetLastError();
}
