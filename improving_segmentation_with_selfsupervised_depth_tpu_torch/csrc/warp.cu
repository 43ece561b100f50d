// Multi-grid bilinear warp with its grid-gradient planes (K1).
//
// Replaces the Pallas TPU kernel
//   improving_segmentation_with_selfsupervised_depth_tpu/ops/pallas/warp.py
//   ::bilinear_warp_corners_nchw
// and computes what its f32 reference computes
// (ops/resample.py::_pack_fallback_coeffs): torch grid_sample with bilinear
// interpolation, border padding and align_corners=True, plus
//   dfx = d out / d ix = (g01 - g00) (1 - fy) + (g11 - g10) fy
//   dfy = d out / d iy = (g10 - g00) (1 - fx) + (g11 - g01) fx
// so the backward pass of the photometric warp is elementwise. It takes the
// grids as the photometric loss makes them, (x, y) pairs in [-1, 1], and
// unnormalizes them in registers: ix = (gx + 1) * 0.5 * (W - 1), the same f32
// operations in the same order as the plain version's `unnormalize_grid`.
//
// Bound. Per output pixel it reads 8 bytes of grid and writes 3*C f32 values
// (out, dfx, dfy); the source image is read once from memory and re-read by
// the gathers from L2. At the main-path shape (2 images 3x512x512, 4 grids
// each: 8 grids of 512x512) that is 6.3 MB of image, 16.8 MB of grid and
// 75.5 MB of stores, 98.6 MB in all: 0.0294 ms at 3.35 TB/s. The stores set
// the floor.
//
// Design. The TPU kernel packs bf16 pixel pairs and scans candidate rows with
// lane shuffles because the TPU has no gather. Hopper gathers through L1/L2,
// so here a thread owns 2 consecutive output pixels of one grid plane (pixel
// order within a plane does not matter: each pixel needs only its own
// coordinates). The launch is two-dimensional: blocks of a plane on x, the
// grid index on y, looping by gridDim.y over any number of grids, so no
// thread divides a 64-bit index. Where a plane's pixel count is even and the
// grid (16 bytes) and outputs (8 bytes) are aligned, a thread reads its 2
// coordinate pairs as one float4 and writes each (plane, channel) as one
// float2; otherwise the same kernel reads and writes its pixels one by one
// (a plane of 37x61, a grid view with a storage offset). The grid is read
// with a streaming (evict-first) hint and out, dfx, dfy are written with
// streaming stores (st.global.cs), so the 75 MB of outputs do not evict the
// source image that the gathers re-read from the 50 MB L2.
//
// Gathers. A 3-channel image (the photometric loss's RGB frames) is first
// written once as channel-interleaved float4 (r, g, b, 0) by a second launch
// (interleave_rgb_kernel): a corner is then one 16-byte load, 4 per pixel,
// two x-adjacent corners in one 32-byte sector, for 8.4 MB more traffic per 2
// images of 512x512. Per-plane scalar gathers (12 loads per pixel at C = 3)
// were slower on the H100 on both per-pixel random and smooth grids (PERF.md);
// they remain only for other channel counts.
//
// Arithmetic follows the f32 reference operation by operation (the build turns
// off FMA contraction) so kernel and plain version pick identical corners and
// agree to the bit. A NaN coordinate maps to -1 (fmaxf first); the plain
// version maps NaN to -1 before its clamp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kPix = 2;  // consecutive output pixels per thread

// One output pixel's corners (offsets into an image plane) and fractions.
struct Corners {
  int o00, o01, o10, o11;
  float fx, fy;
};

__device__ __forceinline__ Corners corners(float gx, float gy, int h, int w) {
  // unnormalize_grid: (g + 1.0) * 0.5 * (size - 1), in this order
  float ix = (gx + 1.0f) * 0.5f * (float)(w - 1);
  float iy = (gy + 1.0f) * 0.5f * (float)(h - 1);
  // Border semantics: the fractional weights come from the coordinate clipped
  // to [-1, W] x [-1, H]; the corner indices are clamped to the image.
  ix = fminf(fmaxf(ix, -1.0f), (float)w);
  iy = fminf(fmaxf(iy, -1.0f), (float)h);
  float x0 = floorf(ix);
  float y0 = floorf(iy);
  Corners k;
  k.fx = ix - x0;
  k.fy = iy - y0;
  int x0c = (int)fminf(fmaxf(x0, 0.0f), (float)(w - 1));
  int x1c = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)(w - 1));
  int y0c = (int)fminf(fmaxf(y0, 0.0f), (float)(h - 1));
  int y1c = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)(h - 1));
  k.o00 = y0c * w + x0c;
  k.o01 = y0c * w + x1c;
  k.o10 = y1c * w + x0c;
  k.o11 = y1c * w + x1c;
  return k;
}

// out, dfx, dfy of one channel at one pixel, in the plain version's order.
__device__ __forceinline__ void sample(const Corners& k, float g00, float g01, float g10,
                                       float g11, float& out, float& dfx, float& dfy) {
  float w00 = (1.0f - k.fx) * (1.0f - k.fy);
  float w01 = k.fx * (1.0f - k.fy);
  float w10 = (1.0f - k.fx) * k.fy;
  float w11 = k.fx * k.fy;
  out = w00 * g00 + w01 * g01 + w10 * g10 + w11 * g11;
  dfx = (g01 - g00) * (1.0f - k.fy) + (g11 - g10) * k.fy;
  dfy = (g10 - g00) * (1.0f - k.fx) + (g11 - g01) * k.fx;
}

__device__ __forceinline__ float channel(const float4& v, int ci) {
  return ci == 0 ? v.x : (ci == 1 ? v.y : v.z);
}

// img (n, 3, h, w) -> img4 (n, h, w) float4 (r, g, b, 0): pixels on x, the
// image on y (looping by gridDim.y).
__global__ void __launch_bounds__(kThreads) interleave_rgb_kernel(
    const float* __restrict__ img, float4* __restrict__ img4, int n, int plane_in) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= plane_in) return;
  for (int b = blockIdx.y; b < n; b += gridDim.y) {
    const float* src = img + (long long)b * 3 * plane_in + p;
    img4[(long long)b * plane_in + p] =
        make_float4(__ldcs(src), __ldcs(src + plane_in), __ldcs(src + 2 * plane_in), 0.0f);
  }
}

template <bool kVec>
__device__ __forceinline__ void store(float* p, const float (&v)[kPix], int valid) {
  if (kVec) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      if (i < valid) __stcs(p + i, v[i]);
  }
}

// kVec: a 16-byte grid load and 8-byte stores (planes of an even pixel
// count, aligned pointers). kRgb: 3 channels, gathered from the float4 image;
// else `c` channels, gathered from the channel planes.
template <bool kVec, bool kRgb>
__global__ void __launch_bounds__(kThreads) warp_bilinear_nchw_kernel(
    const float* __restrict__ img, const float4* __restrict__ img4,
    const float* __restrict__ grid, float* __restrict__ out, float* __restrict__ dfx,
    float* __restrict__ dfy, int c, int h, int w, int reps, int m, int plane) {
  const int p0 = (blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= plane) return;
  const int valid = min(kPix, plane - p0);
  const long long plane_in = (long long)h * w;
  for (int g = blockIdx.y; g < m; g += gridDim.y) {
    const float* gp = grid + ((long long)g * plane + p0) * 2;
    float gx[kPix], gy[kPix];
    if (kVec) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(gp));
      gx[0] = a.x;
      gy[0] = a.y;
      gx[1] = a.z;
      gy[1] = a.w;
    } else {
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        gx[i] = i < valid ? __ldcs(gp + 2 * i) : 0.0f;
        gy[i] = i < valid ? __ldcs(gp + 2 * i + 1) : 0.0f;
      }
    }
    Corners k[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) k[i] = corners(gx[i], gy[i], h, w);

    const long long image = g / reps;
    float* o = out + (long long)g * c * plane + p0;
    float* dx = dfx + (long long)g * c * plane + p0;
    float* dy = dfy + (long long)g * c * plane + p0;
    if (kRgb) {
      const float4* src = img4 + image * plane_in;
      float4 v00[kPix], v01[kPix], v10[kPix], v11[kPix];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        v00[i] = __ldg(src + k[i].o00);
        v01[i] = __ldg(src + k[i].o01);
        v10[i] = __ldg(src + k[i].o10);
        v11[i] = __ldg(src + k[i].o11);
      }
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        float vo[kPix], vx[kPix], vy[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          sample(k[i], channel(v00[i], ci), channel(v01[i], ci), channel(v10[i], ci),
                 channel(v11[i], ci), vo[i], vx[i], vy[i]);
        store<kVec>(o, vo, valid);
        store<kVec>(dx, vx, valid);
        store<kVec>(dy, vy, valid);
        o += plane;
        dx += plane;
        dy += plane;
      }
    } else {
      const float* src = img + image * c * plane_in;
      for (int ci = 0; ci < c; ++ci) {
        float vo[kPix], vx[kPix], vy[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          sample(k[i], __ldg(src + k[i].o00), __ldg(src + k[i].o01), __ldg(src + k[i].o10),
                 __ldg(src + k[i].o11), vo[i], vx[i], vy[i]);
        store<kVec>(o, vo, valid);
        store<kVec>(dx, vx, valid);
        store<kVec>(dy, vy, valid);
        src += plane_in;
        o += plane;
        dx += plane;
        dy += plane;
      }
    }
  }
}

template <bool kVec>
void launch(dim3 blocks, cudaStream_t stream, const float* img, const float4* img4,
            const float* grid, float* out, float* dfx, float* dfy, int c, int h, int w,
            int reps, int m, int plane) {
  if (c == 3)
    warp_bilinear_nchw_kernel<kVec, true><<<blocks, kThreads, 0, stream>>>(
        img, img4, grid, out, dfx, dfy, c, h, w, reps, m, plane);
  else
    warp_bilinear_nchw_kernel<kVec, false><<<blocks, kThreads, 0, stream>>>(
        img, img4, grid, out, dfx, dfy, c, h, w, reps, m, plane);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// img (n, c, h, w); grid (n * reps, hg, wg, 2), (x, y) in [-1, 1];
// out, dfx, dfy (n * reps, c, hg, wg). Grid g samples image g / reps. For
// c == 3, `img4` is scratch of n * h * w float4 (16-byte aligned) that the
// image is interleaved into and gathered from; for any other c it is not
// read and may be NULL. Needs h, w >= 1 and n * reps, hg * wg and h * w
// below 2^31. Returns the cudaError_t of the launches.
extern "C" int warp_bilinear_nchw_f32(const float* img, const float* grid, float* img4,
                                      float* out, float* dfx, float* dfy, int n, int c,
                                      int h, int w, int reps, int hg, int wg,
                                      void* stream) {
  const int m = n * reps;
  const int plane = hg * wg;
  if (m == 0 || plane == 0 || c == 0) return 0;
  if (h <= 0 || w <= 0 || (c == 3 && (img4 == nullptr || !aligned(img4, 16))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (c == 3) {
    const int plane_in = h * w;
    dim3 blocks((plane_in + kThreads - 1) / kThreads, n < kMaxGridY ? n : kMaxGridY);
    interleave_rgb_kernel<<<blocks, kThreads, 0, s>>>(img, reinterpret_cast<float4*>(img4),
                                                       n, plane_in);
  }
  const int per_block = kThreads * kPix;
  dim3 blocks((plane + per_block - 1) / per_block, m < kMaxGridY ? m : kMaxGridY);
  const bool vec = plane % kPix == 0 && aligned(grid, 16) && aligned(out, 8) &&
                   aligned(dfx, 8) && aligned(dfy, 8);
  const float4* img4c = reinterpret_cast<const float4*>(img4);
  if (vec)
    launch<true>(blocks, s, img, img4c, grid, out, dfx, dfy, c, h, w, reps, m, plane);
  else
    launch<false>(blocks, s, img, img4c, grid, out, dfx, dfy, c, h, w, reps, m, plane);
  return (int)cudaGetLastError();
}
