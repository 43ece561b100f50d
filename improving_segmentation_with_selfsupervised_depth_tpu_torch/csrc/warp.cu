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
// so the backward pass of the photometric warp is elementwise.
//
// Design. The TPU kernel packs bf16 pixel pairs and scans candidate rows with
// lane shuffles because the TPU has no gather. Hopper gathers through L1/L2,
// so here one thread owns one output pixel of one grid: it reads its (ix, iy),
// picks the four corners and loops over the channels. Pixel values stay f32.
// Neighbouring threads read neighbouring coordinates and write neighbouring
// outputs, so every coordinate load and every output store is coalesced; the
// four corner loads of a warp hit a few cache lines of the source plane.
//
// Bound. Bytes: per output pixel it reads 8 bytes of coordinates and 4*C
// corner values (mostly from cache) and writes 3*C f32 values (out, dfx, dfy).
// At the main-path shape (32 grids of 512x512, C=3) that is ~300 MB of stores
// against ~70 MB of loads, so the stores set the floor; the design keeps them
// fully coalesced and adds no other traffic.
//
// Arithmetic follows the f32 reference operation by operation (the build turns
// off FMA contraction) so kernel and plain version pick identical corners and
// agree to rounding.

#include <cuda_runtime.h>

namespace {

__global__ void warp_bilinear_nchw_kernel(
    const float* __restrict__ img, const float* __restrict__ ix_in,
    const float* __restrict__ iy_in, float* __restrict__ out,
    float* __restrict__ dfx, float* __restrict__ dfy, int c, int h, int w,
    int reps, int hg, int wg, long long total) {
  long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long plane_out = (long long)hg * wg;
  const long long g = idx / plane_out;      // grid index in [0, n * reps)
  const long long pix = idx - g * plane_out;  // pixel in the output plane

  // Border semantics: the fractional weights come from the coordinate clipped
  // to [-1, W] x [-1, H]; the corner indices are clamped to the image.
  // fmaxf first also maps a NaN coordinate to -1.
  float ix = fminf(fmaxf(ix_in[idx], -1.0f), (float)w);
  float iy = fminf(fmaxf(iy_in[idx], -1.0f), (float)h);
  float x0 = floorf(ix);
  float y0 = floorf(iy);
  float fx = ix - x0;
  float fy = iy - y0;
  int x0c = (int)fminf(fmaxf(x0, 0.0f), (float)(w - 1));
  int x1c = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)(w - 1));
  int y0c = (int)fminf(fmaxf(y0, 0.0f), (float)(h - 1));
  int y1c = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)(h - 1));

  float w00 = (1.0f - fx) * (1.0f - fy);
  float w01 = fx * (1.0f - fy);
  float w10 = (1.0f - fx) * fy;
  float w11 = fx * fy;
  const int o00 = y0c * w + x0c, o01 = y0c * w + x1c;
  const int o10 = y1c * w + x0c, o11 = y1c * w + x1c;

  const long long plane_in = (long long)h * w;
  const float* src = img + (g / reps) * c * plane_in;
  long long dst = g * c * plane_out + pix;
  for (int ci = 0; ci < c; ++ci) {
    float g00 = __ldg(src + o00), g01 = __ldg(src + o01);
    float g10 = __ldg(src + o10), g11 = __ldg(src + o11);
    out[dst] = w00 * g00 + w01 * g01 + w10 * g10 + w11 * g11;
    dfx[dst] = (g01 - g00) * (1.0f - fy) + (g11 - g10) * fy;
    dfy[dst] = (g10 - g00) * (1.0f - fx) + (g11 - g01) * fx;
    src += plane_in;
    dst += plane_out;
  }
}

}  // namespace

// img (n, c, h, w); ix, iy (n * reps, hg, wg) in pixel units;
// out, dfx, dfy (n * reps, c, hg, wg). Grid g samples image g / reps.
// Returns the cudaError_t of the launch.
extern "C" int warp_bilinear_nchw_f32(const float* img, const float* ix,
                                      const float* iy, float* out, float* dfx,
                                      float* dfy, int n, int c, int h, int w,
                                      int reps, int hg, int wg, void* stream) {
  long long total = (long long)n * reps * hg * wg;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  warp_bilinear_nchw_kernel<<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      img, ix, iy, out, dfx, dfy, c, h, w, reps, hg, wg, total);
  return (int)cudaGetLastError();
}
