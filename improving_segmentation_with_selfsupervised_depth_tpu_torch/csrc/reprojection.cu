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
// Numerics. Every window sum runs in the plain versions' (and JAX's) order,
// row-major over the window from zero, and the build turns off FMA
// contraction (-fmad=false): the variance terms E[x^2] - mu^2 cancel in flat
// regions, where a last-bit difference is amplified by 1/C2 (forward) or
// 1/C2^2 (gradient). Every multiply and add here is a separately rounded
// torch op in the plain version, so none may contract; the flag touches no
// integer arithmetic. Divisions are true IEEE divisions; the window means
// divide by 9, and K2's channel means by 3, with `div_by` (div_by.cuh),
// which gives the IEEE quotient for every float (checked on the card over all
// 2^32 bit patterns). The kernels reuse loaded values and their products
// (a*a rounds the same wherever it is computed), never partial sums in
// another order. K3's subgradients are
// JAX's: the clip's is 1 strictly inside, 0.5 at an exact bound (identical
// windows give SSIM == 1 exactly) and 0 outside; |u| has slope +1 at u == 0.
//
// Design, common to both kernels. One warp owns a strip of 32 columns and
// TH rows of one image and walks down the rows, one lane per column. Each
// step loads one input row (one coalesced 128-byte load per input, plus one
// halo column at each end of the strip) and takes the horizontal neighbours
// from the adjacent lanes with __shfl_sync, so a value is loaded once per
// strip and the halo costs (TH+2)/TH rows (K2) or (TH+4)/TH (K3). A loaded
// row is the last row of one window, the middle of the next and the first of
// the one after: each lane keeps the running sums of the two windows still
// open and starts a third, so no window row is held in registers and no sum
// is re-associated. Reflect indexing is resolved once per warp for the
// columns and once per row (warp-uniform) for the rows, so interior and edge
// strips run the same instructions; only K3's folds are branches, taken by
// the warps whose strip holds column 1 or W-2 or row 1 or H-2. Warps are
// independent (no __syncthreads). The grid is one-dimensional over (image,
// row tile, strip) tasks, WARPS per block, decoded once per warp with 32-bit
// divisions: no 65,535-plane limit. The channels are a loop inside the warp.
//
// Bounds on the H100 (NVIDIA H100 80GB HBM3, 700.00 W). Both kernels are
// bound by instruction issue, not by bytes. At the exp-212 shape (pred
// 16x3x512x512, 4 preds per target) the bytes take 23.8 us (K2) and 38.8 us
// (K3) at 3.35 TB/s. As built (-fmad=false: a multiply-add issues as two
// instructions; an IEEE division is a reciprocal, five FMAs and a range
// check), one row step of a warp issues ~171 SASS instructions in K2 and
// ~335 in K3, per (pixel, channel) of 32 lanes; with the tiles' halos that is
// 72 us (K2) and 161 us (K3) of issue at 4 warp instructions per clock per
// SM at 1.98 GHz. What the design does about it: one window's statistics, one
// center's coefficients and one 3x3 box sum per output (no recomputed halo
// centers beyond the strip's two edge lanes), products of a loaded value
// computed once, neighbours by shuffle instead of shared-memory round trips,
// a row's loads issued one row step before the shuffles that use them,
// divisions by 9 and 3 in three instructions, 32-bit row offsets, and
// register caps (64 and 80) that keep 32 and 24 warps on each SM. PERF.md
// has the measured times and the SASS counts.

#include <climits>
#include <cuda_runtime.h>

#include "div_by.cuh"

namespace {

constexpr int WARPS = 4;  // warps per block, each an independent strip task
constexpr unsigned FULL = 0xffffffffu;

// reflect index -1 -> 1, n -> n-2 (n + 1 -> n-3), kept inside [0, n); the
// rows and columns further out (-2, and beyond n + 1 in a strip's last
// lanes) get some index inside, their values never reach an output
__device__ __forceinline__ int reflect_clamp(int i, int n) {
  i = abs(i);
  return max(min(i, 2 * n - 2 - i), 0);
}

// one input row as a lane sees it: columns x-1, x, x+1 of pred (a), target (b)
struct Row {
  float al, a, ar, bl, b, br;
};

// A lane's four load addresses at row offset 0: its own column and its
// halo column (the column left of the strip for lane 0, right of it for lane
// 31, its own column again for the others, so the loads need no branch), in
// pred (x) and target (y).
struct Cols {
  const float* x;
  const float* xh;
  const float* y;
  const float* yh;
};

// keeps the compiler from folding a lane's column back into every row's
// address, which it then recomputes in 64 bits
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm("" : "+l"(p));
  return p;
}

__device__ __forceinline__ Cols cols(const float* xp, const float* yp, int col, int hcol) {
  return {opaque(xp + col), opaque(xp + hcol), opaque(yp + col), opaque(yp + hcol)};
}

// one row's four loads at row offset `roff` (unsigned: one wide
// multiply-add per address), issued a row step before the shuffles that use
// them, so the loads are in flight while the previous row is computed
struct RowLoads {
  float a, b, ha, hb;
};

__device__ __forceinline__ RowLoads load_row(const Cols& p, unsigned roff) {
  return {__ldg(p.x + roff), __ldg(p.y + roff), __ldg(p.xh + roff), __ldg(p.yh + roff)};
}

// the (left, own, right) halo-completed row
__device__ __forceinline__ Row complete_row(const RowLoads& l, int lane) {
  const float al = __shfl_up_sync(FULL, l.a, 1);
  const float bl = __shfl_up_sync(FULL, l.b, 1);
  const float ar = __shfl_down_sync(FULL, l.a, 1);
  const float br = __shfl_down_sync(FULL, l.b, 1);
  return {lane == 0 ? l.ha : al, l.a, lane == 31 ? l.ha : ar,
          lane == 0 ? l.hb : bl, l.b, lane == 31 ? l.hb : br};
}

// running 3x3 window sums of x, y, x^2, y^2, xy
struct Stats {
  float sx, sy, sxx, syy, sxy;
};

// the products of one row, computed once and used by three windows
struct RowProducts {
  float aa[3], bb[3], ab[3];
};

__device__ __forceinline__ RowProducts products(const Row& r) {
  RowProducts p;
  p.aa[0] = r.al * r.al;
  p.aa[1] = r.a * r.a;
  p.aa[2] = r.ar * r.ar;
  p.bb[0] = r.bl * r.bl;
  p.bb[1] = r.b * r.b;
  p.bb[2] = r.br * r.br;
  p.ab[0] = r.al * r.bl;
  p.ab[1] = r.a * r.b;
  p.ab[2] = r.ar * r.br;
  return p;
}

// a window's sums after its first row: 0 + v0 + v1 + v2 == (v0 + v1) + v2
__device__ __forceinline__ Stats first_row(const Row& r, const RowProducts& p) {
  Stats s;
  s.sx = (r.al + r.a) + r.ar;
  s.sy = (r.bl + r.b) + r.br;
  s.sxx = (p.aa[0] + p.aa[1]) + p.aa[2];
  s.syy = (p.bb[0] + p.bb[1]) + p.bb[2];
  s.sxy = (p.ab[0] + p.ab[1]) + p.ab[2];
  return s;
}

__device__ __forceinline__ Stats add_row(Stats s, const Row& r, const RowProducts& p) {
  s.sx = ((s.sx + r.al) + r.a) + r.ar;
  s.sy = ((s.sy + r.bl) + r.b) + r.br;
  s.sxx = ((s.sxx + p.aa[0]) + p.aa[1]) + p.aa[2];
  s.syy = ((s.syy + p.bb[0]) + p.bb[1]) + p.bb[2];
  s.sxy = ((s.sxy + p.ab[0]) + p.ab[1]) + p.ab[2];
  return s;
}

// task t -> (image, first row, first column); one 32-bit division pair per warp
__device__ __forceinline__ void decode_task(int t, int nstrip, int ntile_y, int th,
                                            int stride, int& mi, int& y0, int& x0) {
  const int sx = t % nstrip;
  const int rest = t / nstrip;
  const int ty = rest % ntile_y;
  mi = rest / ntile_y;
  y0 = ty * th;
  x0 = sx * stride;
}

// ---------------------------------------------------------------------------
// K2. A warp's strip is 32 output columns x TH rows; lane l owns column
// x0 + l and the halo columns x0 - 1 (lane 0) and x0 + 32 (lane 31). The
// channel loop is outside the row walk; a lane's per-row channel sums of the
// clipped SSIM term and of |u| wait in shared memory (its own column, so no
// bank conflicts and no barrier), in channel order as the plain version adds
// them.
// ---------------------------------------------------------------------------
constexpr int K2_TH = 16;
constexpr int K2_BLOCKS = 8;  // blocks per SM: at most 64 registers

__global__ void __launch_bounds__(WARPS * 32, K2_BLOCKS)
reprojection_error_kernel(const float* __restrict__ pred,
                          const float* __restrict__ target,
                          float* __restrict__ out, int c, int h, int w, int reps,
                          float c1, float c2, int nstrip, int ntile_y, int ntasks) {
  __shared__ float ssim_acc[WARPS][K2_TH][32];
  __shared__ float l1_acc[WARPS][K2_TH][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= ntasks) return;  // whole warps only
  int mi, y0, x0;
  decode_task(t, nstrip, ntile_y, K2_TH, 32, mi, y0, x0);
  const int rows = min(K2_TH, h - y0);
  const int x = x0 + lane;
  const int col = reflect_clamp(x, w);
  const int hcol = lane == 0 ? reflect_clamp(x0 - 1, w)
                             : (lane == 31 ? reflect_clamp(x0 + 32, w) : col);
  const size_t hw = (size_t)h * w;
  const float* xp = pred + (size_t)mi * c * hw;
  const float* yp = target + (size_t)(mi / reps) * c * hw;
  float* op = opaque(out + (size_t)mi * hw + col);  // this lane's column

  for (int ci = 0; ci < c; ++ci, xp += hw, yp += hw) {
    // input rows y0 - 1 .. y0 + rows; window of output y closes at row y + 1
    Stats open2 = {}, open1 = {};  // windows with two rows and with one row
    float a_mid = 0.0f, b_mid = 0.0f;  // pred, target at the previous row
    const Cols p0 = cols(xp, yp, col, hcol);
    RowLoads next = load_row(p0, reflect_clamp(y0 - 1, h) * w);
    for (int k = 0; k <= rows + 1; ++k) {
      const Row r = complete_row(next, lane);
      if (k <= rows)  // prefetch the next row
        next = load_row(p0, reflect_clamp(y0 + k, h) * w);
      const RowProducts p = products(r);
      if (k >= 2) {
        const Stats s = add_row(open2, r, p);
        const float mu_x = div_by<9>(s.sx);
        const float mu_y = div_by<9>(s.sy);
        const float sigma_x = div_by<9>(s.sxx) - mu_x * mu_x;
        const float sigma_y = div_by<9>(s.syy) - mu_y * mu_y;
        const float sigma_xy = div_by<9>(s.sxy) - mu_x * mu_y;
        const float ssim_n = (2.0f * mu_x * mu_y + c1) * (2.0f * sigma_xy + c2);
        const float ssim_d =
            (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2);
        const float sv = fminf(fmaxf((1.0f - ssim_n / ssim_d) * 0.5f, 0.0f), 1.0f);
        const float lv = fabsf(b_mid - a_mid);
        const int i = k - 2;  // output row y0 + i
        float ssim_sum = ci ? ssim_acc[warp][i][lane] : 0.0f;
        float l1_sum = ci ? l1_acc[warp][i][lane] : 0.0f;
        ssim_sum += sv;
        l1_sum += lv;
        if (ci == c - 1) {
          if (x < w)
            op[(unsigned)((y0 + i) * w)] =
                0.85f * (c == 3 ? div_by<3>(ssim_sum) : ssim_sum / (float)c) +
                0.15f * (c == 3 ? div_by<3>(l1_sum) : l1_sum / (float)c);
        } else {
          ssim_acc[warp][i][lane] = ssim_sum;
          l1_acc[warp][i][lane] = l1_sum;
        }
      }
      open2 = add_row(open1, r, p);
      open1 = first_row(r, p);
      a_mid = r.a;
      b_mid = r.b;
    }
  }
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
// position: those are the centers of image row 0 (H-1, column 0, W-1)
// alone, and that position's x_P and y_P are the output's own values.
//
// A warp's strip: lane l owns center column x0 - 1 + l and, for lanes 1..30,
// the output column of the same index, so the strip advances by 30 columns;
// the input halo columns x0 - 2 and x0 + 31 come with lanes 0 and 31. The
// walk goes over input rows y0 - 2 .. y0 + TH + 1: each closes the window of
// one center row, whose five coefficients reach the neighbour lanes by
// shuffle; each center row closes the 3x3 box sums of one output row. The
// box sums run row-major from zero like the windows. Centers outside the
// image carry zero. The folds take the first row of a box sum (row 0), the
// first row of the next output's box sum (row H-1), and, in the warps that
// hold column 1 or W-2, a second running sum down the neighbour's column;
// what they keep between rows waits in shared memory, each lane in its own
// column, so it costs the other warps no registers. g, which all channels
// share, is staged once per strip in shared memory.
// ---------------------------------------------------------------------------
constexpr int K3_TH = 16;
constexpr int K3_BLOCKS = 6;  // blocks per SM: at most 80 registers

struct Coef {
  float p1, p2, p2u, p3, p3u;
};

__device__ __forceinline__ Coef shfl_coef_up(const Coef& q) {
  return {__shfl_up_sync(FULL, q.p1, 1), __shfl_up_sync(FULL, q.p2, 1),
          __shfl_up_sync(FULL, q.p2u, 1), __shfl_up_sync(FULL, q.p3, 1),
          __shfl_up_sync(FULL, q.p3u, 1)};
}

__device__ __forceinline__ Coef shfl_coef_down(const Coef& q) {
  return {__shfl_down_sync(FULL, q.p1, 1), __shfl_down_sync(FULL, q.p2, 1),
          __shfl_down_sync(FULL, q.p2u, 1), __shfl_down_sync(FULL, q.p3, 1),
          __shfl_down_sync(FULL, q.p3u, 1)};
}

__device__ __forceinline__ Coef coef_add(Coef s, const Coef& q) {
  s.p1 += q.p1;
  s.p2 += q.p2;
  s.p2u += q.p2u;
  s.p3 += q.p3;
  s.p3u += q.p3u;
  return s;
}

// a box sum's first row from zero: (l + m) + r
__device__ __forceinline__ Coef coef_row(const Coef& l, const Coef& m, const Coef& r) {
  return coef_add(coef_add(l, m), r);
}

__device__ __forceinline__ Coef coef_add_row(const Coef& s, const Coef& l, const Coef& m,
                                             const Coef& r) {
  return coef_add(coef_add(coef_add(s, l), m), r);
}

// fold_s slots
enum { TOP, TOP_L, TOP_R, VL2, VL1, VR2, VR1, FOLD_SLOTS };

__device__ __forceinline__ void coef_put(float (&s)[5][32], int lane, const Coef& q) {
  s[0][lane] = q.p1;
  s[1][lane] = q.p2;
  s[2][lane] = q.p2u;
  s[3][lane] = q.p3;
  s[4][lane] = q.p3u;
}

__device__ __forceinline__ Coef coef_get(const float (&s)[5][32], int lane) {
  return {s[0][lane], s[1][lane], s[2][lane], s[3][lane], s[4][lane]};
}

__device__ __forceinline__ float dxp(const Coef& b, float xv, float yv) {
  return div_by<9>(b.p1 + 2.0f * xv * b.p2 - 2.0f * b.p2u + yv * b.p3 - b.p3u);
}

__global__ void __launch_bounds__(WARPS * 32, K3_BLOCKS)
reprojection_error_grad_kernel(const float* __restrict__ pred,
                               const float* __restrict__ target,
                               const float* __restrict__ g,
                               float* __restrict__ dpred, int c, int h, int w,
                               int reps, float c1, float c2, float kssim,
                               float kl1, int nstrip, int ntile_y, int ntasks) {
  __shared__ float g_s[WARPS][K3_TH + 2][32];  // g at the strip's center rows
  // the folds' sums, each lane its own column: center row 0 and its
  // neighbours (for output row 1), the neighbour columns' running sums
  __shared__ float fold_s[WARPS][FOLD_SLOTS][5][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= ntasks) return;  // whole warps only
  int mi, y0, x0;
  decode_task(t, nstrip, ntile_y, K3_TH, 30, mi, y0, x0);
  const int rows = min(K3_TH, h - y0);
  const int cc = x0 - 1 + lane;  // center column; output column for lanes 1..30
  const bool col_live = cc >= 0 && cc < w;
  const bool out_lane = lane >= 1 && lane <= 30 && cc < w;
  const int col = reflect_clamp(cc, w);
  const int hcol = lane == 0 ? reflect_clamp(x0 - 2, w)
                             : (lane == 31 ? reflect_clamp(x0 + 31, w) : col);
  // warp-uniform: does the strip hold column 1 or column w - 2?
  const bool fold_cols = x0 <= 1 || (x0 <= w - 2 && w - 2 <= x0 + 29);
  const bool fold_l = cc == 1, fold_r = cc == w - 2;
  // warp-uniform: does the tile hold row 1 or row h - 2?
  const bool fold_rows = y0 <= 1 || y0 + rows >= h - 1;
  const size_t hw = (size_t)h * w;
  const float* gp = g + (size_t)mi * hw;
  for (int j = 0; j < rows + 2; ++j) {
    const int cr = y0 - 1 + j;
    g_s[warp][j][lane] = (col_live && cr >= 0 && cr < h) ? __ldg(gp + (size_t)cr * w + col)
                                                         : 0.0f;
  }
  __syncwarp();
  const float* gs = &g_s[warp][0][lane];  // this lane's g, one row per 32 floats
  const int m_t = mi / reps;

  for (int ci = 0; ci < c; ++ci) {
    const float* xp = pred + ((size_t)mi * c + ci) * hw;
    const float* yp = target + ((size_t)m_t * c + ci) * hw;
    float* dp = opaque(dpred + ((size_t)mi * c + ci) * hw + col);  // this lane's column
    Stats open2 = {}, open1 = {};
    Coef box2 = {}, box1 = {};  // box sums with two / one center rows
    auto fold = [&](int slot) -> float(&)[5][32] { return fold_s[warp][slot]; };
    float a1r = 0.0f, b1r = 0.0f, a2r = 0.0f, b2r = 0.0f;  // pred, target 1 and 2 rows back
    const Cols p0 = cols(xp, yp, col, hcol);
    RowLoads next = load_row(p0, reflect_clamp(y0 - 2, h) * w);
    for (int k = 0; k <= rows + 3; ++k) {  // input row y0 - 2 + k
      const Row r = complete_row(next, lane);
      if (k <= rows + 2) next = load_row(p0, reflect_clamp(y0 - 1 + k, h) * w);
      const RowProducts p = products(r);
      if (k >= 2) {
        // center row cr = y0 + k - 3 closes
        const int cr = y0 + k - 3;
        const float gk = gs[(k - 2) * 32];
        const Stats s = add_row(open2, r, p);
        Coef q = {};
        if (cr >= 0 && cr < h && col_live) {
          const float mu_x = div_by<9>(s.sx);
          const float mu_y = div_by<9>(s.sy);
          const float vx = div_by<9>(s.sxx) - mu_x * mu_x;
          const float vy = div_by<9>(s.syy) - mu_y * mu_y;
          const float vxy = div_by<9>(s.sxy) - mu_x * mu_y;
          const float a1 = 2.0f * mu_x * mu_y + c1;
          const float a2 = 2.0f * vxy + c2;
          const float b1 = mu_x * mu_x + mu_y * mu_y + c1;
          const float b2 = vx + vy + c2;
          const float sv = (a1 * a2) / (b1 * b2);
          const float inner = (1.0f - sv) * 0.5f;
          const float live = (inner > 0.0f && inner < 1.0f)
                                 ? 1.0f
                                 : ((inner == 0.0f || inner == 1.0f) ? 0.5f : 0.0f);
          const float e = gk * kssim * live;
          q.p1 = e * (2.0f * a2 * (mu_y * b1 - mu_x * a1) / (b1 * b1 * b2));
          q.p2 = e * (-(a1 * a2) / (b1 * b2 * b2));
          q.p3 = e * (2.0f * a1 / (b1 * b2));
          q.p2u = q.p2 * mu_x;
          q.p3u = q.p3 * mu_y;
        }
        const Coef ql = shfl_coef_up(q);
        const Coef qr = shfl_coef_down(q);
        const Coef row = coef_row(ql, q, qr);  // first row of output cr + 1's box
        if (k >= 4) {
          // output row y = cr - 1: its box closes with center row cr
          const int y = cr - 1;
          const Coef box = coef_add_row(box2, ql, q, qr);
          float o = dxp(box, a2r, b2r);
          if (fold_cols) {  // padded column 0 (w + 1): centers of column 0 (w - 1)
            if (fold_l) o += dxp(coef_add(coef_get(fold(VL2), lane), ql), a2r, b2r);
            if (fold_r) o += dxp(coef_add(coef_get(fold(VR2), lane), qr), a2r, b2r);
          }
          if (fold_rows && y == 1) {  // padded row 0: the centers of image row 0
            float o0 = dxp(coef_get(fold(TOP), lane), a2r, b2r);
            if (fold_l) o0 += dxp(coef_get(fold(TOP_L), lane), a2r, b2r);
            if (fold_r) o0 += dxp(coef_get(fold(TOP_R), lane), a2r, b2r);
            o += o0;
          }
          if (fold_rows && y == h - 2) {  // padded row h + 1: the centers of row h - 1 == cr
            float ob = dxp(row, a2r, b2r);
            if (fold_l) ob += dxp(ql, a2r, b2r);
            if (fold_r) ob += dxp(qr, a2r, b2r);
            o += ob;
          }
          const float u = b2r - a2r;
          o += gs[(y - y0 + 1) * 32] * kl1 * (u >= 0.0f ? -1.0f : 1.0f);
          if (out_lane) dp[(unsigned)(y * w)] = o;
        }
        if (fold_rows && cr == 0) {
          coef_put(fold(TOP), lane, row);
          coef_put(fold(TOP_L), lane, ql);
          coef_put(fold(TOP_R), lane, qr);
        }
        box2 = coef_add_row(box1, ql, q, qr);
        box1 = row;
        if (fold_cols) {
          coef_put(fold(VL2), lane, coef_add(coef_get(fold(VL1), lane), ql));
          coef_put(fold(VL1), lane, ql);
          coef_put(fold(VR2), lane, coef_add(coef_get(fold(VR1), lane), qr));
          coef_put(fold(VR1), lane, qr);
        }
      }
      open2 = add_row(open1, r, p);
      open1 = first_row(r, p);
      a2r = a1r;
      b2r = b1r;
      a1r = r.a;
      b1r = r.b;
    }
  }
}

// (image, row tile, strip) tasks and blocks of WARPS tasks; 0 if they fit
int tasks(int m, int h, int w, int th, int stride, int& nstrip, int& ntile_y,
          int& ntasks, unsigned& blocks) {
  nstrip = (w + stride - 1) / stride;
  ntile_y = (h + th - 1) / th;
  const long long n = (long long)m * ntile_y * nstrip;
  if (n > INT_MAX - WARPS) return (int)cudaErrorInvalidConfiguration;
  ntasks = (int)n;
  blocks = (unsigned)((n + WARPS - 1) / WARPS);
  return 0;
}

}  // namespace

// pred (m, c, h, w), target (m / reps, c, h, w); out (m, 1, h, w).
// Needs h >= 2 and w >= 2. Returns the cudaError_t of the launch.
extern "C" int reprojection_error_f32(const float* pred, const float* target,
                                      float* out, int m, int c, int h, int w,
                                      int reps, float c1, float c2,
                                      void* stream) {
  if ((long long)m * h * w == 0) return 0;
  int nstrip, ntile_y, ntasks;
  unsigned blocks;
  if (int err = tasks(m, h, w, K2_TH, 32, nstrip, ntile_y, ntasks, blocks)) return err;
  reprojection_error_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      pred, target, out, c, h, w, reps, c1, c2, nstrip, ntile_y, ntasks);
  return (int)cudaGetLastError();
}

// pred (m, c, h, w), target (m / reps, c, h, w), g (m, 1, h, w);
// dpred (m, c, h, w). kssim = -0.85 / (2c), kl1 = 0.15 / c. Needs h >= 2 and
// w >= 2. Returns the cudaError_t of the launch.
extern "C" int reprojection_error_grad_f32(const float* pred, const float* target,
                                           const float* g, float* dpred, int m,
                                           int c, int h, int w, int reps,
                                           float c1, float c2, float kssim,
                                           float kl1, void* stream) {
  if ((long long)m * c * h * w == 0) return 0;
  int nstrip, ntile_y, ntasks;
  unsigned blocks;
  if (int err = tasks(m, h, w, K3_TH, 30, nstrip, ntile_y, ntasks, blocks)) return err;
  reprojection_error_grad_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      pred, target, g, dpred, c, h, w, reps, c1, c2, kssim, kl1, nstrip, ntile_y,
      ntasks);
  return (int)cudaGetLastError();
}
