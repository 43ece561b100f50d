"""K1's plain version on every device: the multi-grid bilinear warp with its
grid-gradient planes (the port's `ops/cuda/warp.py` without the kernel)."""

from __future__ import annotations

import torch


def unnormalize_grid(grid: torch.Tensor, h: int, w: int):
    """[-1, 1] grid (..., 2) -> pixel coordinates (ix, iy), align_corners=True."""
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)


def warp_pixels_plain(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, reps: int = 1):
    """The warp at pixel coordinates ix/iy (N*S, Hg, Wg): (out, dfx, dfy), each
    (N*S, C, Hg, Wg) f32. A NaN coordinate samples as -1."""
    n, c, h, w = img.shape
    m, hg, wg = ix.shape
    ix = ix.nan_to_num(-1.0).clamp(-1.0, float(w))
    iy = iy.nan_to_num(-1.0).clamp(-1.0, float(h))
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = (ix - x0)[:, None]
    fy = (iy - y0)[:, None]
    x0c = x0.clamp(0, w - 1).long()
    x1c = (x0 + 1).clamp(0, w - 1).long()
    y0c = y0.clamp(0, h - 1).long()
    y1c = (y0 + 1).clamp(0, h - 1).long()

    flat = img.reshape(n, c, h * w)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, reps * hg * wg).expand(n, c, -1)
        g = torch.gather(flat, 2, idx).reshape(n, c, reps, hg, wg)
        return g.transpose(1, 2).reshape(m, c, hg, wg)

    g00 = gather(y0c, x0c)
    g01 = gather(y0c, x1c)
    g10 = gather(y1c, x0c)
    g11 = gather(y1c, x1c)
    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    out = w00 * g00 + w01 * g01 + w10 * g10 + w11 * g11
    dfx = (g01 - g00) * (1.0 - fy) + (g11 - g10) * fy
    dfy = (g10 - g00) * (1.0 - fx) + (g11 - g01) * fx
    return out, dfx, dfy


def warp_bilinear_nchw(img: torch.Tensor, grid: torch.Tensor, reps: int = 1):
    """Warp `img` (N, C, H, W) at `reps` grids per image, grid (N*reps, Hg,
    Wg, 2) in [-1, 1]: (out, dfx, dfy), each (N*reps, C, Hg, Wg) f32."""
    ix, iy = unnormalize_grid(grid, *img.shape[2:])
    return warp_pixels_plain(img, ix, iy, reps)
