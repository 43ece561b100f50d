"""Differentiable image warping with torch `grid_sample` semantics (NCHW).

Port of the JAX package's `ops/resample.py`: bilinear sampling with border
padding. `grid_sample` is the plain, fully differentiable form; it has no
caller on the supervised path yet.
`grid_sample_pack_nchw` is the photometric-loss form: it warps one source
frame at all S scale grids with one launch of K1 (`ops/cuda/warp.py`) and
treats the image as data, so its backward is elementwise in the saved
gradient planes (JAX `_gsp_bwd`, ops/resample.py:287-293).
"""

from __future__ import annotations

import torch

from .cuda.warp import unnormalize_grid, warp_bilinear_nchw, warp_pixels_plain


def grid_sample(img: torch.Tensor, grid: torch.Tensor, align_corners: bool = True
                ) -> torch.Tensor:
    """Bilinear sampling of `img` (N, C, H, W) f32 at `grid` (N, Hg, Wg, 2),
    border padding; grid[..., 0] is x and grid[..., 1] is y in [-1, 1].
    Plain PyTorch, differentiable in both arguments."""
    h, w = img.shape[2:]
    if align_corners:
        ix, iy = unnormalize_grid(grid, h, w)
    else:
        ix = ((grid[..., 0].float() + 1.0) * w - 1.0) * 0.5
        iy = ((grid[..., 1].float() + 1.0) * h - 1.0) * 0.5
    return warp_pixels_plain(img, ix, iy)[0]


class GridSamplePackNCHW(torch.autograd.Function):
    """Warp `img` (N, C, H, W) at S grids (N, S, Hg, Wg, 2) -> (N, S, C, Hg, Wg).

    Border padding, align_corners=True. `img` is data: its gradient is None.
    The forward runs K1 once on the grids as they are (K1 unnormalizes them)
    and saves its d out/d ix and d out/d iy planes; the backward reduces them
    against the cotangent over channels.
    """

    @staticmethod
    def forward(ctx, img, grids):
        n, s, hg, wg, _ = grids.shape
        h, w = img.shape[2:]
        out, dfx, dfy = warp_bilinear_nchw(img, grids.reshape(n * s, hg, wg, 2).float(), reps=s)
        ctx.save_for_backward(dfx, dfy)
        ctx.scale = (0.5 * (w - 1), 0.5 * (h - 1))
        ctx.grid_shape = grids.shape
        return out.reshape(n, s, img.shape[1], hg, wg).to(img.dtype)

    @staticmethod
    def backward(ctx, ct):
        dfx, dfy = ctx.saved_tensors
        ct = ct.float().reshape(dfx.shape)
        sx, sy = ctx.scale
        dgx = (ct * dfx).sum(1) * sx  # (N*S, Hg, Wg)
        dgy = (ct * dfy).sum(1) * sy
        return None, torch.stack([dgx, dgy], dim=-1).reshape(ctx.grid_shape)


def grid_sample_pack_nchw(img: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Functional form of `GridSamplePackNCHW`."""
    return GridSamplePackNCHW.apply(img, grids)
