"""K1: multi-grid bilinear warp with grid-gradient planes.

`warp_bilinear_nchw` runs the CUDA kernel of `csrc/warp.cu` on CUDA tensors
and `warp_bilinear_nchw_plain` on CPU tensors. Both take the grids in [-1, 1]
as the photometric loss makes them; the kernel unnormalizes them in
registers with the f32 operations of `unnormalize_grid`, so kernel and plain
version floor identical values and pick identical corners. The plain version
is `unnormalize_grid` followed by `warp_pixels_plain`, the port of the JAX
f32 reference `ops/resample.py::_pack_fallback_coeffs`; the kernel replaces
the Pallas kernel `ops/pallas/warp.py::bilinear_warp_corners_nchw` of the
JAX package.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library


def unnormalize_grid(grid: torch.Tensor, h: int, w: int):
    """[-1, 1] grid (..., 2) -> pixel coordinates (ix, iy), align_corners=True."""
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)


def _check(img, grid, reps):
    if img.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2:
        raise ValueError(f"warp: img (N,C,H,W) and grid (N*S,Hg,Wg,2) expected, "
                         f"got {tuple(img.shape)}, {tuple(grid.shape)}")
    if grid.shape[0] != img.shape[0] * reps:
        raise ValueError(f"warp: {grid.shape[0]} grids for {img.shape[0]} images x {reps}")
    if grid.numel() and (img.shape[2] == 0 or img.shape[3] == 0):
        raise ValueError(f"warp: nothing to sample in an image of {tuple(img.shape)}")
    for name, t in (("img", img), ("grid", grid)):
        if t.dtype != torch.float32:
            raise TypeError(f"warp: {name} must be float32, got {t.dtype}")
        if t.device != img.device:
            raise ValueError(f"warp: {name} on {t.device}, img on {img.device}")


def warp_pixels_plain(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, reps: int = 1):
    """The warp at pixel coordinates ix/iy (N*S, Hg, Wg): (out, dfx, dfy), each
    (N*S, C, Hg, Wg) f32. A NaN coordinate samples as -1, as in the kernel."""
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


def warp_bilinear_nchw_plain(img: torch.Tensor, grid: torch.Tensor, reps: int = 1):
    """Plain PyTorch version: (out, dfx, dfy), each (N*S, C, Hg, Wg) f32."""
    ix, iy = unnormalize_grid(grid, *img.shape[2:])
    return warp_pixels_plain(img, ix, iy, reps)


def _launch(img: torch.Tensor, grid: torch.Tensor, reps: int):
    """The kernel, uncounted (csrc/warp.cu): a 3-channel image is first
    written as float4 pixels into scratch and gathered from there, any other
    from its channel planes."""
    if not (img.is_contiguous() and grid.is_contiguous()):
        raise ValueError("warp: img and grid must be contiguous")
    n, c, h, w = img.shape
    m, hg, wg, _ = grid.shape
    if max(m, hg * wg, h * w) >= 2**31:
        raise ValueError(f"warp: img {tuple(img.shape)} or grid {tuple(grid.shape)} too large "
                         f"for the kernel's 32-bit counts")
    lib = load_library()
    out = torch.empty((m, c, hg, wg), device=img.device, dtype=torch.float32)
    dfx = torch.empty_like(out)
    dfy = torch.empty_like(out)
    img4 = (torch.empty((n, h, w, 4), device=img.device, dtype=torch.float32)
            if c == 3 else None)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.warp_bilinear_nchw_f32(
            img.data_ptr(), grid.data_ptr(), None if img4 is None else img4.data_ptr(),
            out.data_ptr(), dfx.data_ptr(), dfy.data_ptr(), n, c, h, w, reps, hg, wg, stream)
    check_launch(err, "warp_bilinear_nchw_f32")
    return out, dfx, dfy


def warp_bilinear_nchw(img: torch.Tensor, grid: torch.Tensor, reps: int = 1):
    """Warp `img` (N, C, H, W) at `reps` grids per image.

    grid (N*reps, Hg, Wg, 2) holds (x, y) in [-1, 1]; grid g samples image
    g // reps with bilinear interpolation, border padding, align_corners=True.
    Returns (out, dfx, dfy), each (N*reps, C, Hg, Wg) float32, where dfx/dfy
    are d out / d ix and d out / d iy at the pixel coordinates ix, iy of
    `unnormalize_grid`. CPU tensors take the plain version, CUDA tensors the
    kernel; any other device raises.
    """
    _check(img, grid, reps)
    if img.device.type == "cpu":
        return warp_bilinear_nchw_plain(img, grid, reps)
    if img.device.type != "cuda":
        raise ValueError(f"warp: no kernel for device {img.device}")
    result = _launch(img, grid, reps)
    warp_bilinear_nchw.launches += 1
    return result


warp_bilinear_nchw.launches = 0
