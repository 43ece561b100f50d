"""K1: multi-grid bilinear warp with grid-gradient planes.

`warp_bilinear_nchw` runs the CUDA kernel of `csrc/warp.cu` on CUDA tensors
and `warp_bilinear_nchw_plain` on CPU tensors. The plain version is the port
of the JAX f32 reference `ops/resample.py::_pack_fallback_coeffs`; the kernel
replaces the Pallas kernel `ops/pallas/warp.py::bilinear_warp_corners_nchw`
of the JAX package. Both take pixel coordinates (`unnormalize_grid`), so
kernel and plain version floor identical f32 values and pick identical
corners.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library


def unnormalize_grid(grid: torch.Tensor, h: int, w: int):
    """[-1, 1] grid (..., 2) -> pixel coordinates (ix, iy), align_corners=True."""
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)


def _check(img, ix, iy, reps):
    if img.dim() != 4 or ix.dim() != 3 or ix.shape != iy.shape:
        raise ValueError(f"warp: img (N,C,H,W) and ix/iy (N*S,Hg,Wg) expected, "
                         f"got {tuple(img.shape)}, {tuple(ix.shape)}, {tuple(iy.shape)}")
    if ix.shape[0] != img.shape[0] * reps:
        raise ValueError(f"warp: {ix.shape[0]} grids for {img.shape[0]} images x {reps}")
    for name, t in (("img", img), ("ix", ix), ("iy", iy)):
        if t.dtype != torch.float32:
            raise TypeError(f"warp: {name} must be float32, got {t.dtype}")
        if t.device != img.device:
            raise ValueError(f"warp: {name} on {t.device}, img on {img.device}")


def warp_bilinear_nchw_plain(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                             reps: int = 1):
    """Plain PyTorch version: (out, dfx, dfy), each (N*S, C, Hg, Wg) f32."""
    n, c, h, w = img.shape
    m, hg, wg = ix.shape
    ix = ix.clamp(-1.0, float(w))
    iy = iy.clamp(-1.0, float(h))
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


def warp_bilinear_nchw(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                       reps: int = 1):
    """Warp `img` (N, C, H, W) at `reps` grids per image.

    ix/iy (N*reps, Hg, Wg) are pixel coordinates; grid g samples image
    g // reps with bilinear interpolation, border padding, align_corners=True.
    Returns (out, dfx, dfy), each (N*reps, C, Hg, Wg) float32, where dfx/dfy
    are d out / d ix and d out / d iy. CPU tensors take the plain version,
    CUDA tensors the kernel; any other device raises.
    """
    _check(img, ix, iy, reps)
    if img.device.type == "cpu":
        return warp_bilinear_nchw_plain(img, ix, iy, reps)
    if img.device.type != "cuda":
        raise ValueError(f"warp: no kernel for device {img.device}")
    if not (img.is_contiguous() and ix.is_contiguous() and iy.is_contiguous()):
        raise ValueError("warp: img, ix and iy must be contiguous")
    lib = load_library()
    n, c, h, w = img.shape
    m, hg, wg = ix.shape
    out = torch.empty((m, c, hg, wg), device=img.device, dtype=torch.float32)
    dfx = torch.empty_like(out)
    dfy = torch.empty_like(out)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.warp_bilinear_nchw_f32(
            img.data_ptr(), ix.data_ptr(), iy.data_ptr(), out.data_ptr(),
            dfx.data_ptr(), dfy.data_ptr(), n, c, h, w, reps, hg, wg, stream)
    check_launch(err, "warp_bilinear_nchw_f32")
    warp_bilinear_nchw.launches += 1
    return out, dfx, dfy


warp_bilinear_nchw.launches = 0
