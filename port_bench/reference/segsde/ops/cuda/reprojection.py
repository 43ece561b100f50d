"""K2 and K3's plain versions on every device: the fused SSIM+L1
reprojection error, its analytic gradient, and the two as one autograd
Function (the port's `ops/cuda/reprojection.py` without the kernels)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..image import SSIM_C1, SSIM_C2, ssim_nchw


def reprojection_error_plain(pred: torch.Tensor, target: torch.Tensor,
                             reps: int = 1) -> torch.Tensor:
    """Plain PyTorch version: (N*reps, 1, H, W) f32."""
    target = target.repeat_interleave(reps, dim=0)
    ssim_term = ssim_nchw(pred, target).mean(1, keepdim=True)
    l1 = (target - pred).abs().mean(1, keepdim=True)
    return 0.85 * ssim_term + 0.15 * l1


def _window_sum9(x: torch.Tensor) -> torch.Tensor:
    """Sum over each 3x3 window (valid): (..., H+2, W+2) -> (..., H, W),
    added row-major from zero, the kernel's order."""
    h, w = x.shape[-2] - 2, x.shape[-1] - 2
    acc = torch.zeros_like(x[..., :h, :w])
    for dy in range(3):
        for dx in range(3):
            acc = acc + x[..., dy:dy + h, dx:dx + w]
    return acc


def _div9(x: torch.Tensor) -> torch.Tensor:
    """x / 9 as a true division on every device. PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, one bit off, which flat
    windows amplify by up to 1/C2^2 in the gradient's coefficients; a 0-dim
    tensor on x's device keeps the division (the kernel's and JAX's)."""
    return x / x.new_full((), 9.0)


def reprojection_error_grad_plain(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor,
                                  reps: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K3: d/d(pred) of sum(g * error), (N*reps, C, H, W).

    The analytic formula of `csrc/reprojection.cu` (and of the JAX
    `_reproj_bwd_kernel`) in torch ops, with JAX's subgradients at ties.
    """
    m, c, h, w = pred.shape
    target = target.repeat_interleave(reps, dim=0)
    xp = F.pad(pred, (1, 1, 1, 1), mode="reflect")
    yp = F.pad(target, (1, 1, 1, 1), mode="reflect")
    mu_x = _div9(_window_sum9(xp))
    mu_y = _div9(_window_sum9(yp))
    vx = _div9(_window_sum9(xp * xp)) - mu_x * mu_x
    vy = _div9(_window_sum9(yp * yp)) - mu_y * mu_y
    vxy = _div9(_window_sum9(xp * yp)) - mu_x * mu_y
    a1 = 2.0 * mu_x * mu_y + SSIM_C1
    a2 = 2.0 * vxy + SSIM_C2
    b1 = mu_x * mu_x + mu_y * mu_y + SSIM_C1
    b2 = vx + vy + SSIM_C2
    s = (a1 * a2) / (b1 * b2)
    inner = (1.0 - s) * 0.5
    live = torch.where((inner > 0.0) & (inner < 1.0), 1.0,
                       torch.where((inner == 0.0) | (inner == 1.0), 0.5, 0.0))
    e = g * (-0.85 / (2.0 * c)) * live
    p1 = e * (2.0 * a2 * (mu_y * b1 - mu_x * a1) / (b1 * b1 * b2))
    p2 = e * (-(a1 * a2) / (b1 * b2 * b2))
    p3 = e * (2.0 * a1 / (b1 * b2))
    # box filter of the center planes onto the padded grid: padded position P
    # sums the centers P-2..P (zero outside the image)
    b_p1, b_p2, b_p2u, b_p3, b_p3u = (
        _window_sum9(F.pad(t, (2, 2, 2, 2))) for t in (p1, p2, p2 * mu_x, p3, p3 * mu_y))
    dxp = _div9(b_p1 + 2.0 * xp * b_p2 - 2.0 * b_p2u + yp * b_p3 - b_p3u)
    # reflect-pad backward: fold the padded border onto its sources,
    # columns first
    dxp[..., 2] += dxp[..., 0]
    dxp[..., w - 1] += dxp[..., w + 1]
    dxp[..., 2, :] += dxp[..., 0, :]
    dxp[..., h - 1, :] += dxp[..., h + 1, :]
    u = target - pred
    return dxp[..., 1:h + 1, 1:w + 1] + g * (0.15 / c) * -torch.where(u >= 0, 1.0, -1.0)


reprojection_error = reprojection_error_plain
reprojection_error_grad = reprojection_error_grad_plain


class ReprojectionError(torch.autograd.Function):
    """The plain error forward, its analytic gradient backward; the target
    is data (no gradient)."""

    @staticmethod
    def forward(ctx, pred, target, reps):
        ctx.reps = reps
        ctx.save_for_backward(pred, target)
        return reprojection_error(pred, target, reps)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        return reprojection_error_grad(pred, target, g.contiguous(), ctx.reps), None, None


def reprojection_error_diff(pred: torch.Tensor, target: torch.Tensor,
                            reps: int = 1) -> torch.Tensor:
    """Functional form of `ReprojectionError`."""
    return ReprojectionError.apply(pred, target, reps)
