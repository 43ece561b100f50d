"""K2 and K3: fused SSIM + L1 reprojection error, forward and gradient.

`reprojection_error` runs the K2 kernel of `csrc/reprojection.cu` on CUDA
tensors and `reprojection_error_plain` on CPU tensors; it replaces the Pallas
kernel `ops/pallas/reprojection.py::fused_reprojection_error` of the JAX
package. `reprojection_error_grad` runs K3, d/d(pred) of sum(g * error), and
replaces `fused_reprojection_error_grad`; its plain version
`reprojection_error_grad_plain` is the same analytic formula in torch ops
(not torch autograd of the chain, whose subgradients at ties differ from
JAX's). `ReprojectionError` pairs the two as one autograd Function, the
counterpart of the JAX custom VJP `fused_reprojection_error_diff`.

Every function takes `reps` pred images per target image: pred image m is
compared with target image m // reps, so the S scale predictions of one
source frame (one contiguous K1 output) take one launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..image import SSIM_C1, SSIM_C2, ssim_nchw
from ._build import check_launch, load_library


def _check(name, pred, target, reps, g=None):
    if pred.dim() != 4 or target.dim() != 4 or pred.shape[1:] != target.shape[1:] \
            or pred.shape[0] != target.shape[0] * reps:
        raise ValueError(f"{name}: pred (N*reps,C,H,W) and target (N,C,H,W) expected, "
                         f"got {tuple(pred.shape)}, {tuple(target.shape)}, reps {reps}")
    if pred.shape[2] < 2 or pred.shape[3] < 2:
        raise ValueError(f"{name}: reflect padding needs H, W >= 2, got {tuple(pred.shape)}")
    tensors = [("pred", pred), ("target", target)]
    if g is not None:
        n, _, h, w = pred.shape
        if g.shape != (n, 1, h, w):
            raise ValueError(f"{name}: g {(n, 1, h, w)} expected, got {tuple(g.shape)}")
        tensors.append(("g", g))
    for tname, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
        if t.device != pred.device:
            raise ValueError(f"{name}: {tname} on {t.device}, pred on {pred.device}")


def _kernel_device(name, tensors):
    """True for CPU tensors (plain version); checks a CUDA launch's inputs."""
    device = tensors[0].device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return True


def reprojection_error_plain(pred: torch.Tensor, target: torch.Tensor,
                             reps: int = 1) -> torch.Tensor:
    """Plain PyTorch version: (N*reps, 1, H, W) f32."""
    target = target.repeat_interleave(reps, dim=0)
    ssim_term = ssim_nchw(pred, target).mean(1, keepdim=True)
    l1 = (target - pred).abs().mean(1, keepdim=True)
    return 0.85 * ssim_term + 0.15 * l1


def reprojection_error(pred: torch.Tensor, target: torch.Tensor,
                       reps: int = 1) -> torch.Tensor:
    """Per-pixel 0.85*SSIM + 0.15*L1 error, channel-averaged.

    pred (N*reps, C, H, W), target (N, C, H, W), float32 -> (N*reps, 1, H, W)
    float32. CPU tensors take the plain version, CUDA tensors the kernel; any
    other device raises.
    """
    _check("reprojection_error", pred, target, reps)
    if not _kernel_device("reprojection_error", (pred, target)):
        return reprojection_error_plain(pred, target, reps)
    lib = load_library()
    m, c, h, w = pred.shape
    out = torch.empty((m, 1, h, w), device=pred.device, dtype=torch.float32)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.reprojection_error_f32(
            pred.data_ptr(), target.data_ptr(), out.data_ptr(), m, c, h, w, reps,
            SSIM_C1, SSIM_C2, stream)
    check_launch(err, "reprojection_error_f32")
    reprojection_error.launches += 1
    return out


reprojection_error.launches = 0


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


def reprojection_error_grad(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor,
                            reps: int = 1) -> torch.Tensor:
    """d/d(pred) of sum(g * reprojection_error(pred, target, reps)).

    pred (N*reps, C, H, W), target (N, C, H, W), g (N*reps, 1, H, W), float32
    -> (N*reps, C, H, W) float32. CPU tensors take the plain version, CUDA
    tensors the kernel; any other device raises.
    """
    _check("reprojection_error_grad", pred, target, reps, g)
    if not _kernel_device("reprojection_error_grad", (pred, target, g)):
        return reprojection_error_grad_plain(pred, target, g, reps)
    m, c, h, w = pred.shape
    lib = load_library()
    out = torch.empty_like(pred)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.reprojection_error_grad_f32(
            pred.data_ptr(), target.data_ptr(), g.data_ptr(), out.data_ptr(), m, c, h, w,
            reps, SSIM_C1, SSIM_C2, -0.85 / (2.0 * c), 0.15 / c, stream)
    check_launch(err, "reprojection_error_grad_f32")
    reprojection_error_grad.launches += 1
    return out


reprojection_error_grad.launches = 0


class ReprojectionError(torch.autograd.Function):
    """K2 forward, K3 backward: the differentiable fused error.

    pred (N*reps, C, H, W) -> (N*reps, 1, H, W). The target is data: its
    gradient is None (the JAX custom VJP returns zeros).
    """

    @staticmethod
    def forward(ctx, pred, target, reps):
        ctx.reps = reps
        ctx.save_for_backward(pred, target)
        return reprojection_error(pred, target, reps)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        # g is one plane per image; autograd may hand it over strided
        return reprojection_error_grad(pred, target, g.contiguous(), ctx.reps), None, None


def reprojection_error_diff(pred: torch.Tensor, target: torch.Tensor,
                            reps: int = 1) -> torch.Tensor:
    """Functional form of `ReprojectionError`."""
    return ReprojectionError.apply(pred, target, reps)
