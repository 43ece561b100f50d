"""K2: fused SSIM + L1 reprojection error, forward.

`reprojection_error` runs the CUDA kernel of `csrc/reprojection.cu` on CUDA
tensors and `reprojection_error_plain` on CPU tensors. The kernel replaces the
Pallas kernel `ops/pallas/reprojection.py::fused_reprojection_error` of the
JAX package; the plain version is the reflect-pad + avg_pool2d chain of
`ops/image.py::ssim_nchw`. No gradient: it serves the identity-reprojection
losses, which depend on input frames only.
"""

from __future__ import annotations

import torch

from ..image import SSIM_C1, SSIM_C2, ssim_nchw
from ._build import check_launch, load_library


def _check(pred, target):
    if pred.dim() != 4 or pred.shape != target.shape:
        raise ValueError(f"reprojection_error: pred/target (N,C,H,W) of one shape "
                         f"expected, got {tuple(pred.shape)}, {tuple(target.shape)}")
    if pred.shape[2] < 2 or pred.shape[3] < 2:
        raise ValueError(f"reprojection_error: reflect padding needs H, W >= 2, "
                         f"got {tuple(pred.shape)}")
    for name, t in (("pred", pred), ("target", target)):
        if t.dtype != torch.float32:
            raise TypeError(f"reprojection_error: {name} must be float32, got {t.dtype}")
    if pred.device != target.device:
        raise ValueError(f"reprojection_error: pred on {pred.device}, "
                         f"target on {target.device}")


def reprojection_error_plain(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, 1, H, W) f32."""
    ssim_term = ssim_nchw(pred, target).mean(1, keepdim=True)
    l1 = (target - pred).abs().mean(1, keepdim=True)
    return 0.85 * ssim_term + 0.15 * l1


def reprojection_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-pixel 0.85*SSIM + 0.15*L1 error, channel-averaged.

    pred/target (N, C, H, W) float32 -> (N, 1, H, W) float32. CPU tensors take
    the plain version, CUDA tensors the kernel; any other device raises.
    """
    _check(pred, target)
    if pred.device.type == "cpu":
        return reprojection_error_plain(pred, target)
    if pred.device.type != "cuda":
        raise ValueError(f"reprojection_error: no kernel for device {pred.device}")
    if not (pred.is_contiguous() and target.is_contiguous()):
        raise ValueError("reprojection_error: pred and target must be contiguous")
    lib = load_library()
    n, c, h, w = pred.shape
    out = torch.empty((n, 1, h, w), device=pred.device, dtype=torch.float32)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.reprojection_error_f32(
            pred.data_ptr(), target.data_ptr(), out.data_ptr(), n, c, h, w,
            SSIM_C1, SSIM_C2, stream)
    check_launch(err, "reprojection_error_f32")
    reprojection_error.launches += 1
    return out


reprojection_error.launches = 0
