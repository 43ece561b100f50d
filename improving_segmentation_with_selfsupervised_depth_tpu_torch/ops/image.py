"""Image-space ops: SSIM and edge-aware smoothness (NCHW).

Port of the JAX package's `ops/image.py:15-92`. The port is NCHW throughout,
so the JAX `ssim` (NHWC) and `ssim_nchw` are one function here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2


def _avg_pool3x3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1)


def ssim_nchw(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity map clamp((1 - SSIM)/2, 0, 1), shape (N, C, H, W).

    3x3 average-pool windows over reflection-padded inputs (reference
    models/monodepth_layers.py:224-254).
    """
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    yp = F.pad(y, (1, 1, 1, 1), mode="reflect")
    mu_x = _avg_pool3x3(xp)
    mu_y = _avg_pool3x3(yp)
    sigma_x = _avg_pool3x3(xp * xp) - mu_x * mu_x
    sigma_y = _avg_pool3x3(yp * yp) - mu_y * mu_y
    sigma_xy = _avg_pool3x3(xp * yp) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + SSIM_C1) * (2 * sigma_xy + SSIM_C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + SSIM_C1) * (sigma_x + sigma_y + SSIM_C2)
    return torch.clamp((1.0 - ssim_n / ssim_d) * 0.5, 0.0, 1.0)


def smoothness_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware disparity smoothness (scalar); disp (N,1,H,W), img (N,3,H,W).

    Reference models/monodepth_layers.py:208-221.
    """
    grad_disp_x = (disp[:, :, :, :-1] - disp[:, :, :, 1:]).abs()
    grad_disp_y = (disp[:, :, :-1, :] - disp[:, :, 1:, :]).abs()
    grad_img_x = (img[:, :, :, :-1] - img[:, :, :, 1:]).abs().mean(1, keepdim=True)
    grad_img_y = (img[:, :, :-1, :] - img[:, :, 1:, :]).abs().mean(1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return grad_disp_x.mean() + grad_disp_y.mean()
