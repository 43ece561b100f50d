"""Image-space ops: SSIM, edge-aware smoothness, strong augmentation (NCHW).

Port of the JAX package's `ops/image.py`. The port is NCHW throughout, so
the JAX `ssim` (NHWC) and `ssim_nchw` are one function here.

Subgradients at ties follow JAX, not torch: `clip` is 0.5 at an exact bound
(JAX splits max/min gradients at ties; `torch.clamp` gives 1) and `abs` is +1
at 0 (`torch.abs` gives 0). Identical windows (SSIM exactly 1) and equal
neighbouring disparities make both ties real.

The augmentations take their random parameters explicitly, so a test can feed
both frameworks the same values; a `torch.Generator` draws the ones not given.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2


def abs_jax(u: torch.Tensor) -> torch.Tensor:
    """|u| whose gradient at u = 0 is +1, as `jnp.abs`'s."""
    return torch.where(u >= 0, u, -u)


def clip_jax(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip(x, lo, hi) whose gradient at an exact bound is 0.5, as `jnp.clip`'s."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _avg_pool3x3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1)


def ssim_nchw(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity map clip((1 - SSIM)/2, 0, 1), shape (N, C, H, W).

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
    return clip_jax((1.0 - ssim_n / ssim_d) * 0.5, 0.0, 1.0)


def smoothness_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware disparity smoothness (scalar); disp (N,1,H,W), img (N,3,H,W).

    Reference models/monodepth_layers.py:208-221.
    """
    grad_disp_x = abs_jax(disp[:, :, :, :-1] - disp[:, :, :, 1:])
    grad_disp_y = abs_jax(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    grad_img_x = abs_jax(img[:, :, :, :-1] - img[:, :, :, 1:]).mean(1, keepdim=True)
    grad_img_y = abs_jax(img[:, :, :-1, :] - img[:, :, 1:, :]).mean(1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return grad_disp_x.mean() + grad_disp_y.mean()


# ---------------------------------------------------------------------------
# Strong augmentation of the unlabeled images (JAX ops/image.py:94-189;
# reference loader/transformsgpu.py, kornia). No gradient flows through it.
# ---------------------------------------------------------------------------


def uniform(generator: Optional[torch.Generator], device, shape=(), lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """U(lo, hi) of `shape` from `generator` (on the generator's device, or
    `device` without one), moved to `device`."""
    gen_device = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=gen_device)
    return (lo + (hi - lo) * u).to(device)


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _gaussian_kernel1d(size: int, sigma: torch.Tensor) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=sigma.device) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def _odd_kernel_size(v: int) -> int:
    """ceil(0.1 * v), made odd by stepping down, at least 1."""
    k = math.ceil(0.1 * v)
    if k % 2 == 0:
        k -= 1
    return max(k, 1)


def gaussian_blur(img: torch.Tensor, sigma=None, apply_draw=None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Separable Gaussian blur of `img` (N, C, H, W), reflect padding, kernel
    ~10% of each image side (odd), one `sigma` for the batch.

    `sigma` ~ U(0.15, 1.15) is drawn from `generator` when not given. With an
    `apply_draw` the blur applies only where it is > 0.5 (reference
    loader/transformsgpu.py:20-30); without one it always applies.
    """
    n, c, h, w = img.shape
    ky, kx = _odd_kernel_size(h), _odd_kernel_size(w)
    sigma = _scalar(sigma if sigma is not None
                    else uniform(generator, img.device, lo=0.15, hi=1.15), img.device)
    kern_y = _gaussian_kernel1d(ky, sigma).reshape(1, 1, ky, 1).expand(c, 1, ky, 1)
    kern_x = _gaussian_kernel1d(kx, sigma).reshape(1, 1, 1, kx).expand(c, 1, 1, kx)
    out = F.conv2d(F.pad(img, (0, 0, ky // 2, ky // 2), mode="reflect"), kern_y, groups=c)
    out = F.conv2d(F.pad(out, (kx // 2, kx // 2, 0, 0), mode="reflect"), kern_x, groups=c)
    if apply_draw is not None:
        out = torch.where(_scalar(apply_draw, img.device) > 0.5, out, img)
    return out


_RGB_TO_YIQ = ((0.299, 0.587, 0.114), (0.5959, -0.2746, -0.3213), (0.2115, -0.5227, 0.3112))
_YIQ_TO_RGB = ((1.0, 0.956, 0.619), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    return 0.299 * img[:, 0:1] + 0.587 * img[:, 1:2] + 0.114 * img[:, 2:3]


def color_jitter(img: torch.Tensor, s: float = 0.25,
                 factors: Optional[Sequence] = None, apply_draw=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Brightness, contrast, saturation and hue jitter of strength `s`, one set
    of parameters for the batch; `img` (N, 3, H, W) in [0, 1].

    `factors` = (brightness, contrast, saturation, hue): the first three in
    [1-s, 1+s], hue in [-s, s] (a YIQ rotation by hue * 2 pi). They are drawn
    from `generator` when not given. With an `apply_draw` the jitter applies
    only where it is > 0.2 (reference loader/transformsgpu.py:10-17); without
    one it always applies.
    """
    dev = img.device
    if factors is None:
        factors = [uniform(generator, dev, lo=1 - s, hi=1 + s) for _ in range(3)]
        factors.append(uniform(generator, dev, lo=-s, hi=s))
    fb, fc, fs, fh = (_scalar(f, dev) for f in factors)
    fh = fh * 2.0 * math.pi

    out = clip_jax(img * fb, 0.0, 1.0)
    mean = _rgb_to_gray(out).mean((1, 2, 3), keepdim=True)
    out = clip_jax((out - mean) * fc + mean, 0.0, 1.0)
    gray = _rgb_to_gray(out)
    out = clip_jax((out - gray) * fs + gray, 0.0, 1.0)

    rot = torch.eye(3, device=dev)
    cos_h, sin_h = torch.cos(fh), torch.sin(fh)
    rot[1, 1], rot[1, 2], rot[2, 1], rot[2, 2] = cos_h, -sin_h, sin_h, cos_h
    m = torch.tensor(_YIQ_TO_RGB, device=dev) @ rot @ torch.tensor(_RGB_TO_YIQ, device=dev)
    out = clip_jax(torch.einsum("ij,njhw->nihw", m, out), 0.0, 1.0)
    if apply_draw is not None:
        out = torch.where(_scalar(apply_draw, dev) > 0.2, out, img)
    return out
