"""DepthMix masks and batch mixing (NCHW).

Port of the JAX package's `ops/mixing.py` (reference train.py:572-642,
loader/transformmasks.py, loader/transformsgpu.py:33-47): each sample is
mixed with the next one in the batch (roll by 1), and the depthcomp mask
compares each sample's disparity with that partner's. The class and
depth-histogram masks wait for exp-210.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import not_ported
from .image import uniform


def mix(mask: torch.Tensor, data: Optional[torch.Tensor] = None,
        target: Optional[torch.Tensor] = None):
    """Blend each sample with the next one under `mask` (N, H, W).

    `data` and `target` are (N, C, H, W); returns (mixed data, mixed target),
    None where the input was None.
    """
    def blend(x):
        m = mask[:, None].to(x.dtype)
        return m * x + (1.0 - m) * torch.roll(x, shifts=-1, dims=0)

    return (blend(data) if data is not None else None,
            blend(target) if target is not None else None)


def generate_depth_mask(depth: torch.Tensor, t_low, t_high=None) -> torch.Tensor:
    """1 where `depth` >= t_low (or inside [t_low, t_high]); float (N, H, W)."""
    if t_high is None:
        return (depth >= t_low).float()
    lo, hi = torch.minimum(t_low, t_high), torch.maximum(t_low, t_high)
    return ((depth >= lo) & (depth <= hi)).float()


def generate_depthcomp_mask(disps: torch.Tensor, margin: float, foreground_threshold,
                            threshold_draw=None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DepthMix foreground-comparison mask; `disps` (N, H, W) normalized disparity.

    A pixel is foreground where its disparity is >= the partner's minus
    `margin` and >= the foreground threshold. A (low, high) threshold is
    drawn once per batch, U(low, high): `threshold_draw` injects it,
    otherwise `generator` draws it.
    """
    other = torch.roll(disps, shifts=-1, dims=0)
    fg = (disps >= other - margin).float()
    if isinstance(foreground_threshold, (tuple, list)):
        lo, hi = foreground_threshold
        if threshold_draw is None:
            threshold_draw = uniform(generator, disps.device, lo=lo, hi=hi)
        ft = torch.as_tensor(threshold_draw, dtype=torch.float32, device=disps.device)
    else:
        ft = torch.as_tensor(foreground_threshold, dtype=torch.float32, device=disps.device)
    return fg * (disps >= ft).float()


def generate_class_mask(*args, **kwargs):
    raise not_ported("ClassMix masks (mix_mask: class)", "exp-210")


def depthhist_thresholds(*args, **kwargs):
    raise not_ported("depth-histogram mix thresholds (mix_mask: depthhist)", "exp-210")
