"""Bilinear and nearest resizes (NCHW), PyTorch `F.interpolate` semantics.

Port of the JAX package's `ops/resize.py`, which builds the same math from
interpolation-weight matmuls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to `out_hw = (H_out, W_out)`."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=align_corners)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample (reference models/monodepth_layers.py:202-205)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
