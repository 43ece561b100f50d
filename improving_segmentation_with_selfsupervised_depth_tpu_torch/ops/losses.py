"""Cross-entropy with ignore index (NCHW logits) and the reverse-Huber
depth loss.

Port of the JAX package's `ops/losses.py`: `cross_entropy2d` (reference
loss/loss.py:18-37) without class weights, and `berhu` (loss/loss.py:5-15).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .image import abs_jax
from .resize import resize_bilinear

IGNORE_INDEX = 250


def cross_entropy2d(logits: torch.Tensor, target: torch.Tensor,
                    ignore_index: int = IGNORE_INDEX,
                    pixel_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE of (N, C, H, W) logits against (N, Ht, Wt) integer labels. Logits of
    another size are bilinearly resized with align_corners=True first.

    Without `pixel_weights`: the mean over non-ignored pixels (0 when every
    pixel is ignored). With (N, Ht, Wt) `pixel_weights` (no gradient): the
    weighted per-pixel loss, ignored pixels 0, averaged over all pixels.
    """
    h, w = logits.shape[2:]
    ht, wt = target.shape[1:]
    if h != ht and w != wt:
        logits = resize_bilinear(logits, (ht, wt), align_corners=True)
    nll = F.cross_entropy(logits.float(), target.long(), ignore_index=ignore_index,
                          reduction="none")
    if pixel_weights is not None:
        return (pixel_weights.detach() * nll).mean()
    valid = (target != ignore_index).sum().clamp(min=1)
    return nll.sum() / valid


def berhu(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
          apply_log: bool = False) -> torch.Tensor:
    """Reverse-Huber loss with the threshold c = 0.2 max |err|, averaged over
    every element (masked ones count as 0). c carries no gradient and is at
    least 1e-12; `apply_log` compares log1p of both sides."""
    if apply_log:
        pred = torch.log1p(pred)
        target = torch.log1p(target)
    absdiff = abs_jax(target - pred) * mask
    c = torch.clamp_min(0.2 * absdiff.detach().amax(), 1e-12)
    return torch.where(absdiff <= c, absdiff, (absdiff * absdiff + c * c) / (2.0 * c)).mean()
