"""Cross-entropy with ignore index (NCHW logits).

Port of the JAX package's `ops/losses.py::cross_entropy2d` (reference
loss/loss.py:18-37) without class weights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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
