"""Cross-entropy with ignore index (NCHW logits).

Port of the JAX package's `ops/losses.py::cross_entropy2d` (reference
loss/loss.py:18-37) without class or pixel weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .resize import resize_bilinear

IGNORE_INDEX = 250


def cross_entropy2d(logits: torch.Tensor, target: torch.Tensor,
                    ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """CE of (N, C, H, W) logits against (N, Ht, Wt) integer labels: the mean
    over non-ignored pixels (0 when every pixel is ignored). Logits of another
    size are bilinearly resized with align_corners=True first."""
    h, w = logits.shape[2:]
    ht, wt = target.shape[1:]
    if h != ht and w != wt:
        logits = resize_bilinear(logits, (ht, wt), align_corners=True)
    nll = F.cross_entropy(logits.float(), target.long(), ignore_index=ignore_index,
                          reduction="none")
    valid = (target != ignore_index).sum().clamp(min=1)
    return nll.sum() / valid
