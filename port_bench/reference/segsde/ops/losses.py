"""Cross-entropy with ignore index (NCHW logits), the reverse-Huber depth
loss and the per-pixel entropy of the segmentation.

Port of the JAX package's `ops/losses.py`: `cross_entropy2d` (reference
loss/loss.py:18-37) without class weights, `berhu` (loss/loss.py:5-15) and
`pixel_wise_entropy` (loss/loss.py:40-47). Over more than one rank the
means and the berhu threshold are over the global batch (`parallel/dist.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import dist
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
        return dist.batch_mean(pixel_weights.detach() * nll)
    valid = dist.global_sum((target != ignore_index).sum()).clamp(min=1)
    return dist.batch_sum(nll) / valid


def berhu(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
          apply_log: bool = False) -> torch.Tensor:
    """Reverse-Huber loss with the threshold c = 0.2 max |err|, averaged over
    every element (masked ones count as 0). c carries no gradient and is at
    least 1e-12; `apply_log` compares log1p of both sides."""
    if apply_log:
        pred = torch.log1p(pred)
        target = torch.log1p(target)
    absdiff = abs_jax(target - pred) * mask
    c = torch.clamp_min(0.2 * dist.global_max(absdiff.detach().amax()), 1e-12)
    return dist.batch_mean(torch.where(absdiff <= c, absdiff,
                                       (absdiff * absdiff + c * c) / (2.0 * c)))


def pixel_wise_entropy(logits: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """The softmax entropy per pixel in bits, over log2 of the class count:
    (N, C, H, W) -> (N, H, W); with `normalize`, min-max normalized over the
    whole tensor."""
    if logits.dim() != 4:
        raise ValueError(f"pixel_wise_entropy takes (N, C, H, W) logits, not {tuple(logits.shape)}")
    p = torch.softmax(logits, dim=1)
    ent = -torch.sum(p * torch.log2(p + 1e-30), dim=1) / math.log2(logits.shape[1])
    if normalize:
        ent = (ent - ent.min()) / (ent.max() - ent.min())
    return ent
