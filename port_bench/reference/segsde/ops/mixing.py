"""DepthMix and ClassMix masks and batch mixing (NCHW).

Port of the JAX package's `ops/mixing.py` (reference train.py:572-642,
loader/transformmasks.py, loader/transformsgpu.py:33-47): each sample is
mixed with the next one in the batch (roll by 1), and the depthcomp mask
compares each sample's disparity with that partner's. The ClassMix mask
selects a random half of the classes present in each (pseudo-)label; the
depth-histogram thresholds come from a per-sample 100-bin histogram of
log(1 + depth). Their random draws can be passed in. Over more than one
rank the partner of a rank's last sample is the next rank's first
(`parallel/dist.py::roll_next`), and the per-sample draws are this rank's
rows of one draw over the global batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import dist
from .image import uniform


def mix(mask: torch.Tensor, data: Optional[torch.Tensor] = None,
        target: Optional[torch.Tensor] = None):
    """Blend each sample with the next one under `mask` (N, H, W).

    `data` and `target` are (N, C, H, W); returns (mixed data, mixed target),
    None where the input was None.
    """
    def blend(x):
        m = mask[:, None].to(x.dtype)
        return m * x + (1.0 - m) * dist.roll_next(x)

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
    other = dist.roll_next(disps)
    fg = (disps >= other - margin).float()
    if isinstance(foreground_threshold, (tuple, list)):
        lo, hi = foreground_threshold
        if threshold_draw is None:
            threshold_draw = uniform(generator, disps.device, lo=lo, hi=hi)
        ft = torch.as_tensor(threshold_draw, dtype=torch.float32, device=disps.device)
    else:
        ft = torch.as_tensor(foreground_threshold, dtype=torch.float32, device=disps.device)
    return fg * (disps >= ft).float()


def generate_class_mask(argmax_label: torch.Tensor, num_classes: int,
                        ignore_index: int = 250, scores: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """ClassMix mask (N, H, W) float: 1 where the pixel's class is among a
    random half of the classes present in its sample's label (N, H, W) int.

    Each class gets a U(0, 1) score (`scores` (N, C), or drawn from
    `generator`); among the present classes the floor(n_present / 2) with the
    lowest scores are selected (a stable sort, absent classes last).
    """
    n = argmax_label.shape[0]
    label = argmax_label.reshape(n, -1).long()
    in_range = (label >= 0) & (label < num_classes)
    present = torch.zeros((n, num_classes + 1), dtype=torch.bool, device=label.device)
    present.scatter_(1, torch.where(in_range, label, num_classes), True)
    present = present[:, :num_classes]
    n_present = present.sum(1)
    k = (n_present - n_present % 2) // 2
    if scores is None:
        scores = dist.rank_draw(lambda shape: uniform(generator, label.device, shape),
                                (n, num_classes))
    scores = torch.where(present, scores.to(label.device, torch.float32), float("inf"))
    ranks = torch.argsort(torch.argsort(scores, dim=1, stable=True), dim=1, stable=True)
    selected = ranks < k[:, None]
    sel = torch.gather(selected, 1, label.clamp(0, num_classes - 1))
    sel = sel & in_range & (label != ignore_index)
    return sel.reshape(argmax_label.shape).float()


def depthhist_thresholds(depth: torch.Tensor, u: Optional[torch.Tensor] = None,
                         bins: int = 100,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample random depth threshold (N,) from the histogram of
    log(1 + depth), `depth` (N, H, W).

    100 bins over each sample's [min, max]; the upper end is the first bin
    edge from the top (the topmost bin skipped) whose bin has density > 1.5,
    the lower end the first edge where the cdf exceeds 0.4 (edge 0 where none
    does); the threshold is U(lower, upper) in log space, `u` (N,) U(0, 1)
    or drawn from `generator`, mapped back through expm1.
    """
    n = depth.shape[0]
    logd = torch.log1p(depth.reshape(n, -1).float())
    dmin = logd.amin(1, keepdim=True)
    dmax = logd.amax(1, keepdim=True)
    width = (dmax - dmin) / bins + 1e-12
    edges = dmin + width * torch.arange(bins + 1, dtype=torch.float32, device=depth.device)
    bin_idx = ((logd - dmin) / width).to(torch.int32).clamp(0, bins - 1)
    offsets = torch.arange(n, device=depth.device)[:, None] * bins
    counts = torch.bincount((bin_idx + offsets).reshape(-1),
                            minlength=n * bins).reshape(n, bins).float()
    density = counts / (counts.sum(1, keepdim=True) * width)

    def first_index(cond):  # the first True along dim 1, or 0
        return cond.to(torch.int32).argmax(1, keepdim=True)

    # the flipped histogram without its top bin pairs density[bins-2-i] with
    # the upper edge edge[bins-1-i]
    rev_d = density.flip(1)[:, 1:]
    rev_e = edges.flip(1)[:, 1:-1]
    max_e = torch.gather(rev_e, 1, first_index(rev_d > 1.5))[:, 0]
    cdf = torch.cumsum(density, 1) / density.sum(1, keepdim=True)
    min_e = torch.gather(edges, 1, first_index(cdf > 0.4))[:, 0]
    if u is None:
        u = dist.rank_draw(lambda shape: uniform(generator, depth.device, shape), (n,))
    thr_log = u.to(depth.device, torch.float32) * (max_e - min_e) + min_e
    return torch.expm1(thr_log)
