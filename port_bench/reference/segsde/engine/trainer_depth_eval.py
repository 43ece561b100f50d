"""Validation depth metrics (abs_rel, sq_rel, rms, log_rms, a1-a3).

Port of the JAX package's `engine/trainer_depth_eval.py`. The ground truth
is, in this order:
  depth_gt      a metric depth map (N, 1, H, W); pixels > 0 are valid, and
                it is clipped to [test_min_depth, test_max_depth];
  pseudo_depth  the offline depth teacher's disparity, turned into depth by
                the same `disp_to_depth` as the prediction; the bottom 10%
                of rows (the own car's hood) are left out, as in the
                pseudo-depth loss.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.geometry import disp_to_depth
from ..ops.photometric import depth_metrics


def eval_depth_metrics(cfg, batch: Dict[str, Any], outputs: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """{"depth/<name>": 0-dim tensor}, or {} when the batch has no ground truth."""
    disp0 = outputs["disp_0"].float()
    _, pred_depth = disp_to_depth(disp0, cfg.test_min_depth, cfg.test_max_depth)
    if "depth_gt" in batch:
        gt = batch["depth_gt"].float()
        mask = gt > 0
        gt = gt.clamp(cfg.test_min_depth, cfg.test_max_depth)
    elif "pseudo_depth" in batch:
        _, gt = disp_to_depth(batch["pseudo_depth"].float(), cfg.test_min_depth,
                              cfg.test_max_depth)
        h = disp0.shape[2]
        rows = torch.arange(h, device=disp0.device).reshape(1, 1, h, 1)
        mask = (rows < int(h * 0.9)).expand_as(disp0)
    else:
        return {}
    return {f"depth/{k}": v for k, v in depth_metrics(pred_depth, gt, mask).items()}
