"""Sample scoring for label selection, on NCHW tensors.

Port of the JAX package's `label_selection/scoring.py` (reference
label_selection.py:339-648):
- a sample's score is depth_lambda * depth error + entropy_lambda *
  entropy, the depth error between the student's `disp_0` and the SDE
  teacher's pseudo-depth under the moving-car and ego-car masks (447-487);
- its diversity feature is a pooled depth-decoder activation (u3, u4, the
  bottleneck) or the pseudo-depth; pairwise L_p distances (plus a score bias
  per column) feed the greedy iterative farthest point (574-648).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, kernel_size: int, padding: int) -> torch.Tensor:
    """Binary dilation, (..., H, W): a max over the window, padded with
    -inf as `lax.reduce_window` pads, clipped to [0, 1] (reference
    339-345)."""
    lead = mask.shape[:-2]
    x = mask.reshape(-1, 1, *mask.shape[-2:])
    x = F.max_pool2d(x, kernel_size, stride=1, padding=int(padding))
    return x.reshape(*lead, *x.shape[-2:]).clamp(0.0, 1.0)


def adaptive_pool(x: torch.Tensor, out_hw, mode: str = "avg") -> torch.Tensor:
    """torch's adaptive avg/max pooling of (N, C, H, W): bin i of n over
    length L spans [floor(i L / n), ceil((i + 1) L / n)), the JAX bins."""
    if mode == "avg":
        return F.adaptive_avg_pool2d(x, tuple(out_hw))
    if mode == "max":
        return F.adaptive_max_pool2d(x, tuple(out_hw))
    raise NotImplementedError(mode)


def depth_error_map(disp_pred: torch.Tensor, disp_pseudo: torch.Tensor,
                    error_type: str) -> torch.Tensor:
    """One of the depth-error variants (reference 458-478); (H, W) inputs."""
    if error_type == "abs":
        return torch.abs(disp_pred - disp_pseudo)
    if error_type == "abs_inv_log":
        return torch.abs(torch.log(torch.clamp(1 / disp_pseudo, 0.1, 80))
                         - torch.log(torch.clamp(1 / disp_pred, 0.1, 80)))
    if error_type == "abs_inv":
        return torch.abs(torch.clamp(1 / disp_pseudo, 0.1, 80)
                         - torch.clamp(1 / disp_pred, 0.1, 80))
    if error_type == "sq":
        return (disp_pred - disp_pseudo) ** 2
    if error_type == "abs_rel":
        return torch.abs(disp_pred - disp_pseudo) / (disp_pseudo + 1e-1)
    if error_type == "sq_rel":
        return ((disp_pred - disp_pseudo) ** 2) / (disp_pseudo + 1e-1)
    if error_type == "abs_log":
        return torch.abs(torch.log1p(disp_pred) - torch.log1p(disp_pseudo))
    raise NotImplementedError(error_type)


def masked_depth_error(disp_pred: torch.Tensor, disp_pseudo: torch.Tensor, error_type: str):
    """The error map without moving cars (pseudo-disparity < 0.07, dilated
    by 7x7) and without the rows from int(0.87 H) down (the ego car), and
    its mean (reference 480-487). (H, W) -> (map, 0-dim mean)."""
    m = depth_error_map(disp_pred, disp_pseudo, error_type)
    moving = dilate((disp_pseudo < 0.07).float(), 7, 3)
    m = m * (1.0 - moving)
    h = m.shape[0]
    m = torch.where(torch.arange(h, device=m.device)[:, None] < int(0.87 * h), m, 0.0)
    return m, m.mean()


def extract_depth_features(teacher_outputs: Dict[str, torch.Tensor],
                           pseudo_depth: Optional[torch.Tensor],
                           ifp_args: Dict[str, Any]) -> torch.Tensor:
    """The diversity feature of each sample (reference 399-428):
    (N, C, h, 2h)."""
    m, hh = ifp_args["m"], ifp_args["h"]
    if m == "u3":
        feats = teacher_outputs["upconv_3"]
    elif m == "u4":
        feats = teacher_outputs["upconv_4"]
    elif m == "bn":
        feats = teacher_outputs["bottleneck"]
    elif m == "logdepth":
        feats = torch.log(torch.clamp(1 / pseudo_depth, 0.1, 80))
    elif m == "depth":
        feats = torch.clamp(1 / pseudo_depth, 0.1, 80)
    else:
        raise NotImplementedError(m)
    return adaptive_pool(feats.float(), (hh, 2 * hh), ifp_args.get("pool", "avg"))


def _cdist(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """Pairwise L_p distances of the rows of `a` and `b`. For p = 2 the JAX
    package's |a|^2 + |b|^2 - 2ab, clamped at 0, in f32 (`torch.cdist`
    rounds otherwise, which moves IFP's picks at near ties)."""
    if p == 2:
        aa = torch.sum(a * a, dim=1, keepdim=True)
        bb = torch.sum(b * b, dim=1, keepdim=True)
        return torch.sqrt(torch.clamp(aa + bb.T - 2.0 * (a @ b.T), min=0.0))
    # one row at a time: the (N, N, D) difference would not fit at scale
    return torch.stack([torch.sum(torch.abs(row[None] - b) ** p, dim=-1) ** (1.0 / p)
                        for row in a])


def calc_feature_distance(features: torch.Tensor, bias: Optional[np.ndarray],
                          bias_weight: float, p: int = 2, normalize_features: bool = False,
                          patch_wise: bool = False) -> np.ndarray:
    """The pairwise L_p distance matrix of the samples' pooled features
    (N, C, h, w), plus `bias` per column, with a zero diagonal (reference
    _calc_feature_distance, 574-624). A sample's flattened distance does not
    depend on the layout; `patch_wise` takes per-pixel C vectors (min over
    the other sample's patches, mean over one's own)."""
    feats = torch.as_tensor(features, dtype=torch.float32)
    n, c, h, w = feats.shape
    if normalize_features:
        # per channel, with torch.std_mean's unbiased estimator
        mean = torch.mean(feats, dim=(0, 2, 3), keepdim=True)
        std = torch.std(feats, dim=(0, 2, 3), keepdim=True, correction=1)
        feats = (feats - mean) / std
    if patch_wise:
        px = feats.permute(0, 2, 3, 1).reshape(n * h * w, c)
        d = _cdist(px, px, p).reshape(n, h * w, n, h * w).amin(dim=-1)
        dist = d.permute(0, 2, 1).mean(dim=-1)
    else:
        flat = feats.reshape(n, c * h * w)
        dist = _cdist(flat, flat, p)
    if bias_weight > 0 and bias is not None:
        dist = dist + torch.as_tensor(np.asarray(bias, np.float32), device=dist.device)[None, :]
    dist = dist * (1.0 - torch.eye(n, device=dist.device))
    return dist.cpu().numpy()


def iterative_farthest_point(current_samples: List[int], feature_distances: Dict[str, Any],
                             n_new: int, preselected_samples: Optional[List[int]] = None):
    """Greedy max-min farthest-point selection (reference 627-648)."""
    dist = np.array(feature_distances["distances"], copy=True)
    dist_i_to_img_idx = feature_distances["dist_i_to_img_idx"]
    img_idx_to_dist_i = feature_distances["img_idx_to_dist_i"]
    current = [img_idx_to_dist_i[s] for s in current_samples]
    if preselected_samples is not None:
        pres = {img_idx_to_dist_i[s] for s in preselected_samples}
        ignored = [i for i in range(dist.shape[0]) if i not in pres]
        dist[:, ignored] = 0
    new_samples, distances = [], []
    for _ in range(n_new):
        to_current = dist[current, :]
        min_to_current = np.min(to_current, axis=0)
        new_sample = int(np.argmax(min_to_current))
        if new_sample in current:
            break
        current.append(new_sample)
        new_samples.append(new_sample)
        distances.append(float(min_to_current[new_sample]))
    return [dist_i_to_img_idx[s] for s in new_samples], distances
