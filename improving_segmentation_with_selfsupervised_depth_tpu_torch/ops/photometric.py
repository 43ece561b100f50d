"""Self-supervised monodepth photometric loss (NCHW).

Port of the JAX package's `ops/photometric.py` in its `pred_layout="pack"`
form: per scale, the predicted disparity is upsampled to full resolution,
turned into depth, backprojected and reprojected through the predicted pose;
each source frame is warped at all scales with one K1 launch. The error is
0.85*SSIM + 0.15*L1, min-reduced over sources with identity-reprojection
automasking (identity errors through K2, plus 1e-5 tie-break noise), plus
edge-aware smoothness weighted by `disparity_smoothness / 2**scale`.

Batch keys: color_{f}_{s} (N, 3, H, W), K_{s} / inv_K_{s} (N, 4, 4).
Output keys read: disp_{s} (N, 1, H/2^s, W/2^s), cam_T_cam_0_{f} (N, 4, 4).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from .cuda.reprojection import reprojection_error
from .geometry import backproject_depth, disp_to_depth, project_3d
from .image import smoothness_loss, ssim_nchw
from .resample import grid_sample_pack_nchw
from .resize import resize_bilinear


def key_of(name: str, *idx) -> str:
    return "_".join([name, *[str(i) for i in idx]])


def reprojection_loss_nchw(pred: torch.Tensor, target: torch.Tensor, no_ssim: bool = False,
                           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-pixel reprojection error (N, 1, H, W) f32 (reference
    monodepth_loss.py:104-116). `dtype` (e.g. bfloat16) computes the SSIM/L1
    chain in reduced precision, as the reference does under amp."""
    if dtype is not None:
        pred = pred.to(dtype)
        target = target.to(dtype)
    l1 = (target - pred).abs().mean(1, keepdim=True)
    if no_ssim:
        return l1.float()
    ssim_term = ssim_nchw(pred, target).mean(1, keepdim=True)
    return (0.85 * ssim_term + 0.15 * l1).float()


def generate_images_pred(inputs: Dict[str, torch.Tensor], outputs: Dict[str, torch.Tensor], *,
                         scales: Sequence[int], frame_ids: Sequence[Any],
                         min_depth: float, max_depth: float) -> Dict[str, torch.Tensor]:
    """Warp the source frames into the target view at every scale.

    Returns a new dict with `depth_0_{s}` and `color_pred_{f}_{s}`
    (N, 3, H, W) added. Reference loss/monodepth_loss.py:64-102.
    """
    out = dict(outputs)
    full_h, full_w = inputs[key_of("color", 0, 0)].shape[2:]
    frame_grids = {f: [] for f in frame_ids[1:]}
    for scale in scales:
        disp = resize_bilinear(outputs[key_of("disp", scale)], (full_h, full_w))
        _, depth = disp_to_depth(disp, min_depth, max_depth)
        out[key_of("depth", 0, scale)] = depth
        cam_points = backproject_depth(depth, inputs[key_of("inv_K", 0)])
        for frame_id in frame_ids[1:]:
            T = outputs[key_of("cam_T_cam", 0, frame_id)]
            frame_grids[frame_id].append(
                project_3d(cam_points, inputs[key_of("K", 0)], T, full_h, full_w))
    for frame_id in frame_ids[1:]:
        grids = torch.stack(frame_grids[frame_id], dim=1)  # (N, S, H, W, 2)
        warped = grid_sample_pack_nchw(inputs[key_of("color", frame_id, 0)].detach(), grids)
        for si, scale in enumerate(scales):
            out[key_of("color_pred", frame_id, scale)] = warped[:, si]
    return out


def compute_losses(inputs: Dict[str, torch.Tensor], outputs: Dict[str, torch.Tensor], *,
                   scales: Sequence[int], frame_ids: Sequence[Any],
                   disparity_smoothness: float, no_ssim: bool = False,
                   avg_reprojection: bool = False, disable_automasking: bool = False,
                   pred_dtype: Optional[torch.dtype] = None,
                   generator: Optional[torch.Generator] = None,
                   tie_break_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Min-reprojection photometric loss with automasking + smoothness.

    Reference loss/monodepth_loss.py:118-192; returns per-scale losses and
    the total under "loss". The identity-reprojection tie-break noise is one
    standard-normal draw shared across scales (as in the JAX package), scaled
    by 1e-5: `tie_break_noise` injects the draw, shaped like the identity
    errors (N, F, H, W); otherwise it is drawn from `generator`.
    """
    losses: Dict[str, torch.Tensor] = {}
    total_loss = 0.0
    target = inputs[key_of("color", 0, 0)]

    identity_losses = None
    if not disable_automasking:
        # scale-independent and never differentiated: through K2
        identity_losses = torch.cat([
            reprojection_loss_nchw(inputs[key_of("color", f, 0)], target, no_ssim=True)
            if no_ssim else reprojection_error(inputs[key_of("color", f, 0)], target)
            for f in frame_ids[1:]
        ], dim=1)
        if avg_reprojection:
            identity_losses = identity_losses.mean(1, keepdim=True)
        if tie_break_noise is None:
            tie_break_noise = torch.randn(identity_losses.shape, generator=generator,
                                          device=identity_losses.device)
        identity_losses = identity_losses + tie_break_noise * 1e-5

    for scale in scales:
        disp = outputs[key_of("disp", scale)]
        color = inputs[key_of("color", 0, scale)]
        reproj = torch.cat([
            reprojection_loss_nchw(outputs[key_of("color_pred", f, scale)], target, no_ssim,
                                   dtype=pred_dtype)
            for f in frame_ids[1:]
        ], dim=1)
        if avg_reprojection:
            reproj = reproj.mean(1, keepdim=True)
        combined = reproj if disable_automasking else torch.cat([identity_losses, reproj], 1)
        to_optimise = combined[:, 0] if combined.shape[1] == 1 else combined.min(1).values
        loss = to_optimise.mean()

        mean_disp = disp.mean((2, 3), keepdim=True)
        norm_disp = disp / (mean_disp + 1e-7)
        loss = loss + disparity_smoothness * smoothness_loss(norm_disp, color) / (2**scale)
        total_loss = total_loss + loss
        losses[f"loss/{scale}"] = loss

    losses["loss"] = total_loss / len(scales)
    return losses
