"""Self-supervised monodepth photometric loss (NCHW).

Port of the JAX package's `ops/photometric.py`: per scale, the predicted
disparity is upsampled to full resolution, turned into depth, backprojected
and reprojected through the predicted pose (a stereo frame "s" through the
batch's `stereo_T`); each source frame is warped at all scales with one K1
launch (the JAX package's `pred_layout="pack"`). The error is
0.85*SSIM + 0.15*L1, min-reduced over sources with identity-reprojection
automasking (identity errors through K2, plus 1e-5 tie-break noise), plus
edge-aware smoothness weighted by `disparity_smoothness / 2**scale`.

With `fused_pred` the per-scale pred error is the differentiable fused error
(`ops/cuda/reprojection.py::ReprojectionError`: K2 forward, K3 backward), one
launch of each per source frame for all scales, in f32.

Over more than one rank (`parallel/dist.py`) the means are over the global
batch and the tie-break noise is this rank's rows of one draw over it; the
per-image mean disparity of the smoothness term stays per image.

Subgradients at ties are JAX's: |u| has slope +1 at 0, the clip 0.5 at an
exact bound (`ops/image.py`), and the min over sources splits its gradient
evenly between equal values (`amin`; `min(dim).values` would give it all to
one).

For validation: `generate_depth_test_pred`, the pose-free depths of every
scale, and `depth_metrics` (abs_rel, sq_rel, rms, log_rms, a1-a3).

Batch keys: color_{f}_{s} (N, 3, H, W), K_{s} / inv_K_{s} (N, 4, 4), and
stereo_T (N, 4, 4) with a stereo frame.
Output keys read: disp_{s} (N, 1, H/2^s, W/2^s), cam_T_cam_0_{f} (N, 4, 4).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..parallel import dist
from .cuda.reprojection import reprojection_error, reprojection_error_diff
from .geometry import backproject_depth, disp_to_depth, project_3d
from .image import abs_jax, smoothness_loss, ssim_nchw
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
    l1 = abs_jax(target - pred).mean(1, keepdim=True)
    if no_ssim:
        return l1.float()
    ssim_term = ssim_nchw(pred, target).mean(1, keepdim=True)
    return (0.85 * ssim_term + 0.15 * l1).float()


def generate_images_pred(inputs: Dict[str, torch.Tensor], outputs: Dict[str, torch.Tensor], *,
                         scales: Sequence[int], frame_ids: Sequence[Any],
                         min_depth: float, max_depth: float) -> Dict[str, torch.Tensor]:
    """Warp the source frames into the target view at every scale.

    Returns a new dict with `depth_0_{s}` and `color_pred_{f}_{s}`
    (N, 3, H, W) added, and `color_pred_pack_{f}` (N, S, 3, H, W), the K1
    output whose views the `color_pred_{f}_{s}` are. Reference
    loss/monodepth_loss.py:64-102.
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
            T = (inputs["stereo_T"] if frame_id == "s"
                 else outputs[key_of("cam_T_cam", 0, frame_id)])
            frame_grids[frame_id].append(
                project_3d(cam_points, inputs[key_of("K", 0)], T, full_h, full_w))
    for frame_id in frame_ids[1:]:
        grids = torch.stack(frame_grids[frame_id], dim=1)  # (N, S, H, W, 2)
        warped = grid_sample_pack_nchw(inputs[key_of("color", frame_id, 0)].detach(), grids)
        out[key_of("color_pred_pack", frame_id)] = warped
        for si, scale in enumerate(scales):
            out[key_of("color_pred", frame_id, scale)] = warped[:, si]
    return out


def identity_reprojection(inputs: Dict[str, torch.Tensor], *, frame_ids: Sequence[Any],
                          no_ssim: bool = False, avg_reprojection: bool = False,
                          generator: Optional[torch.Generator] = None,
                          tie_break_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The automask's identity-reprojection errors (N, F, H, W), or (N, 1,
    H, W) with `avg_reprojection`, plus the 1e-5 tie-break noise: one
    standard-normal draw shared across scales (as in the JAX package),
    injected as `tie_break_noise` or drawn from `generator`. Scale-independent
    and never differentiated: through K2."""
    target = inputs[key_of("color", 0, 0)]
    identity_losses = torch.cat([
        reprojection_loss_nchw(inputs[key_of("color", f, 0)], target, no_ssim=True)
        if no_ssim else reprojection_error(inputs[key_of("color", f, 0)], target)
        for f in frame_ids[1:]
    ], dim=1)
    if avg_reprojection:
        identity_losses = identity_losses.mean(1, keepdim=True)
    if tie_break_noise is None:  # one draw over the global batch (parallel/dist.py)
        tie_break_noise = dist.rank_draw(
            lambda shape: torch.randn(shape, generator=generator, device=identity_losses.device),
            identity_losses.shape)
    return identity_losses + tie_break_noise * 1e-5


def compute_losses(inputs: Dict[str, torch.Tensor], outputs: Dict[str, torch.Tensor], *,
                   scales: Sequence[int], frame_ids: Sequence[Any],
                   disparity_smoothness: float, no_ssim: bool = False,
                   avg_reprojection: bool = False, disable_automasking: bool = False,
                   fused_pred: bool = False,
                   pred_dtype: Optional[torch.dtype] = None,
                   generator: Optional[torch.Generator] = None,
                   tie_break_noise: Optional[torch.Tensor] = None,
                   identity_losses: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Min-reprojection photometric loss with automasking + smoothness.

    Reference loss/monodepth_loss.py:118-192; returns per-scale losses and
    the total under "loss". The automask's identity errors are
    `identity_losses` or `identity_reprojection` of the batch, whose
    tie-break noise is `tie_break_noise` or drawn from `generator`.

    `fused_pred` (with SSIM on) takes the per-scale pred error through K2/K3
    on the packed warps `color_pred_pack_{f}`, in f32: like the JAX fused
    kernel it ignores `pred_dtype`, which applies to the unfused chain only.
    """
    losses: Dict[str, torch.Tensor] = {}
    total_loss = 0.0
    target = inputs[key_of("color", 0, 0)]

    if not disable_automasking and identity_losses is None:
        identity_losses = identity_reprojection(
            inputs, frame_ids=frame_ids, no_ssim=no_ssim, avg_reprojection=avg_reprojection,
            generator=generator, tie_break_noise=tie_break_noise)

    fused = {}
    if fused_pred and not no_ssim:
        for f in frame_ids[1:]:
            pack = outputs[key_of("color_pred_pack", f)]  # (N, S, 3, H, W)
            n, s = pack.shape[:2]
            err = reprojection_error_diff(pack.reshape(n * s, *pack.shape[2:]).float(),
                                          target.float(), reps=s)
            fused[f] = err.reshape(n, s, *err.shape[2:])

    def pred_loss(f, si, scale):
        if fused:
            return fused[f][:, si:si + 1]
        return reprojection_loss_nchw(outputs[key_of("color_pred", f, scale)], target,
                                      no_ssim, dtype=pred_dtype)

    for si, scale in enumerate(scales):
        disp = outputs[key_of("disp", scale)]
        color = inputs[key_of("color", 0, scale)]
        reproj = torch.cat([pred_loss(f, si, scale) for f in frame_ids[1:]], dim=1)
        if avg_reprojection:
            reproj = reproj.mean(1, keepdim=True)
        combined = reproj if disable_automasking else torch.cat([identity_losses, reproj], 1)
        to_optimise = combined[:, 0] if combined.shape[1] == 1 else combined.amin(1)
        loss = dist.batch_mean(to_optimise)

        mean_disp = disp.mean((2, 3), keepdim=True)
        norm_disp = disp / (mean_disp + 1e-7)
        loss = loss + disparity_smoothness * smoothness_loss(norm_disp, color) / (2**scale)
        total_loss = total_loss + loss
        losses[f"loss/{scale}"] = loss

    losses["loss"] = total_loss / len(scales)
    return losses


def generate_depth_test_pred(outputs: Dict[str, torch.Tensor], *, scales: Sequence[int],
                             test_min_depth: float, test_max_depth: float
                             ) -> Dict[str, torch.Tensor]:
    """Pose-free depth prediction for eval (reference
    loss/monodepth_loss.py:54-62): a new dict with `depth_0_{s}`, each
    scale's disparity resized to `disp_0`'s size and turned into depth."""
    out = dict(outputs)
    h, w = outputs[key_of("disp", 0)].shape[2:]
    for scale in scales:
        disp = resize_bilinear(outputs[key_of("disp", scale)], (h, w), align_corners=False)
        _, out[key_of("depth", 0, scale)] = disp_to_depth(disp, test_min_depth, test_max_depth)
    return out


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The standard monodepth metrics over the pixels where `mask` is set:
    abs_rel, sq_rel, rms, log_rms and the shares a1-a3 of pixels whose ratio
    to the truth is below 1.25, 1.25^2 and 1.25^3."""
    mask = mask.float()
    n = dist.batch_sum(mask).clamp_min(1.0)

    def mean(x):
        return dist.batch_sum(x * mask) / n

    thresh = torch.maximum(pred / (gt + 1e-12), gt / (pred + 1e-12))
    return {
        "abs_rel": mean((pred - gt).abs() / (gt + 1e-12)),
        "sq_rel": mean((pred - gt) ** 2 / (gt + 1e-12)),
        "rms": torch.sqrt(mean((pred - gt) ** 2)),
        "log_rms": torch.sqrt(mean((torch.log(pred + 1e-12) - torch.log(gt + 1e-12)) ** 2)),
        "a1": mean((thresh < 1.25).float()),
        "a2": mean((thresh < 1.25**2).float()),
        "a3": mean((thresh < 1.25**3).float()),
    }
