"""The supervised SDE train step: CE + min-reprojection photometric loss.

Port of the supervised branch of the JAX package's
`engine/train_steps.py::make_train_step` (forward at lines 325-330, CE at
345-349, update at 418-421): one train-mode forward (BatchNorm running
statistics update in it), the photometric loss through K1/K2, the CE loss,
one backward and one optimizer step. Losses come back as 0-dim tensors, so
the step itself never waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .. import not_ported
from ..ops import photometric
from ..ops.losses import cross_entropy2d

_PHOTOMETRIC_DTYPES = {None: None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The fields of the JAX `StepConfig` that the supervised step reads."""

    monodepth_lambda: float = 0.0
    segmentation_lambda: float = 1.0
    frame_ids: Tuple[Any, ...] = (0, -1, 1)
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 100.0
    disparity_smoothness: float = 1e-3
    no_ssim: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    # SSIM/L1 chain compute dtype of the gradient path (bf16 in the sde step)
    photometric_dtype: Optional[torch.dtype] = None


def train_step(model: torch.nn.Module, optimizer, batch: Dict[str, torch.Tensor],
               cfg: StepConfig, generator: Optional[torch.Generator] = None,
               tie_break_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One supervised step on `batch` (NCHW); updates `model` in place.

    The photometric tie-break noise comes from `generator`, or is injected as
    `tie_break_noise` (see ops/photometric.py::compute_losses).
    """
    model.train()
    outputs = model(batch)
    zero = torch.zeros((), device=batch["lbl"].device)
    mono_loss = zero
    if cfg.monodepth_lambda > 0:
        outputs = photometric.generate_images_pred(
            batch, outputs, scales=cfg.scales, frame_ids=cfg.frame_ids,
            min_depth=cfg.min_depth, max_depth=cfg.max_depth)
        losses = photometric.compute_losses(
            batch, outputs, scales=cfg.scales, frame_ids=cfg.frame_ids,
            disparity_smoothness=cfg.disparity_smoothness, no_ssim=cfg.no_ssim,
            avg_reprojection=cfg.avg_reprojection,
            disable_automasking=cfg.disable_automasking, pred_dtype=cfg.photometric_dtype,
            generator=generator, tie_break_noise=tie_break_noise)
        mono_loss = cfg.monodepth_lambda * losses["loss"]
    seg_loss = zero
    if cfg.segmentation_lambda > 0:
        seg_loss = cross_entropy2d(outputs["semantics"], batch["lbl"]) * cfg.segmentation_lambda
    total = seg_loss + mono_loss

    optimizer.zero_grad()
    total.backward()
    optimizer.step()
    return {"segmentation_loss": seg_loss.detach(), "mono_loss": mono_loss.detach(),
            "total_loss": total.detach()}


def step_config_from_cfg(cfg: Dict[str, Any]) -> StepConfig:
    """StepConfig from the experiment config (the JAX `step_config_from_cfg`
    schema); raises for what the supervised slice does not run."""
    t = cfg.get("training", {})
    mono = dict(cfg.get("monodepth_options", {}))
    mono.update(t.get("monodepth_loss") or {})
    if t.get("unlabeled_segmentation"):
        raise not_ported("training.unlabeled_segmentation (mean teacher, DepthMix)",
                         "exp-210")
    if t.get("amp", False):
        raise not_ported("training.amp (bf16 model)", "amp/bf16 model")
    if t.get("fused_reprojection", False):
        raise not_ported("training.fused_reprojection (kernel K3)", "K3")
    for key, item in (("pseudo_depth_lambda", "exp-210"), ("feat_dist_lambda", "exp-210")):
        if t.get(key, 0.0):
            raise not_ported(f"training.{key}", item)
    if t.get("pred_layout", "pack") != "pack" or t.get("remat_photometric", False):
        raise not_ported("training.pred_layout other than 'pack' / remat_photometric",
                         "amp/bf16 model")
    dtype_name = t.get("photometric_dtype")
    if dtype_name not in _PHOTOMETRIC_DTYPES:
        raise ValueError(f"training.photometric_dtype {dtype_name!r}: bfloat16 or null")
    return StepConfig(
        monodepth_lambda=t.get("monodepth_lambda", 0.0),
        segmentation_lambda=t.get("segmentation_lambda", 1.0),
        frame_ids=tuple(mono.get("frame_ids", (0, -1, 1))),
        scales=tuple(range(mono.get("num_scales", 4))),
        min_depth=mono.get("min_depth", 0.1),
        max_depth=mono.get("max_depth", 100.0),
        disparity_smoothness=mono.get("disparity_smoothness", 1e-3),
        no_ssim=mono.get("no_ssim", False),
        avg_reprojection=mono.get("avg_reprojection", False),
        disable_automasking=mono.get("disable_automasking", False),
        photometric_dtype=_PHOTOMETRIC_DTYPES[dtype_name],
    )
