"""The train step (supervised SDE, mean-teacher DepthMix) and the eval step.

Port of the JAX package's `engine/train_steps.py::make_train_step` for these
configurations:
- supervised (the `sde` step): one train-mode forward (BatchNorm running
  statistics update in it), the photometric loss through K1/K2 (and K3 with
  `fused_pred_loss`), the CE loss, one backward and one optimizer step;
  SDE pretraining is this step with `segmentation_lambda` 0 and, in phase 2
  (dec6), the feature-distance loss `feat_dist_lambda * ||enc - imnet||_2`
  added to the photometric one;
- semi-supervised with an EMA teacher and online-depth DepthMix (the `s212`
  step, JAX :233-435): the teacher's soft pseudo-labels on the unlabeled
  batch, the labeled forward with its photometric and CE losses, the
  unlabeled forward with its photometric loss, whose detached per-sample
  min-max-normalized `disp_0` gives the DepthMix depths, the depthcomp mask,
  the mixed and strongly augmented images, the mixed forward without pose and
  its confidence-weighted pseudo-label loss; then one backward, the optimizer
  step and the EMA update.

With `fuse_unlabeled_forward` two of the semi-supervised step's student
forwards become one forward of the two batches concatenated (2N), gated as in
the JAX package (JAX train_steps.py:255-330): with online DepthMix and the
photometric loss, labeled + unlabeled, with one photometric pass over 2N
whose loss stands for both halves' (`mono_loss` = `mono_loss_u` = lambda x
the 2N loss: each per-scale loss is a batch mean); with offline DepthMix and
no photometric loss, labeled + mixed, the mix mask, strong transform and
mixed soft labels made first, and the 2N forward without pose (as in JAX,
the pose network's BatchNorm then sees no batch: the labeled half takes no
pose either). The 2N batch holds the keys both batches have with equal
trailing shapes (JAX's filter). Train-mode BatchNorm sees joint 2N
statistics, and dropout draws one set of masks over 2N. With the knob set
and neither gate open the step runs unfused, as in JAX.

`training.pred_layout` is accepted with the JAX package's values, and both
run the one packed warp (`ops/photometric.py`): the port's tensors are NCHW
in either, and the per-(frame, scale) calls of JAX's "nhwc" compute the same
losses. `remat_photometric` checkpoints the photometric loss chain
(`torch.utils.checkpoint`): the warps stay saved, so K1 never runs in the
backward, and the automask's identity errors and their tie-break draw are
taken before the checkpoint, so K2 does not run again for them.

The semi-supervised step also runs offline DepthMix (`depthmix_online_depth`
off, the exp-210 `s210` step): the mask's depths are the unlabeled batch's
`pseudo_depth`, and the model may have no depth decoder and no pose network.
Besides DepthMix's depthcomp and depth masks it takes ClassMix (`class`) and
depth-histogram (`depthhist`) masks. The berhu pseudo-depth loss on `disp_0`
(`pseudo_depth_lambda`) skips the bottom 10% of rows, and
`backward_first_pseudo_label` adds the teacher's pseudo-label loss on the
unlabeled forward. `freeze_backbone_bn` is the model's
(`models/joint.py`): its encoder's BatchNorm stays on running statistics in
the student and the teacher alike.

`eval_step` is the validation step (JAX `make_eval_step`): an eval-mode
forward without gradient, the CE loss and the confusion matrix, the
photometric loss through K1 and K2 (`fused_pred`) or, without a pose
network, the pose-free depth forward, the pseudo-depth loss with a depth
teacher, and the depth metrics.

Losses come back as 0-dim tensors, so the step itself never waits for the
device; with `debug_images` the semi-supervised step also returns its mixed
images (N, 3, H, W), mix mask and pseudo-label (N, H, W) and the mask's
depths (N, H, W, where it has them) under `debug/*`, detached, on the
device. JAX's random keys become injectable draws (`StepDraws`): what is
not injected is drawn from the step's `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import photometric
from ..ops.image import color_jitter, gaussian_blur, uniform
from ..ops.losses import IGNORE_INDEX, berhu, cross_entropy2d
from ..ops.metrics import confusion_matrix
from ..ops.mixing import (
    depthhist_thresholds,
    generate_class_mask,
    generate_depth_mask,
    generate_depthcomp_mask,
    mix,
)
from ..ops.photometric import key_of
from ..ops.resize import resize_bilinear
from .state import ema_model_names, update_ema
from .trainer_depth_eval import eval_depth_metrics

_PHOTOMETRIC_DTYPES = {None: None, "bfloat16": torch.bfloat16}
_PRED_LAYOUTS = ("pack", "nhwc")  # the JAX package's; both run the packed warp
EMA_ALPHA = 0.99  # the teacher's EMA rate (JAX StepConfig.ema_alpha)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The fields of the JAX `StepConfig` that the ported steps read."""

    monodepth_lambda: float = 0.0
    feat_dist_lambda: float = 0.0
    pseudo_depth_lambda: float = 0.0
    segmentation_lambda: float = 1.0
    pseudo_depth_loss_log: bool = False
    frame_ids: Tuple[Any, ...] = (0, -1, 1)
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 100.0
    test_min_depth: float = 0.1
    test_max_depth: float = 100.0
    disparity_smoothness: float = 1e-3
    no_ssim: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    # SSIM/L1 chain compute dtype of the unfused gradient path (bf16 in the
    # sde step and under training.amp)
    photometric_dtype: Optional[torch.dtype] = None
    # the per-scale pred error through K2 forward and K3 backward
    # (training.fused_reprojection)
    fused_pred_loss: bool = False
    # recompute the photometric loss chain in the backward, not the warps
    # (training.remat_photometric)
    remat_photometric: bool = False
    # the model's depth decoder and pose network (the eval step's branches)
    disable_monodepth: bool = False
    disable_pose: bool = False
    # `data.depth_teacher` is set: the eval step reports the pseudo-depth loss
    has_depth_teacher: bool = False
    num_classes: int = 19
    # semi-supervised (training.unlabeled_segmentation)
    unlabeled: bool = False
    consistency_weight: float = 1.0
    mix_mask: Optional[str] = None
    unlabeled_color_jitter: bool = False
    unlabeled_blur: bool = False
    mix_use_gt: bool = False
    depthcomp_margin: float = 0.0
    depthcomp_foreground_threshold: Any = 0.0
    depthmix_online_depth: bool = False
    backward_first_pseudo_label: bool = False
    # one 2N student forward for two of the semi-supervised step's forwards
    # (training.fuse_unlabeled_forward; the module docstring)
    fuse_unlabeled_forward: bool = False
    use_ema: bool = False
    ema_names: Optional[Tuple[str, ...]] = None
    # the semi-supervised step also returns its mixed images, mix mask,
    # pseudo-label and mixing depths under `debug/*` (the loop's
    # class_mix_debug panels; reference train.py:726-744)
    debug_images: bool = False


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """Random draws of the semi-supervised branch, for tests that replay
    another framework's numbers; a field left None is drawn from the step's
    generator.

    tie_break_noise_u: the unlabeled photometric pass's tie-break draw,
      (N, F, H, W) standard normal (the labeled pass's is the step's
      `tie_break_noise`).
    tie_break_noise_fused: the fused photometric pass's draw over the 2N
      batch, (2N, F, H, W), in place of both (`fuse_unlabeled_forward`).
    jitter: (brightness, contrast, saturation, hue) of `color_jitter`.
    jitter_apply, blur_apply: the U(0, 1) draws that decide whether jitter
      (> 0.2) and blur (> 0.5) apply.
    blur_sigma: the blur's sigma.
    mix_threshold: the depthcomp foreground threshold draw (when it is a
      range), or the per-sample (N, 1, 1) thresholds of the depth mask.
    class_scores: the ClassMix mask's (N, C) U(0, 1) class scores.
    depthhist_u: the depth-histogram mask's (N,) U(0, 1) draws.
    """

    tie_break_noise_u: Optional[torch.Tensor] = None
    tie_break_noise_fused: Optional[torch.Tensor] = None
    jitter: Optional[Sequence[float]] = None
    jitter_apply: Optional[float] = None
    blur_sigma: Optional[float] = None
    blur_apply: Optional[float] = None
    mix_threshold: Any = None
    class_scores: Optional[torch.Tensor] = None
    depthhist_u: Optional[torch.Tensor] = None


def _monodepth_loss(cfg: StepConfig, batch, outputs, generator, tie_break_noise):
    outputs = photometric.generate_images_pred(
        batch, outputs, scales=cfg.scales, frame_ids=cfg.frame_ids,
        min_depth=cfg.min_depth, max_depth=cfg.max_depth)
    kw = dict(scales=cfg.scales, frame_ids=cfg.frame_ids,
              disparity_smoothness=cfg.disparity_smoothness, no_ssim=cfg.no_ssim,
              avg_reprojection=cfg.avg_reprojection,
              disable_automasking=cfg.disable_automasking, fused_pred=cfg.fused_pred_loss,
              pred_dtype=cfg.photometric_dtype)
    if cfg.remat_photometric:
        identity = None
        if not cfg.disable_automasking:
            identity = photometric.identity_reprojection(
                batch, frame_ids=cfg.frame_ids, no_ssim=cfg.no_ssim,
                avg_reprojection=cfg.avg_reprojection, generator=generator,
                tie_break_noise=tie_break_noise)
        losses = checkpoint(lambda out: photometric.compute_losses(
            batch, out, identity_losses=identity, **kw), outputs, use_reentrant=False)
    else:
        losses = photometric.compute_losses(batch, outputs, generator=generator,
                                            tie_break_noise=tie_break_noise, **kw)
    return cfg.monodepth_lambda * losses["loss"]


def _concat_batches(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    """The 2N batch of the fused forward: the keys of `a` that `b` holds with
    the same trailing shape (JAX train_steps.py:296-299)."""
    return {k: torch.cat([v, b[k]]) for k, v in a.items()
            if k in b and b[k].shape[1:] == v.shape[1:]}


def _split_outputs(outputs: Dict[str, torch.Tensor], n: int):
    return ({k: v[:n] for k, v in outputs.items()}, {k: v[n:] for k, v in outputs.items()})


def _feat_dist(outputs) -> torch.Tensor:
    """The L2 distance of the backbone's last feature from the ImageNet
    encoder's, in f32 (JAX train_steps.py:331-335)."""
    d = outputs["encoder_features"].float() - outputs["imnet_features"].float()
    return torch.sqrt(torch.sum(d * d))


def _pseudo_depth_loss(cfg: StepConfig, disp0: torch.Tensor, pseudo_depth: torch.Tensor):
    """berhu of `disp_0` against the offline pseudo-depth (N, 1, H, W), the
    bottom 10% of rows (the own car's hood) masked out (reference
    train.py:491-493)."""
    h = disp0.shape[2]
    rows = torch.arange(h, device=disp0.device).reshape(1, 1, h, 1)
    mask = (rows < int(h * 0.9)).float().expand_as(disp0)
    return berhu(disp0, pseudo_depth, mask, apply_log=cfg.pseudo_depth_loss_log)


def _segmentation_loss(cfg: StepConfig, outputs, labels):
    seg_loss = cross_entropy2d(outputs["semantics"], labels)
    if "intermediate_semantics" in outputs:
        seg_loss = (seg_loss + cross_entropy2d(outputs["intermediate_semantics"], labels)) / 2.0
    return seg_loss * cfg.segmentation_lambda


def pseudo_label_loss(cfg: StepConfig, teacher_softmax: torch.Tensor,
                      student_logits: torch.Tensor):
    """Confidence-weighted CE on teacher soft pseudo-labels (N, C, H, W).

    Reference train.py:644-651: pixels where the teacher max-prob is 0 are
    ignored; the batch is weighted by the fraction of pixels with max-prob
    >= 0.968. Returns (loss, pseudo-label).
    """
    max_probs = teacher_softmax.amax(1)
    pseudo_label = torch.where(max_probs == 0, IGNORE_INDEX, teacher_softmax.argmax(1))
    unlabeled_weight = (max_probs >= 0.968).float().mean()
    pixel_weights = unlabeled_weight * torch.ones_like(max_probs)
    loss = cfg.consistency_weight * cross_entropy2d(student_logits, pseudo_label,
                                                    pixel_weights=pixel_weights)
    return loss, pseudo_label


def generate_mix_mask(cfg: StepConfig, argmax_u_w: torch.Tensor, depths,
                      draws: StepDraws, generator=None) -> torch.Tensor:
    """The mix mask (reference train.py:572-642); `depths` (N, H, W) or None."""
    n, h, w = argmax_u_w.shape
    if cfg.mix_mask == "depthcomp":
        return generate_depthcomp_mask(depths, cfg.depthcomp_margin,
                                       cfg.depthcomp_foreground_threshold,
                                       threshold_draw=draws.mix_threshold,
                                       generator=generator)
    if cfg.mix_mask == "depth":
        thr = draws.mix_threshold
        if thr is None:
            thr = uniform(generator, depths.device, (n, 1, 1), lo=0.1, hi=0.4)
        return generate_depth_mask(depths, torch.as_tensor(thr, device=depths.device))
    if cfg.mix_mask == "class":
        return generate_class_mask(argmax_u_w, cfg.num_classes, IGNORE_INDEX,
                                   scores=draws.class_scores, generator=generator)
    if cfg.mix_mask == "depthhist":
        thr = depthhist_thresholds(depths, u=draws.depthhist_u, generator=generator)
        return generate_depth_mask(depths, thr.reshape(n, 1, 1))
    if cfg.mix_mask is None:
        return torch.ones((n, h, w), device=argmax_u_w.device)
    raise NotImplementedError(f"Unknown mix_mask {cfg.mix_mask}")


def strong_transform(cfg: StepConfig, mask, data, draws: StepDraws, generator=None):
    """mix -> color jitter -> gaussian blur (reference train.py:654-659)."""
    data, _ = mix(mask, data)
    if cfg.unlabeled_color_jitter:
        apply = draws.jitter_apply
        if apply is None:
            apply = uniform(generator, data.device)
        data = color_jitter(data, s=0.25, factors=draws.jitter, apply_draw=apply,
                            generator=generator)
    if cfg.unlabeled_blur:
        apply = draws.blur_apply
        if apply is None:
            apply = uniform(generator, data.device)
        data = gaussian_blur(data, sigma=draws.blur_sigma, apply_draw=apply,
                             generator=generator)
    return data


def train_step(model: torch.nn.Module, optimizer, batch: Dict[str, torch.Tensor],
               cfg: StepConfig, generator: Optional[torch.Generator] = None,
               tie_break_noise: Optional[torch.Tensor] = None, *,
               unlabeled_batch: Optional[Dict[str, torch.Tensor]] = None,
               teacher: Optional[torch.nn.Module] = None,
               draws: StepDraws = StepDraws()) -> Dict[str, torch.Tensor]:
    """One step on `batch` (NCHW); updates `model` (and `teacher`) in place.

    The labeled photometric pass's tie-break noise is `tie_break_noise` or
    is drawn from `generator` (see ops/photometric.py::compute_losses); the
    semi-supervised branch, on with `cfg.unlabeled` and `cfg.use_ema`, needs
    `unlabeled_batch` and `teacher` and takes its draws from `draws`.
    `cfg.unlabeled` without `cfg.use_ema` is the supervised step, the
    unlabeled batch unused, as in the JAX package.
    """
    semi = cfg.unlabeled and cfg.use_ema
    if semi and (unlabeled_batch is None or teacher is None):
        raise ValueError("the semi-supervised step needs unlabeled_batch and teacher")
    model.train()

    # teacher forward: train-mode BatchNorm on batch statistics, like the
    # reference teacher (train.py:444-445); no gradient
    teacher_softmax = argmax_u_w = None
    if semi:
        teacher.train()
        with torch.no_grad():
            t_out = teacher(unlabeled_batch, use_pose=False)
            teacher_softmax = torch.softmax(t_out["semantics"].float(), dim=1)
            if cfg.mix_use_gt:
                is_lab = unlabeled_batch["is_labeled"].reshape(-1, 1, 1, 1).bool()
                teacher_softmax = torch.where(is_lab, unlabeled_batch["onehot_lbl"],
                                              teacher_softmax)
            argmax_u_w = teacher_softmax.argmax(1)

    # the fused forward's two modes (JAX train_steps.py:255-285)
    fused = (cfg.fuse_unlabeled_forward and semi and cfg.depthmix_online_depth
             and cfg.monodepth_lambda > 0)
    fused_mixed = (cfg.fuse_unlabeled_forward and semi and not cfg.depthmix_online_depth
                   and cfg.monodepth_lambda == 0)
    image_key = key_of("color_aug", 0, 0)
    n_lab = batch[image_key].shape[0]
    if fused and unlabeled_batch[image_key].shape[0] != n_lab:
        raise ValueError("fuse_unlabeled_forward requires equal labeled/unlabeled batch "
                         "sizes (the photometric batch-mean split is only exact then)")
    pre_mix = None
    if fused_mixed:
        # parameter-free here (offline pseudo-depth and the teacher's
        # argmax): the mixed batch is made before the student forward
        depths = (unlabeled_batch["pseudo_depth"][:, 0] if "pseudo_depth" in unlabeled_batch
                  else None)
        with torch.no_grad():
            mix_mask = generate_mix_mask(cfg, argmax_u_w, depths, draws, generator)
            mixed_imgs = strong_transform(cfg, mix_mask, unlabeled_batch[image_key], draws,
                                          generator)
            mixed_softmax, _ = mix(mix_mask, teacher_softmax)
        pre_mix = (depths, mix_mask, mixed_imgs, mixed_softmax)

    zero = torch.zeros((), device=batch[image_key].device)
    mono_loss = mono_loss_u = feat_dist_loss = zero
    out_1 = out_s = None
    if fused:
        comb = _concat_batches(batch, unlabeled_batch)
        outputs = model(comb)
        # each per-scale loss is a batch mean: the 2N loss stands for each half's
        mono_loss = mono_loss_u = _monodepth_loss(cfg, comb, outputs, generator,
                                                  draws.tie_break_noise_fused)
        outputs, out_1 = _split_outputs(outputs, n_lab)
    elif fused_mixed:
        mixed_batch = dict(unlabeled_batch)
        mixed_batch[image_key] = pre_mix[2]
        outputs, out_s = _split_outputs(
            model(_concat_batches(batch, mixed_batch), use_pose=False), n_lab)
    else:
        outputs = model(batch)
        if cfg.monodepth_lambda > 0:
            mono_loss = _monodepth_loss(cfg, batch, outputs, generator, tie_break_noise)
    if cfg.monodepth_lambda > 0 and cfg.feat_dist_lambda > 0:
        feat_dist_loss = cfg.feat_dist_lambda * _feat_dist(outputs)
    pseudo_depth_loss = zero
    if cfg.pseudo_depth_lambda > 0:
        pseudo_depth_loss = cfg.pseudo_depth_lambda * _pseudo_depth_loss(
            cfg, outputs["disp_0"], batch["pseudo_depth"])
    seg_loss = zero
    if cfg.segmentation_lambda > 0:
        seg_loss = _segmentation_loss(cfg, outputs, batch["lbl"])
    seg_total, mono_total = seg_loss, mono_loss + feat_dist_loss

    metrics = {}
    if semi:
        l_1 = zero
        if fused_mixed:
            depths, mix_mask, mixed_imgs, mixed_softmax = pre_mix
        elif cfg.depthmix_online_depth:
            if not fused:
                out_1 = model(unlabeled_batch)
                if cfg.monodepth_lambda > 0:
                    mono_loss_u = _monodepth_loss(cfg, unlabeled_batch, out_1, generator,
                                                  draws.tie_break_noise_u)
            if cfg.monodepth_lambda > 0:
                d = out_1["disp_0"].detach()
                dmin = d.amin((1, 2, 3), keepdim=True)
                dmax = d.amax((1, 2, 3), keepdim=True)
                depths = ((d - dmin) / (dmax - dmin + 1e-12))[:, 0]
            else:
                depths = unlabeled_batch["pseudo_depth"][:, 0]
            if cfg.backward_first_pseudo_label:
                l_1, _ = pseudo_label_loss(cfg, teacher_softmax, out_1["semantics"])
        elif "pseudo_depth" in unlabeled_batch:
            depths = unlabeled_batch["pseudo_depth"][:, 0]
        else:
            depths = None

        if not fused_mixed:
            with torch.no_grad():
                mix_mask = generate_mix_mask(cfg, argmax_u_w, depths, draws, generator)
                mixed_imgs = strong_transform(cfg, mix_mask, unlabeled_batch[image_key],
                                              draws, generator)
                mixed_softmax, _ = mix(mix_mask, teacher_softmax)
            mixed_batch = dict(unlabeled_batch)
            mixed_batch[image_key] = mixed_imgs
            out_s = model(mixed_batch, use_pose=False)
        l_2, pseudo_label = pseudo_label_loss(cfg, mixed_softmax, out_s["semantics"])

        seg_total = seg_total + l_2 + l_1
        mono_total = mono_total + mono_loss_u
        metrics["unlabeled_loss"] = (l_2 + l_1).detach()
        if cfg.debug_images:
            metrics["debug/mixed_imgs"] = mixed_imgs.detach()
            metrics["debug/mix_mask"] = mix_mask
            metrics["debug/pseudo_label"] = pseudo_label
            if depths is not None:
                metrics["debug/depths"] = depths.detach()
    total = seg_total + mono_total + pseudo_depth_loss

    optimizer.zero_grad()
    total.backward()
    step = optimizer.step_count  # steps taken before this one (the JAX state.step)
    optimizer.step()
    if cfg.use_ema:
        update_ema(teacher, model, step, EMA_ALPHA, cfg.ema_names)
    metrics.update({"segmentation_loss": seg_loss.detach(), "mono_loss": mono_loss.detach(),
                    "pseudo_depth_loss": pseudo_depth_loss.detach(),
                    "feat_dist_loss": feat_dist_loss.detach(),
                    "segmentation_total_loss": seg_total.detach(),
                    "mono_total_loss": mono_total.detach(), "total_loss": total.detach()})
    return metrics


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor], cfg: StepConfig,
              generator: Optional[torch.Generator] = None,
              tie_break_noise: Optional[torch.Tensor] = None):
    """One validation batch (NCHW) through the model in eval mode.

    Returns (metrics, conf, aux): 0-dim tensors `segmentation_loss`,
    `monodepth_loss`, `pseudo_depth_loss` and, where the model predicts
    depth, `depth/*` (`engine/trainer_depth_eval.py`); the batch's (C, C)
    int64 confusion matrix; `pred` (N, H, W) and `disp_0`. With a pose
    network the photometric loss runs K1 and the fused K2 error on CUDA
    tensors; its tie-break noise is `tie_break_noise` or drawn from
    `generator`, as in `ops/photometric.py::compute_losses`.
    """
    model.eval()
    outputs = model(batch)
    zero = torch.zeros((), device=batch[key_of("color_aug", 0, 0)].device)
    metrics: Dict[str, torch.Tensor] = {}
    aux: Dict[str, torch.Tensor] = {}

    conf = torch.zeros((cfg.num_classes, cfg.num_classes), dtype=torch.int64,
                       device=zero.device)
    metrics["segmentation_loss"] = zero
    if cfg.segmentation_lambda > 0:
        labels = batch["lbl"]
        semantics = outputs["semantics"]
        metrics["segmentation_loss"] = cross_entropy2d(semantics, labels)
        semantics = resize_bilinear(semantics, labels.shape[1:], align_corners=True)
        pred = semantics.argmax(1)
        conf = confusion_matrix(labels, pred, cfg.num_classes)
        aux["pred"] = pred

    metrics["monodepth_loss"] = zero
    if not cfg.disable_monodepth:
        if not cfg.disable_pose:
            out2 = photometric.generate_images_pred(
                batch, outputs, scales=cfg.scales, frame_ids=cfg.frame_ids,
                min_depth=cfg.min_depth, max_depth=cfg.max_depth)
            metrics["monodepth_loss"] = photometric.compute_losses(
                batch, out2, scales=cfg.scales, frame_ids=cfg.frame_ids,
                disparity_smoothness=cfg.disparity_smoothness, no_ssim=cfg.no_ssim,
                avg_reprojection=cfg.avg_reprojection,
                disable_automasking=cfg.disable_automasking, fused_pred=True,
                generator=generator, tie_break_noise=tie_break_noise)["loss"]
        else:
            outputs.update(model.predict_test_disp(batch))
            outputs.update(photometric.generate_depth_test_pred(
                outputs, scales=cfg.scales, test_min_depth=cfg.test_min_depth,
                test_max_depth=cfg.test_max_depth))
        aux["disp_0"] = outputs["disp_0"]

    metrics["pseudo_depth_loss"] = zero
    if cfg.has_depth_teacher and "pseudo_depth" in batch and "disp_0" in outputs:
        metrics["pseudo_depth_loss"] = _pseudo_depth_loss(cfg, outputs["disp_0"],
                                                          batch["pseudo_depth"])
    if "disp_0" in outputs:
        metrics.update(eval_depth_metrics(cfg, batch, outputs))
    return metrics, conf, aux


def step_config_from_cfg(cfg: Dict[str, Any]) -> StepConfig:
    """StepConfig from the experiment config (the JAX `step_config_from_cfg`
    schema)."""
    t = cfg.get("training", {})
    m = cfg.get("model", {})
    mono = dict(cfg.get("monodepth_options", {}))
    mono.update(t.get("monodepth_loss") or {})
    u = t.get("unlabeled_segmentation") or {}
    pred_layout = t.get("pred_layout", "pack")
    if pred_layout not in _PRED_LAYOUTS:
        raise ValueError(f"training.pred_layout {pred_layout!r}: one of {_PRED_LAYOUTS}")
    # under amp the chain is bf16, as in the JAX package
    dtype_name = "bfloat16" if t.get("amp", False) else t.get("photometric_dtype")
    if dtype_name not in _PHOTOMETRIC_DTYPES:
        raise ValueError(f"training.photometric_dtype {dtype_name!r}: bfloat16 or null")
    fg_thr = u.get("depthcomp_foreground_threshold", 0.0)
    return StepConfig(
        monodepth_lambda=t.get("monodepth_lambda", 0.0),
        feat_dist_lambda=t.get("feat_dist_lambda", 0.0),
        pseudo_depth_lambda=t.get("pseudo_depth_lambda", 0.0),
        segmentation_lambda=t.get("segmentation_lambda", 1.0),
        pseudo_depth_loss_log=t.get("pseudo_depth_loss_log", False),
        frame_ids=tuple(mono.get("frame_ids", (0, -1, 1))),
        scales=tuple(range(mono.get("num_scales", 4))),
        min_depth=mono.get("min_depth", 0.1),
        max_depth=mono.get("max_depth", 100.0),
        test_min_depth=mono.get("test_min_depth", mono.get("min_depth", 0.1)),
        test_max_depth=mono.get("test_max_depth", mono.get("max_depth", 100.0)),
        disparity_smoothness=mono.get("disparity_smoothness", 1e-3),
        no_ssim=mono.get("no_ssim", False),
        avg_reprojection=mono.get("avg_reprojection", False),
        disable_automasking=mono.get("disable_automasking", False),
        photometric_dtype=_PHOTOMETRIC_DTYPES[dtype_name],
        fused_pred_loss=t.get("fused_reprojection", False),
        remat_photometric=t.get("remat_photometric", False),
        disable_monodepth=m.get("disable_monodepth", False),
        disable_pose=m.get("disable_pose", False),
        has_depth_teacher=cfg.get("data", {}).get("depth_teacher") is not None,
        num_classes=cfg.get("data", {}).get("n_classes", 19),
        unlabeled=bool(u),
        consistency_weight=u.get("consistency_weight", 1.0),
        mix_mask=u.get("mix_mask"),
        unlabeled_color_jitter=bool(u.get("color_jitter", False)),
        unlabeled_blur=bool(u.get("blur", False)),
        mix_use_gt=u.get("mix_use_gt", False),
        depthcomp_margin=u.get("depthcomp_margin", 0.0),
        depthcomp_foreground_threshold=(tuple(fg_thr) if isinstance(fg_thr, (list, tuple))
                                        else fg_thr),
        depthmix_online_depth=u.get("depthmix_online_depth", False),
        backward_first_pseudo_label=u.get("backward_first_pseudo_label", False),
        fuse_unlabeled_forward=t.get("fuse_unlabeled_forward", False),
        use_ema=bool(u),
        ema_names=ema_model_names(t, m),
        # the reference's experiments set `debug_image`, its trainer reads
        # `debug_images`: both are read, as in the JAX package
        debug_images=bool(u.get("debug_images", u.get("debug_image", False))),
    )
