"""The model FLOPs a training step requires, counted with
`torch.utils.flop_counter.FlopCounterMode` over the plain reference's model
on the meta device (no memory, no arithmetic): the student's forwards with
the backward of every output a loss reads, the EMA teacher's forward and,
where the model has one, the ImageNet encoder's forward inside the
student's. Counted from the configuration and the traffic's batch, so it is
independent of what the port launches; recomputation is not counted, and
neither are the losses' elementwise operations (the counter counts matrix
products and convolutions)."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.steps import build_reference_model
from .traffic import shape_of, step_kind


def _meta_batch(n: int, h: int, w: int, frames: List[Any]) -> Dict[str, torch.Tensor]:
    return {f"color_aug_{f}_0": torch.empty((n, 3, h, w), device="meta") for f in frames}


def _loss_outputs(out: Dict[str, torch.Tensor], seg: bool, mono: bool, feat: bool):
    keep = []
    for k, v in out.items():
        if not v.requires_grad:
            continue
        if (seg and k in ("semantics", "intermediate_semantics")) or \
                (mono and (k.startswith("disp_") or k.startswith("cam_T_cam"))) or \
                (feat and k == "encoder_features"):
            keep.append(v)
    return keep


def step_flops(config: Dict[str, Any], traffic: Dict[str, Any]) -> int:
    frames, _, _ = shape_of(config)
    t = config["training"]
    kind = step_kind(config)
    u = t.get("unlabeled_segmentation") or {}
    seg = t.get("segmentation_lambda", 1.0) > 0
    mono = t.get("monodepth_lambda", 0.0) > 0
    feat = mono and t.get("feat_dist_lambda", 0.0) > 0
    h, w = traffic["height"], traffic["width"]
    n, nu = traffic["batch"], traffic.get("unlabeled_batch", 0)
    model = build_reference_model(config, "meta")
    model._autocast = lambda x: contextlib.nullcontext()  # no autocast on meta
    model.train()
    with FlopCounterMode(display=False) as fc:
        outputs = _loss_outputs(model(_meta_batch(n, h, w, frames)), seg, mono, feat)
        if kind["semi"]:
            with torch.no_grad():
                model(_meta_batch(nu, h, w, frames), use_pose=False)  # the teacher
            if kind["photometric_unlabeled"]:
                outputs += _loss_outputs(model(_meta_batch(nu, h, w, frames)),
                                         u.get("backward_first_pseudo_label", False), True,
                                         feat)
            outputs += _loss_outputs(model(_meta_batch(nu, h, w, frames), use_pose=False),
                                     True, False, False)
        sum(o.float().sum() for o in outputs).backward()
    return int(fc.get_total_flops())

