"""SGD with per-submodule learning rates, coupled weight decay and gradient
clipping, with the semantics of the JAX package's optax chain.

Port of what `engine/optim.py::build_optimizer` builds for `name: sgd`:
  [clip_by_global_norm | masked_clip_by_global_norm]
  -> per group: add_decayed_weights(wd) -> trace(momentum) -> -lr * factor(step)
Groups are the top-level submodules (encoder / pose / depth / segmentation;
anything else "default"). As in the JAX package, a parameter without a
gradient counts as a zero gradient (weight decay still applies).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .. import not_ported

_GROUP_LR_KEYS = {"encoder": "backbone_lr", "pose": "pose_lr", "depth": "depth_lr",
                  "segmentation": "segmentation_lr"}
_FREEZE_KEYS = ("freeze_backbone", "freeze_depth", "freeze_pose", "freeze_segmentation")


def label_of(top: str) -> str:
    if top in ("pose", "pose_encoder"):
        return "pose"
    return top if top in ("encoder", "depth", "segmentation") else "default"


def build_lr_factor_fn(sched_cfg: Optional[Dict[str, Any]]) -> Callable[[int], float]:
    """step -> multiplicative lr factor (JAX `build_lr_factor_fn`)."""
    if sched_cfg is None:
        return lambda step: 1.0
    cfg = dict(sched_cfg)
    name = cfg.pop("name")
    if cfg.get("warmup_iters") is not None:
        raise not_ported("lr_schedule.warmup_iters", "trainer I/O")
    if name == "multi_step":
        milestones = sorted(cfg["milestones"])
        gamma = cfg.get("gamma", 0.1)
        return lambda step: gamma ** sum(step >= m for m in milestones)
    raise not_ported(f"lr_schedule {name}", "trainer I/O")


class SGD:
    """The functional SGD update of the JAX package, group by group."""

    def __init__(self, groups: List[Dict[str, Any]], momentum: float,
                 weight_decay: float, factor_fn: Callable[[int], float],
                 clip_grad_norm: Optional[float], clip_groups: Optional[set]):
        self.groups = groups
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.factor_fn = factor_fn
        self.clip_grad_norm = clip_grad_norm
        self.clip_groups = clip_groups  # None: clip every gradient
        self.step_count = 0
        self.momentum_buffers: Dict[torch.nn.Parameter, torch.Tensor] = {}

    def zero_grad(self) -> None:
        for g in self.groups:
            for p in g["params"]:
                p.grad = None

    def _grad(self, p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    @torch.no_grad()
    def step(self) -> None:
        grads = {p: self._grad(p) for g in self.groups for p in g["params"]}
        if self.clip_grad_norm is not None:
            clipped = [p for g in self.groups for p in g["params"]
                       if self.clip_groups is None or g["label"] in self.clip_groups]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(grads[p]) for p in clipped]))
            for p in clipped:
                if self.clip_groups is None:  # optax.clip_by_global_norm
                    grads[p] = torch.where(norm < self.clip_grad_norm, grads[p],
                                           grads[p] / norm * self.clip_grad_norm)
                else:  # masked_clip_by_global_norm (engine/optim.py:290-307)
                    grads[p] = grads[p] * torch.clamp(
                        self.clip_grad_norm / (norm + 1e-6), max=1.0)
        lr_factor = self.factor_fn(self.step_count)
        for g in self.groups:
            step_size = g["lr"] * lr_factor
            for p in g["params"]:
                d = grads[p]
                if self.weight_decay:
                    d = d + self.weight_decay * p
                if self.momentum:
                    buf = self.momentum_buffers.get(p)
                    d = d.clone() if buf is None else buf.mul_(self.momentum).add_(d)
                    self.momentum_buffers[p] = d
                p.add_(d, alpha=-step_size)
        self.step_count += 1


def build_optimizer(training_cfg: Dict[str, Any], model_cfg: Dict[str, Any],
                    model: torch.nn.Module) -> SGD:
    """`training.optimizer` / `lr_schedule` / `clip_grad_norm` ->  SGD over the
    joint model's `models.*` submodules."""
    ocfg = dict(training_cfg.get("optimizer") or {"name": "sgd", "lr": 0.01})
    name = ocfg.pop("name", "sgd")
    if name != "sgd" or ocfg.get("nesterov", False):
        raise not_ported(f"optimizer {name} (nesterov {ocfg.get('nesterov', False)})",
                         "trainer I/O")
    frozen = [k for k in _FREEZE_KEYS if model_cfg.get(k, False)]
    if frozen:
        raise not_ported(f"model.{', '.join(frozen)} (frozen parameter groups)",
                         "trainer I/O")
    base_lr = ocfg.get("lr", 0.01)
    groups: Dict[str, Dict[str, Any]] = {}
    for top, module in model.models.items():
        label = label_of(top)
        group = groups.setdefault(label, {
            "label": label, "params": [],
            "lr": ocfg.get(_GROUP_LR_KEYS.get(label, ""), base_lr)})
        group["params"].extend(module.parameters())
    clip_groups = None
    if training_cfg.get("disable_depth_grad_clip", False):
        clip_groups = {"encoder", "segmentation"}
    return SGD(list(groups.values()), momentum=ocfg.get("momentum", 0.0),
               weight_decay=ocfg.get("weight_decay", 0.0),
               factor_fn=build_lr_factor_fn(training_cfg.get("lr_schedule")),
               clip_grad_norm=training_cfg.get("clip_grad_norm"), clip_groups=clip_groups)
