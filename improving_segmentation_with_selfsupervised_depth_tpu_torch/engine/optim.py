"""SGD and Adam with per-submodule learning rates, frozen groups, coupled
weight decay and gradient clipping, with the semantics of the JAX package's
optax chain.

Port of what `engine/optim.py::build_optimizer` builds for `name: sgd` and
`name: adam`:
  [clip_by_global_norm | masked_clip_by_global_norm]
  -> per group: add_decayed_weights(wd) -> trace(momentum) | scale_by_adam
     -> -lr * factor(step)
  -> frozen groups: set_to_zero
Groups are the top-level submodules (encoder / pose / depth / segmentation;
anything else "default"); the PAD decoder's branches split between the depth
group (`depth_dec`, `sa_seg`) and the segmentation group (the rest), as in
the JAX package's `label_of`. The ImageNet encoder is always frozen, and a
`model.freeze_*` flag freezes its group (`param_labels`). A frozen parameter
gets `requires_grad_(False)`: no gradient, no update, no weight decay and no
optimizer state. Its module is not put in eval mode, so the BatchNorm running
statistics of a frozen encoder still move in train mode, as in the JAX
package (`freeze_backbone` is not `freeze_backbone_bn`). As in the JAX
package, a trainable parameter without a gradient counts as a zero gradient
(weight decay still applies).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .. import not_ported

_GROUP_LR_KEYS = {"encoder": "backbone_lr", "pose": "pose_lr", "depth": "depth_lr",
                  "segmentation": "segmentation_lr"}
_FREEZE_KEYS = {"encoder": "freeze_backbone", "depth": "freeze_depth", "pose": "freeze_pose",
                "segmentation": "freeze_segmentation"}
FROZEN = "frozen"


# PAD branches of the depth task (reference PAD.depth_params: the depth
# decoder and the attention that feeds the segmentation branch)
_PAD_DEPTH = {"depth_dec", "sa_seg"}


def label_of(top: str, second: Optional[str] = None) -> str:
    """Group of a parameter under `models.{top}[.{second}]`."""
    if top in ("pose", "pose_encoder"):
        return "pose"
    if top == "mtl_decoder":
        return "depth" if second in _PAD_DEPTH else "segmentation"
    if top == "imnet_encoder":
        return FROZEN
    return top if top in ("encoder", "depth", "segmentation") else "default"


def param_labels(model: torch.nn.Module, model_cfg: Dict[str, Any]) -> Dict[str, str]:
    """Parameter name -> group, with `FROZEN` for the ImageNet encoder and the
    groups that a `freeze_*` flag names (JAX `build_param_labels`). A flag on
    a group without parameters is accepted."""
    labels = {}
    for name, _ in model.models.named_parameters(prefix="models"):
        label = _group_of(name)
        labels[name] = FROZEN if model_cfg.get(_FREEZE_KEYS.get(label, ""), False) else label
    return labels


def _group_of(name: str) -> str:
    """The group of parameter `models.<top>[.<second>].*` before any freeze."""
    parts = name.split(".")
    return label_of(parts[1], parts[2] if parts[1] == "mtl_decoder" else None)


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
    if name == "step_lr":
        step_size, gamma = cfg["step_size"], cfg.get("gamma", 0.1)
        return lambda step: gamma ** (step // step_size)
    if name == "reduce_lr_on_plateau":
        # the trainer's plateau step scales the update (`lr_scale`) instead
        return lambda step: 1.0
    raise not_ported(f"lr_schedule {name}", "trainer I/O")


class _GroupOptimizer:
    """What SGD and Adam share: the groups, the clip, the lr schedule, the
    step count and the plateau's `lr_scale`. `_update` moves one group's
    parameters by its (clipped) gradients, scaled by
    -lr * factor(step) * lr_scale: `lr_scale` multiplies the final update,
    as in the JAX package's train step (`engine/train_steps.py:420`), not
    the gradients that the momentum or Adam's moments accumulate."""

    def __init__(self, groups: List[Dict[str, Any]], weight_decay: float,
                 factor_fn: Callable[[int], float], clip_grad_norm: Optional[float],
                 clip_groups: Optional[set]):
        self.groups = groups
        self.weight_decay = weight_decay
        self.factor_fn = factor_fn
        self.clip_grad_norm = clip_grad_norm
        self.clip_groups = clip_groups  # None: clip every gradient
        self.step_count = 0
        self.lr_scale = 1.0

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
            self._update(g["params"], [grads[p] for p in g["params"]],
                         g["lr"] * lr_factor * self.lr_scale)
        self.step_count += 1

    def _update(self, params, grads, step_size) -> None:
        raise NotImplementedError

    def _buffers(self) -> Dict[str, Dict[torch.nn.Parameter, torch.Tensor]]:
        """The per-parameter state, by kind."""
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        """The step count, `lr_scale` and the per-parameter buffers by
        parameter name (tensors on the parameters' device)."""
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        for g in self.groups:
            for name, p in zip(g["names"], g["params"]):
                bufs = {kind: b[p] for kind, b in self._buffers().items() if p in b}
                if bufs:
                    state[name] = bufs
        return {"step_count": self.step_count, "lr_scale": self.lr_scale, "state": state}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s output, its tensors copied to the
        parameters' device."""
        params = {name: p for g in self.groups for name, p in zip(g["names"], g["params"])}
        unknown = set(sd["state"]) - set(params)
        if unknown:
            raise ValueError(f"optimizer state for parameters it does not train: "
                             f"{sorted(unknown)[:5]}")
        buffers = self._buffers()
        for b in buffers.values():
            b.clear()
        for name, bufs in sd["state"].items():
            for kind, t in bufs.items():
                buffers[kind][params[name]] = t.to(params[name].device, copy=True)
        self.step_count = int(sd["step_count"])
        self.lr_scale = float(sd["lr_scale"])


class SGD(_GroupOptimizer):
    """The functional SGD update of the JAX package, group by group."""

    def __init__(self, groups, momentum: float, weight_decay: float, factor_fn,
                 clip_grad_norm, clip_groups):
        super().__init__(groups, weight_decay, factor_fn, clip_grad_norm, clip_groups)
        self.momentum = momentum
        self.momentum_buffers: Dict[torch.nn.Parameter, torch.Tensor] = {}

    def _update(self, params, grads, step_size) -> None:
        for p, d in zip(params, grads):
            if self.weight_decay:
                d = d + self.weight_decay * p
            if self.momentum:
                buf = self.momentum_buffers.get(p)
                d = d.clone() if buf is None else buf.mul_(self.momentum).add_(d)
                self.momentum_buffers[p] = d
            p.add_(d, alpha=-step_size)

    def _buffers(self):
        return {"momentum": self.momentum_buffers}


class Adam(_GroupOptimizer):
    """optax `scale_by_adam` after `add_decayed_weights`, group by group:

        g    = grad + wd * p
        mu   = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu
        p   -= lr * factor(step) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with t the count of steps including this one, in `torch._foreach_*` ops
    over the group's tensors."""

    def __init__(self, groups, betas, eps: float, weight_decay: float, factor_fn,
                 clip_grad_norm, clip_groups):
        super().__init__(groups, weight_decay, factor_fn, clip_grad_norm, clip_groups)
        self.b1, self.b2 = betas
        self.eps = eps
        self.mu: Dict[torch.nn.Parameter, torch.Tensor] = {}
        self.nu: Dict[torch.nn.Parameter, torch.Tensor] = {}

    def _update(self, params, grads, step_size) -> None:
        for p in params:
            if p not in self.mu:
                self.mu[p], self.nu[p] = torch.zeros_like(p), torch.zeros_like(p)
        mu, nu = [self.mu[p] for p in params], [self.nu[p] for p in params]
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        t = self.step_count + 1
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, 1.0 - self.b1 ** t)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(params, update, alpha=-step_size)

    def _buffers(self):
        return {"mu": self.mu, "nu": self.nu}


def build_optimizer(training_cfg: Dict[str, Any], model_cfg: Dict[str, Any],
                    model: torch.nn.Module) -> _GroupOptimizer:
    """`training.optimizer` / `lr_schedule` / `clip_grad_norm` -> SGD or Adam
    over the joint model's `models.*` submodules; freezes the frozen groups'
    parameters (`requires_grad_(False)`)."""
    ocfg = dict(training_cfg.get("optimizer") or {"name": "sgd", "lr": 0.01})
    name = ocfg.pop("name", "sgd")
    if name not in ("sgd", "adam") or ocfg.get("nesterov", False):
        raise not_ported(f"optimizer {name} (nesterov {ocfg.get('nesterov', False)})",
                         "trainer I/O")
    labels = param_labels(model, model_cfg)
    clip = training_cfg.get("clip_grad_norm")
    masked_clip = training_cfg.get("disable_depth_grad_clip", False)
    frozen_by_flag = sorted({_FREEZE_KEYS[group] for group in map(_group_of, labels)
                             if model_cfg.get(_FREEZE_KEYS.get(group, ""), False)})
    if clip is not None and not masked_clip and frozen_by_flag:
        # optax.clip_by_global_norm wraps the multi_transform: its norm counts
        # the frozen groups' gradients, which the port does not compute
        raise not_ported(f"training.clip_grad_norm with model.{', '.join(frozen_by_flag)}",
                         "trainer I/O")
    base_lr = ocfg.get("lr", 0.01)
    groups: Dict[str, Dict[str, Any]] = {}
    for pname, p in model.named_parameters():
        label = labels[pname]
        if label == FROZEN:
            p.requires_grad_(False)
            continue
        group = groups.setdefault(label, {
            "label": label, "params": [], "names": [],
            "lr": ocfg.get(_GROUP_LR_KEYS.get(label, ""), base_lr)})
        group["params"].append(p)
        group["names"].append(pname)
    common = dict(weight_decay=ocfg.get("weight_decay", 0.0),
                  factor_fn=build_lr_factor_fn(training_cfg.get("lr_schedule")),
                  clip_grad_norm=clip,
                  # masked: the encoder and segmentation groups that are not frozen
                  clip_groups={"encoder", "segmentation"} if masked_clip else None)
    if name == "adam":
        return Adam(list(groups.values()), betas=tuple(ocfg.get("betas", (0.9, 0.999))),
                    eps=ocfg.get("eps", 1e-8), **common)
    return SGD(list(groups.values()), momentum=ocfg.get("momentum", 0.0), **common)
