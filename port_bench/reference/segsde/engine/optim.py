"""Optimizers with per-submodule learning rates, frozen groups, coupled
weight decay, gradient clipping and lr schedules, with the semantics of the
JAX package's optax chain.

Port of what `engine/optim.py::build_optimizer` builds (reference
utils/optimizers.py:7-29, utils/schedulers.py):
  [clip_by_global_norm | masked_clip_by_global_norm]
  -> per group: add_decayed_weights(wd) -> the core -> -lr * factor(step)
  -> frozen groups: set_to_zero
The cores: sgd (optax `trace`, with `nesterov`), adam, adamax, adadelta,
adagrad (`scale_by_rss`), rmsprop (`scale_by_rms`), and asgd, which applies
its own lr, sign and schedule (torch.optim.ASGD's live iterate, JAX
`_asgd_update`): no `-lr * factor` follows it. The schedules are JAX
`build_lr_factor_fn`'s, in f32 as there.
Groups are the top-level submodules (encoder / pose / depth / segmentation;
anything else "default"); the PAD decoder's branches split between the depth
group (`depth_dec`, `sa_seg`) and the segmentation group (the rest), as in
the JAX package's `label_of`. The ImageNet encoder is always frozen, and a
`model.freeze_*` flag freezes its group (`param_labels`). A frozen parameter
gets `requires_grad_(False)`: no gradient, no update, no weight decay and no
optimizer state, except under a global clip (`clip_grad_norm` without
`disable_depth_grad_clip`) with a `freeze_*` flag: optax's
`clip_by_global_norm` wraps the multi_transform, so its norm counts the
frozen groups' gradients, and the port keeps their gradients for the norm
alone (they are never updated). A frozen module is not put in eval mode,
so the BatchNorm running statistics of a frozen encoder still move in
train mode, as in the JAX package (`freeze_backbone` is not
`freeze_backbone_bn`). As in the JAX
package, a trainable parameter without a gradient counts as a zero gradient
(weight decay still applies).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

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


def frozen_label(top: str, second: Optional[str], model_cfg: Dict[str, Any]) -> str:
    """`label_of`, or `FROZEN` where a `freeze_*` flag names the group."""
    label = label_of(top, second)
    return FROZEN if model_cfg.get(_FREEZE_KEYS.get(label, ""), False) else label


def param_labels(model: torch.nn.Module, model_cfg: Dict[str, Any]) -> Dict[str, str]:
    """Parameter name -> group, with `FROZEN` for the ImageNet encoder and the
    groups that a `freeze_*` flag names (JAX `build_param_labels`). A flag on
    a group without parameters is accepted."""
    labels = {}
    for name, _ in model.models.named_parameters(prefix="models"):
        parts = name.split(".")
        labels[name] = frozen_label(parts[1], parts[2] if parts[1] == "mtl_decoder" else None,
                                    model_cfg)
    return labels


def _group_of(name: str) -> str:
    """The group of parameter `models.<top>[.<second>].*` before any freeze."""
    parts = name.split(".")
    return label_of(parts[1], parts[2] if parts[1] == "mtl_decoder" else None)


def build_lr_factor_fn(sched_cfg: Optional[Dict[str, Any]]) -> Callable[[int], float]:
    """step -> multiplicative lr factor (JAX `build_lr_factor_fn`), computed
    in f32 as there. `poly_lr` is the intended polynomial decay, equal to
    `poly_lr_2` (the reference's `poly_lr` is constant by a bug); past
    `max_iter` its base is negative and the factor is NaN, as in the JAX
    package. `reduce_lr_on_plateau` is 1: the trainer's plateau step scales
    the update (`lr_scale`) instead. `warmup_iters` multiplies the first
    steps by `warmup_factor` (default 0.2), linearly rising to 1
    (`warmup_mode: linear`) or constant."""
    if sched_cfg is None:
        return lambda step: 1.0
    cfg = dict(sched_cfg)
    name = cfg.pop("name")
    warmup_iters = cfg.pop("warmup_iters", None)
    warmup_mode = cfg.pop("warmup_mode", "linear")
    warmup_factor = np.float32(cfg.pop("warmup_factor", 0.2))
    f32 = np.float32
    if name in ("constant_lr", "reduce_lr_on_plateau"):
        base = lambda s: f32(1.0)
    elif name in ("poly_lr", "poly_lr_2"):
        max_iter = cfg["max_iter"]
        power = f32(cfg.get("power", cfg.get("gamma", 0.9)))

        def base(s):
            with np.errstate(invalid="ignore"):
                return np.maximum(f32(1e-6), (f32(1.0) - s / f32(max_iter)) ** power)
    elif name == "step_lr":
        step_size, gamma = cfg["step_size"], f32(cfg.get("gamma", 0.1))
        base = lambda s: gamma ** np.floor(s / f32(step_size))
    elif name == "multi_step":
        milestones = np.asarray(sorted(cfg["milestones"]), np.float32)
        gamma = f32(cfg.get("gamma", 0.1))
        base = lambda s: gamma ** f32(np.sum(s >= milestones))
    elif name == "cosine_annealing":
        t_max, eta_min = f32(cfg["T_max"]), f32(cfg.get("eta_min", 0.0))
        base = lambda s: eta_min + (f32(1) - eta_min) * f32(0.5) * (
            f32(1) + np.cos(f32(math.pi) * s / t_max))
    elif name == "exp_lr":
        gamma = f32(cfg.get("gamma", 0.9))
        base = lambda s: gamma ** s
    else:
        raise NotImplementedError(f"Scheduler {name} not implemented")
    if warmup_mode not in ("linear", "constant"):
        raise KeyError(f"WarmUp mode {warmup_mode} not implemented")

    def factor(step: int) -> float:
        s = f32(step)
        cold = f32(base(s))
        if warmup_iters is None or not s < warmup_iters:
            return float(cold)
        if warmup_mode == "linear":
            alpha = s / f32(warmup_iters)
            return float(f32(warmup_factor * (f32(1) - alpha) + alpha) * cold)
        return float(warmup_factor * cold)

    return factor


class _GroupOptimizer:
    """What the optimizers share: the groups, the clip, the lr schedule, the
    step count and the plateau's `lr_scale`. `_update` moves one group's
    parameters by its (clipped, weight-decayed) gradients; a core scales its
    update by -lr * factor(step) * lr_scale: `lr_scale` multiplies the final
    update, as in the JAX package's train step (`engine/train_steps.py:420`),
    not the gradients that the state accumulates. `counted` holds the frozen
    parameters whose gradients only count in the global clip's norm.
    `KINDS` names the per-parameter buffers, which start at `INITIAL`."""

    KINDS: tuple = ()
    INITIAL = 0.0

    def __init__(self, groups: List[Dict[str, Any]], weight_decay: float,
                 factor_fn: Callable[[int], float], clip_grad_norm: Optional[float],
                 clip_groups: Optional[set], counted: Optional[List[torch.nn.Parameter]] = None):
        self.groups = groups
        self.weight_decay = weight_decay
        self.factor_fn = factor_fn
        self.clip_grad_norm = clip_grad_norm
        self.clip_groups = clip_groups  # None: clip every gradient
        self.counted = list(counted or [])
        self.step_count = 0
        self.lr_scale = 1.0
        self.buffers: Dict[str, Dict[torch.nn.Parameter, torch.Tensor]] = {
            kind: {} for kind in self.KINDS}

    def zero_grad(self) -> None:
        for p in [p for g in self.groups for p in g["params"]] + self.counted:
            p.grad = None

    def _grad(self, p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    @torch.no_grad()
    def step(self) -> None:
        grads = {p: self._grad(p) for g in self.groups for p in g["params"]}
        if self.clip_grad_norm is not None:
            clipped = [p for g in self.groups for p in g["params"]
                       if self.clip_groups is None or g["label"] in self.clip_groups]
            normed = clipped + (self.counted if self.clip_groups is None else [])
            norm = torch.linalg.vector_norm(torch.stack([
                torch.linalg.vector_norm(grads[p] if p in grads else self._grad(p))
                for p in normed]))
            for p in clipped:
                if self.clip_groups is None:  # optax.clip_by_global_norm
                    grads[p] = torch.where(norm < self.clip_grad_norm, grads[p],
                                           grads[p] / norm * self.clip_grad_norm)
                else:  # masked_clip_by_global_norm (engine/optim.py:290-307)
                    grads[p] = grads[p] * torch.clamp(
                        self.clip_grad_norm / (norm + 1e-6), max=1.0)
        lr_factor = self.factor_fn(self.step_count)
        for g in self.groups:
            params = g["params"]
            for kind in self.KINDS:
                for p in params:
                    if p not in self.buffers[kind]:
                        self.buffers[kind][p] = torch.full_like(p, self.INITIAL)
            gs = [grads[p] for p in params]
            if self.weight_decay:
                gs = torch._foreach_add(gs, params, alpha=self.weight_decay)
            self._update(g, params, gs, g["lr"] * lr_factor * self.lr_scale)
        self.step_count += 1

    def _state(self, kind: str, params) -> List[torch.Tensor]:
        return [self.buffers[kind][p] for p in params]

    def _update(self, group, params, grads, step_size) -> None:
        raise NotImplementedError

    def _group_state(self) -> Dict[str, Dict[str, float]]:
        """Per-group state beyond the buffers, by group label."""
        return {}

    def _load_group_state(self, state: Dict[str, Dict[str, float]]) -> None:
        pass

    def state_dict(self) -> Dict[str, Any]:
        """The step count, `lr_scale`, the per-parameter buffers by
        parameter name (tensors on the parameters' device) and any per-group
        state."""
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        for g in self.groups:
            for name, p in zip(g["names"], g["params"]):
                bufs = {kind: b[p] for kind, b in self.buffers.items() if p in b}
                if bufs:
                    state[name] = bufs
        sd = {"step_count": self.step_count, "lr_scale": self.lr_scale, "state": state}
        if self._group_state():
            sd["groups"] = self._group_state()
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s output, its tensors copied to the
        parameters' device."""
        params = {name: p for g in self.groups for name, p in zip(g["names"], g["params"])}
        unknown = set(sd["state"]) - set(params)
        if unknown:
            raise ValueError(f"optimizer state for parameters it does not train: "
                             f"{sorted(unknown)[:5]}")
        for b in self.buffers.values():
            b.clear()
        for name, bufs in sd["state"].items():
            for kind, t in bufs.items():
                self.buffers[kind][params[name]] = t.to(params[name].device, copy=True)
        self._load_group_state(sd.get("groups", {}))
        self.step_count = int(sd["step_count"])
        self.lr_scale = float(sd["lr_scale"])


class SGD(_GroupOptimizer):
    """optax `trace(momentum, nesterov)`: t = g + m t; the update is t, or
    g + m t with `nesterov`; no momentum: the gradient."""

    KINDS = ("momentum",)

    def __init__(self, groups, momentum: float, nesterov: bool, **common):
        if not momentum:
            self.KINDS = ()
        super().__init__(groups, **common)
        self.momentum = momentum
        self.nesterov = nesterov

    @property
    def momentum_buffers(self):
        return self.buffers.get("momentum", {})

    def _update(self, group, params, grads, step_size) -> None:
        if self.momentum:
            trace = self._state("momentum", params)
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            grads = (torch._foreach_add(grads, trace, alpha=self.momentum) if self.nesterov
                     else trace)
        torch._foreach_add_(params, grads, alpha=-step_size)


class Adam(_GroupOptimizer):
    """optax `scale_by_adam`:

        mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu
        p -= lr * factor(step) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with t the count of steps including this one."""

    KINDS = ("mu", "nu")

    def __init__(self, groups, betas, eps: float, **common):
        super().__init__(groups, **common)
        self.b1, self.b2 = betas
        self.eps = eps

    @property
    def mu(self):
        return self.buffers["mu"]

    @property
    def nu(self):
        return self.buffers["nu"]

    def _update(self, group, params, grads, step_size) -> None:
        mu, nu = self._state("mu", params), self._state("nu", params)
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


class Adamax(Adam):
    """optax `scale_by_adamax`: mu as Adam's, nu = max(|g| + eps, b2 nu),
    update (mu / (1 - b1^t)) / nu."""

    def _update(self, group, params, grads, step_size) -> None:
        mu, nu = self._state("mu", params), self._state("nu", params)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        absg = torch._foreach_abs(grads)
        torch._foreach_add_(absg, self.eps)
        torch._foreach_maximum_(nu, absg)
        update = torch._foreach_div(mu, 1.0 - self.b1 ** (self.step_count + 1))
        torch._foreach_div_(update, nu)
        torch._foreach_add_(params, update, alpha=-step_size)


class Adadelta(_GroupOptimizer):
    """optax `scale_by_adadelta`: e_g = (1 - rho) g^2 + rho e_g, update
    u = sqrt(e_x + eps) / sqrt(e_g + eps) g with the previous e_x, then
    e_x = (1 - rho) u^2 + rho e_x."""

    KINDS = ("e_g", "e_x")

    def __init__(self, groups, rho: float, eps: float, **common):
        super().__init__(groups, **common)
        self.rho, self.eps = rho, eps

    def _update(self, group, params, grads, step_size) -> None:
        e_g, e_x = self._state("e_g", params), self._state("e_x", params)
        torch._foreach_mul_(e_g, self.rho)
        torch._foreach_addcmul_(e_g, grads, grads, value=1.0 - self.rho)
        num = torch._foreach_add(e_x, self.eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, self.eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        update = torch._foreach_mul(num, grads)
        torch._foreach_mul_(e_x, self.rho)
        torch._foreach_addcmul_(e_x, update, update, value=1.0 - self.rho)
        torch._foreach_add_(params, update, alpha=-step_size)


class Adagrad(_GroupOptimizer):
    """optax `scale_by_rss`: s = g^2 + s (from `initial_accumulator_value`),
    update g / sqrt(s + eps) where s > 0, else 0."""

    KINDS = ("sum_of_squares",)

    def __init__(self, groups, initial_accumulator_value: float, eps: float, **common):
        self.INITIAL = initial_accumulator_value
        super().__init__(groups, **common)
        self.eps = eps

    def _update(self, group, params, grads, step_size) -> None:
        s = self._state("sum_of_squares", params)
        torch._foreach_addcmul_(s, grads, grads)
        for p, g, acc in zip(params, grads, s):
            p.add_(torch.where(acc > 0, torch.rsqrt(acc + self.eps), 0.0) * g,
                   alpha=-step_size)


class RMSprop(_GroupOptimizer):
    """optax `scale_by_rms(decay=alpha)`: nu = (1 - alpha) g^2 + alpha nu,
    update g / sqrt(nu + eps)."""

    KINDS = ("nu",)

    def __init__(self, groups, alpha: float, eps: float, **common):
        super().__init__(groups, **common)
        self.alpha, self.eps = alpha, eps

    def _update(self, group, params, grads, step_size) -> None:
        nu = self._state("nu", params)
        torch._foreach_mul_(nu, self.alpha)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.alpha)
        den = torch._foreach_add(nu, self.eps)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(params, torch._foreach_div(grads, den), alpha=-step_size)


class ASGD(_GroupOptimizer):
    """torch.optim.ASGD's live iterate (JAX `_asgd_update`), per group with
    its own `eta` (starting at the group's lr) and step count k:
        p <- p - eta (g + lambd p) * lr_scale
        eta <- lr_k / (1 + lambd lr_k k)^alpha,   lr_k = lr * factor(k - 1)
    The update carries its own lr and sign: no -lr * factor follows."""

    def __init__(self, groups, lambd: float, alpha: float, **common):
        super().__init__(groups, **common)
        self.lambd, self.alpha = lambd, alpha
        self.eta = {g["label"]: float(np.float32(g["lr"])) for g in groups}

    def _update(self, group, params, grads, step_size) -> None:
        eta = self.eta[group["label"]]
        update = torch._foreach_add(grads, params, alpha=self.lambd)
        torch._foreach_add_(params, update, alpha=-eta * self.lr_scale)
        f32 = np.float32
        lr_k = f32(group["lr"]) * f32(self.factor_fn(self.step_count))
        k = f32(self.step_count + 1)
        self.eta[group["label"]] = float(
            lr_k * (f32(1.0) + f32(self.lambd) * lr_k * k) ** f32(-self.alpha))

    def _group_state(self):
        return {label: {"eta": eta} for label, eta in self.eta.items()}

    def _load_group_state(self, state):
        for label, s in state.items():
            if label not in self.eta:
                raise ValueError(f"asgd state for a group it does not train: {label}")
            self.eta[label] = float(s["eta"])


def build_optimizer(training_cfg: Dict[str, Any], model_cfg: Dict[str, Any],
                    model: torch.nn.Module) -> _GroupOptimizer:
    """`training.optimizer` / `lr_schedule` / `clip_grad_norm` -> the
    optimizer over the joint model's `models.*` submodules; freezes the
    frozen groups' parameters (`requires_grad_(False)`, except those whose
    gradients a global clip counts)."""
    ocfg = dict(training_cfg.get("optimizer") or {"name": "sgd", "lr": 0.01})
    name = ocfg.pop("name", "sgd")
    if name not in _CORES:
        raise NotImplementedError(f"Optimizer {name} not implemented")
    labels = param_labels(model, model_cfg)
    clip = training_cfg.get("clip_grad_norm")
    masked_clip = training_cfg.get("disable_depth_grad_clip", False)
    base_lr = ocfg.get("lr", 0.01)
    groups: Dict[str, Dict[str, Any]] = {}
    counted = []
    for pname, p in model.named_parameters():
        label = labels[pname]
        if label == FROZEN:
            # optax.clip_by_global_norm wraps the multi_transform: its norm
            # counts the gradients of the groups a freeze_* flag freezes (the
            # ImageNet encoder's are zero: its features are detached)
            if clip is not None and not masked_clip and _group_of(pname) != FROZEN:
                counted.append(p)
            else:
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
                  clip_groups={"encoder", "segmentation"} if masked_clip else None,
                  counted=counted)
    return _CORES[name](list(groups.values()), ocfg, common)


_CORES: Dict[str, Callable[..., _GroupOptimizer]] = {
    "sgd": lambda groups, o, c: SGD(groups, momentum=o.get("momentum", 0.0),
                                    nesterov=o.get("nesterov", False), **c),
    "adam": lambda groups, o, c: Adam(groups, betas=tuple(o.get("betas", (0.9, 0.999))),
                                      eps=o.get("eps", 1e-8), **c),
    "adamax": lambda groups, o, c: Adamax(groups, betas=tuple(o.get("betas", (0.9, 0.999))),
                                          eps=o.get("eps", 1e-8), **c),
    "adadelta": lambda groups, o, c: Adadelta(groups, rho=o.get("rho", 0.9),
                                              eps=o.get("eps", 1e-6), **c),
    "adagrad": lambda groups, o, c: Adagrad(
        groups, initial_accumulator_value=o.get("initial_accumulator_value", 0.0),
        eps=o.get("eps", 1e-10), **c),
    "rmsprop": lambda groups, o, c: RMSprop(groups, alpha=o.get("alpha", 0.99),
                                            eps=o.get("eps", 1e-8), **c),
    "asgd": lambda groups, o, c: ASGD(groups, lambd=o.get("lambd", 1e-4),
                                      alpha=o.get("alpha", 0.75), **c),
}
