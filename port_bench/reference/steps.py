"""The reference side of the comparison: the frozen plain copy (`segsde/`)
follows the cell's checked steps from the same weights, batches and draws
as the port, and gives its `Readings` (`harness/compare.py`).

`precision` is the arithmetic it computes in; the reference proper computes
in the one the configuration states (its file's `precision`), the control
in the step below it:
  float32   f32, TF32 off for convolutions and matmuls
  tf32      f32 with cuDNN's default TF32 convolutions (matmuls in f32)
  bfloat16  the port's own bf16 path (`training.amp`: convolutions in bf16
            under autocast, BatchNorm statistics in f32, the SSIM/L1 chain
            in bf16)
  fp8       bfloat16, and every convolution's input and kernel rounded to
            float8 e4m3 with one scale per tensor (`precision.py`)
`half_batch` plants a fault: every batch (and its draws) cut to its first
half, each mean taken over the rest. `channels_last` keeps the model's
tensors in NHWC memory, so that cuDNN picks other algorithms for the same
arithmetic: the kind of change a sound later program makes, which the
limits have to leave room for.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional

import torch

from ..harness.compare import Readings, change_norms, components, first_gradients, norms
from .precision import fp8_convolutions
from .segsde.engine.optim import build_optimizer
from .segsde.engine.state import make_teacher
from .segsde.engine.train_steps import StepDraws, step_config_from_cfg, train_step
from .segsde.models import joint
from .segsde.models.joint import build_model

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")
# a configuration file's `precision` -> the reference's
STATED = {"fp32": "float32", "tf32": "tf32", "bf16": "bfloat16"}


def device_batch(host: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """A host batch (NHWC) as the step reads it: NCHW frames, int64 labels."""
    out = {}
    for k, v in host.items():
        t = v.to(device)
        if k == "lbl":
            t = t.long()
        elif t.dim() == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t
    return out


def reference_config(config: Dict[str, Any], precision: str) -> Dict[str, Any]:
    """The configuration with `training.amp` set for `precision` and the
    shared `monodepth_options` merged into the model's and the data's
    sections where those do not set a key (as the trainer merges them)."""
    cfg = copy.deepcopy(config)
    cfg["training"]["amp"] = precision in ("bfloat16", "fp8")
    for section in ("model", "data"):
        for k, v in cfg.get("monodepth_options", {}).items():
            cfg.setdefault(section, {}).setdefault(k, v)
    return cfg


def build_reference_model(config: Dict[str, Any], device, precision: str = "tf32"):
    """The reference's model on `device`. On the meta device (shapes only)
    its initialisation is skipped: the truncated normal has no meta kernel,
    and its fallback imports much of torch's compiler stack, seconds of
    set-up for values that do not exist."""
    cfg = reference_config(config, precision)
    skip = torch.device(device).type == "meta"
    with torch.device(device), (_no_init() if skip else contextlib.nullcontext()):
        return build_model(cfg["model"], int(cfg["data"]["n_classes"]),
                           amp=cfg["training"]["amp"], seed=int(cfg.get("seed", 0)))


@contextlib.contextmanager
def _no_init():
    saved = joint.init_weights
    joint.init_weights = lambda module: None
    try:
        yield
    finally:
        joint.init_weights = saved


@contextlib.contextmanager
def _tf32(convolutions: bool):
    """cuDNN's TF32 convolutions on or off, matmuls in f32, for the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _half(batch: Optional[Dict[str, torch.Tensor]]):
    if batch is None:
        return None
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def _half_draws(draws: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v[: v.shape[0] // 2] if isinstance(v, torch.Tensor) and v.dim() > 0 else v)
            for k, v in draws.items()}


def run_reference(config: Dict[str, Any], weights: Dict[str, torch.Tensor], ring, step_draws,
                  device, precision: str, half_batch: bool = False,
                  channels_last: bool = False) -> Readings:
    """Follow the checked steps (`ring[k]` with `step_draws[k]`, k = 0, 1, ...)
    with the plain reference and return its readings."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    cfg = reference_config(config, precision)
    model = build_reference_model(config, device, precision)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    if channels_last:
        model = model.to(memory_format=torch.channels_last)
    step_cfg = step_config_from_cfg(cfg)
    optimizer = build_optimizer(cfg["training"], cfg["model"], model)
    teacher = make_teacher(model) if step_cfg.use_ema else None
    losses: List[float] = []
    grads: Dict[str, torch.Tensor] = {}
    first: Dict[str, float] = {}
    quantize = fp8_convolutions() if precision == "fp8" else contextlib.nullcontext()
    with _tf32(precision == "tf32"), quantize:
        for k, d in enumerate(step_draws):
            torch.manual_seed(d["default_seed"])
            generator = torch.Generator(device=device).manual_seed(d["generator_seed"])
            batch = device_batch(ring[k]["labeled"], device)
            unlabeled = (device_batch(ring[k]["unlabeled"], device)
                         if ring[k]["unlabeled"] is not None else None)
            noise, draws = d["tie_break_noise"], d["draws"]
            if half_batch:
                batch, unlabeled = _half(batch), _half(unlabeled)
                noise, draws = noise[: noise.shape[0] // 2], _half_draws(draws)
            record = train_step(model, optimizer, batch, step_cfg, generator=generator,
                                tie_break_noise=noise, unlabeled_batch=unlabeled,
                                teacher=teacher, draws=StepDraws(**draws))
            losses.append(float(record["total_loss"]))
            if k == 0:
                grads = first_gradients(optimizer, weights)
                first = components(record)
    changes = change_norms(optimizer, weights)
    return Readings(losses=losses, components=first, grads=grads, grad_norms=norms(grads),
                    change_norms=changes)
