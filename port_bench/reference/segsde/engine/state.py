"""The EMA teacher of the mean-teacher step.

Port of the JAX package's `engine/state.py:32-73` (reference
train.py:316-358). The teacher is a module of its own, a copy of the student
made at the start; after every optimizer step its parameters move towards
the student's,

    alpha = min(1 - 1/(step+1), alpha_teacher)
    ema = alpha * ema + (1 - alpha) * param

with `step` the count of steps taken before this one, so the first update
copies the student. Only the submodules in `names` move (None: all). The
teacher's buffers (BatchNorm running statistics) are never averaged: it runs
in train mode, on batch statistics, as in the JAX package. With
`freeze_backbone_bn` its encoder runs on its running statistics, copies of
the student's, which the frozen encoder never changes.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def ema_model_names(training_cfg: Dict[str, Any], model_cfg: Dict[str, Any]
                    ) -> Optional[Tuple[str, ...]]:
    """Which top-level submodules the EMA covers (None = all)."""
    if training_cfg.get("save_monodepth_ema", False):
        names = ["depth", "pose", "pose_encoder"]
        if not model_cfg.get("freeze_backbone", False):
            names.append("encoder")
        return tuple(names)
    if model_cfg.get("segmentation_name") == "mtl_pad":
        return ("depth", "encoder", "mtl_decoder")
    return None


def make_teacher(model: torch.nn.Module) -> torch.nn.Module:
    """The teacher: a detached copy of the student."""
    teacher = copy.deepcopy(model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return teacher


@torch.no_grad()
def update_ema(teacher: torch.nn.Module, model: torch.nn.Module, step: int,
               alpha_teacher: float = 0.99, names: Optional[Tuple[str, ...]] = None) -> None:
    """One EMA update of `teacher` towards `model`, in place."""
    # the JAX package's f32 arithmetic for alpha and 1 - alpha
    alpha = np.minimum(np.float32(1.0) - np.float32(1.0) / (np.float32(step) + np.float32(1.0)),
                       np.float32(alpha_teacher))
    ema, params = [], []
    for name, module in model.models.items():
        if names is None or name in names:
            ema.extend(teacher.models[name].parameters())
            params.extend(module.parameters())
    torch._foreach_mul_(ema, float(alpha))
    torch._foreach_add_(ema, torch._foreach_mul(params, float(np.float32(1.0) - alpha)))
