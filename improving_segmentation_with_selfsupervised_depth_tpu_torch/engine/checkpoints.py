"""Pretrained weights in, SDE components out, as the reference's `.pth` files.

Port of the JAX package's `engine/checkpoints.py::save_monodepth_models`
and `apply_pretraining` with `engine/torch_interop.py::maybe_load_torch_component`
(reference train.py:377-390, models/utils.py:18-97). A component file is
the submodule's `state_dict()` in the reference layout:
`<dir>/{encoder,depth,pose_encoder,pose}.pth`, which the JAX package's
`apply_pretraining` reads too. ImageNet weights are torchvision's
`<download_model_dir>/imnet/<backbone>.pth` (keys without the `encoder.`
prefix; `fc.*` is not read). An encoder of more input frames than its file
(the two-frame pose encoder from a ResNet-18) gets `conv1` repeated over the
frames and divided by their count (reference models/resnet_encoder.py:57-60).

There is no download: a missing `mono*` component raises FileNotFoundError,
a missing ImageNet file prints the JAX package's warning and leaves the
component as initialized. Reading the JAX package's own `.msgpack` exports
needs flax's serialization and is not ported; where one lies, the JAX
package would read it, so the port raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from .. import not_ported

MONODEPTH_COMPONENTS = ("depth", "pose_encoder", "pose")
_ENCODERS = ("encoder", "pose_encoder", "imnet_encoder")


def save_component(ckpt_dir: str, model: torch.nn.Module, name: str) -> str:
    """Write `model.models[name]`'s state_dict to `<ckpt_dir>/<name>.pth`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.pth")
    torch.save({k: v.detach().cpu().clone()
                for k, v in model.models[name].state_dict().items()}, path)
    return path


def save_monodepth_models(ckpt_dir: str, model: torch.nn.Module,
                          include_encoder: bool = False) -> None:
    """Export the SDE components the model has (reference train.py:377-390)."""
    for name in MONODEPTH_COMPONENTS + (("encoder",) if include_encoder else ()):
        if name in model.models:
            save_component(ckpt_dir, model, name)


def load_torch_component(path: str, model: torch.nn.Module, name: str) -> None:
    """Load a reference or torchvision `.pth` into `model.models[name]`, in
    place. Every tensor of the submodule must be in the file with its shape
    (BatchNorm's `num_batches_tracked` may be missing); other keys are not
    read."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    own = model.models[name].state_dict()
    # torchvision's layout: the encoder's keys without the wrapper's prefix
    strip = name in _ENCODERS and not any(k.startswith("encoder.") for k in sd)
    new = {}
    for k, v in own.items():
        src = k[len("encoder."):] if strip else k
        if src not in sd:
            if k.endswith("num_batches_tracked"):
                continue
            raise ValueError(f"{path}: no {src} for {name}")
        w = sd[src]
        if (name in _ENCODERS and k == "encoder.conv1.weight" and w.shape[1] != v.shape[1]
                and v.shape[1] % w.shape[1] == 0):
            rep = v.shape[1] // w.shape[1]
            w = torch.cat([w] * rep, dim=1) / rep
        if w.shape != v.shape:
            raise ValueError(f"{path}: {src} has shape {tuple(w.shape)}, {name} expects "
                             f"{tuple(v.shape)}")
        new[k] = w
    with torch.no_grad():
        for k, w in new.items():
            own[k].copy_(w)


def _load(base: str, stem: str, model: torch.nn.Module, name: str) -> bool:
    """Load `<base>/<stem>.pth` into `name`; False when there is no file."""
    if os.path.exists(os.path.join(base, f"{stem}.msgpack")):
        raise not_ported(f"{os.path.join(base, stem)}.msgpack: reading the JAX package's "
                         ".msgpack exports (flax serialization)", "trainer I/O")
    path = os.path.join(base, f"{stem}.pth")
    if not os.path.exists(path):
        return False
    load_torch_component(path, model, name)
    return True


def apply_pretraining(model: torch.nn.Module, model_cfg: Dict[str, Any],
                      download_model_dir: Optional[str] = None) -> None:
    """Load the weights that `backbone_pretraining`, `depth_pretraining`,
    `pose_pretraining` and `enable_imnet_encoder` name, in place (JAX
    `apply_pretraining`): `imnet` for the encoder and the pose encoder (a
    ResNet-18) and for the ImageNet encoder, then the `mono*` components,
    which override the ImageNet ones."""
    root = download_model_dir or "."
    if model_cfg.get("backbone_pretraining") == "imnet" or model_cfg.get(
            "enable_imnet_encoder", False):
        backbone = model_cfg.get("backbone_name", "resnet101")
        base = os.path.join(root, "imnet")
        targets = []
        if model_cfg.get("backbone_pretraining") == "imnet":
            targets += ["encoder", "pose_encoder"]
        if model_cfg.get("enable_imnet_encoder", False):
            targets.append("imnet_encoder")
        for name in targets:
            if name not in model.models:
                continue
            stem = "resnet18" if name == "pose_encoder" else backbone
            if not _load(base, stem, model, name):
                print(f"WARNING: imnet weights for {backbone} not found under {base}; "
                      f"{name} stays randomly initialized")

    for cfg_key, names in (("backbone_pretraining", ("encoder",)),
                           ("depth_pretraining", ("depth",)),
                           ("pose_pretraining", ("pose_encoder", "pose"))):
        pretrained = model_cfg.get(cfg_key)
        if not pretrained or pretrained in ("none", "imnet"):
            continue
        if "mono" not in pretrained:
            raise NotImplementedError(f"{cfg_key}={pretrained}")
        for name in names:
            if name in model.models and not _load(os.path.join(root, pretrained), name,
                                                  model, name):
                raise FileNotFoundError(
                    f"Pretrained component {name} for {pretrained} not found at "
                    f"{os.path.join(root, pretrained, name)}.pth")
