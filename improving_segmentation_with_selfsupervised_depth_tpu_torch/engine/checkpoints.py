"""Checkpoints of the port: pretrained weights in, SDE components out, and
the full training state for resuming.

Port of the JAX package's `engine/checkpoints.py`:
- `save_monodepth_models` and `apply_pretraining` with
  `engine/torch_interop.py::maybe_load_torch_component` (reference
  train.py:377-390, models/utils.py:18-97). A component file is the
  submodule's `state_dict()` in the reference layout:
  `<dir>/{encoder,depth,pose_encoder,pose}.pth`, which the JAX package's
  `apply_pretraining` reads too. ImageNet weights are torchvision's
  `<download_model_dir>/imnet/<backbone>.pth` (keys without the `encoder.`
  prefix; `fc.*` is not read). An encoder of more input frames than its file
  (the two-frame pose encoder from a ResNet-18) gets `conv1` repeated over
  the frames and divided by their count (reference
  models/resnet_encoder.py:57-60). Where the JAX package's own export lies
  (`<stem>.msgpack`, flax's msgpack format of `{params, batch_stats}`), it
  is read in its place, as the JAX package does, and mapped through
  `engine/interop.py::state_dict_from_jax`.
- `ResumeWriter.save_resume` / `load_resume` (reference train.py:360-410):
  the model, the EMA teacher, the optimizer's state (SGD's momentum, Adam's
  mu, nu; the step count that the lr schedule and the EMA read; the
  plateau's `lr_scale`) in one `torch.save` file, `<basename>.pth`, with a
  `<basename>.json` sidecar of `{step, best_iou}`. Writes are atomic (tmp +
  `os.replace`). One save writes several basenames (a validation's best and
  last) from one host snapshot. An asynchronous save copies the state to the
  host before it returns and writes the files on a thread; `wait_for_saves` joins it and
  re-raises its error. `load_resume` also reads the JAX package's
  full-state `.msgpack` (`save_resume`'s `{step, params, batch_stats,
  opt_state, lr_scale[, ema_params]}` with its `{step, best_iou}` sidecar):
  the model through `state_dict_from_jax`, the EMA teacher from
  `ema_params`, and the optax `opt_state` tree mapped onto the port's
  buffers by parameter name (`_opt_state_from_jax`). `load_model_only`
  restores the model alone, from either format.

There is no download: a missing `mono*` component raises FileNotFoundError,
a missing ImageNet file prints the JAX package's warning and leaves the
component as initialized.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import dist
from . import optim
from .interop import state_dict_from_jax

MONODEPTH_COMPONENTS = ("depth", "pose_encoder", "pose")
_ENCODERS = ("encoder", "pose_encoder", "imnet_encoder")


def save_component(ckpt_dir: str, model: torch.nn.Module, name: str,
                   params_from: Optional[torch.nn.Module] = None) -> str:
    """Write `model.models[name]`'s state_dict to `<ckpt_dir>/<name>.pth`;
    with `params_from` (the EMA teacher) its parameters in place of the
    model's, beside the model's buffers, as the JAX package exports the EMA
    parameters with the state's batch statistics."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.pth")
    sd = model.models[name].state_dict()
    if params_from is not None:
        params = dict(params_from.models[name].named_parameters())
        sd = {k: params.get(k, v) for k, v in sd.items()}
    torch.save({k: v.detach().cpu().clone() for k, v in sd.items()}, path)
    return path


def save_monodepth_models(ckpt_dir: str, model: torch.nn.Module,
                          include_encoder: bool = False,
                          params_from: Optional[torch.nn.Module] = None) -> None:
    """Export the SDE components the model has (reference train.py:377-390),
    with `params_from`'s parameters (`training.save_monodepth_ema`)."""
    for name in MONODEPTH_COMPONENTS + (("encoder",) if include_encoder else ()):
        if name in model.models:
            save_component(ckpt_dir, model, name, params_from)


def load_torch_component(path: str, model: torch.nn.Module, name: str) -> None:
    """Load a reference or torchvision `.pth` into `model.models[name]`, in
    place. Every tensor of the submodule must be in the file with its shape
    (BatchNorm's `num_batches_tracked` may be missing); other keys are not
    read."""
    _load_state(path, torch.load(path, map_location="cpu", weights_only=True), model, name)


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray ext payload: msgpack of (shape, dtype name, C-order
    bytes); bfloat16 (which numpy lacks) is widened to float32."""
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).float().numpy()
    else:
        flat = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    return flat.reshape(shape)


def _ext_unpack(code: int, data: bytes):
    """flax's msgpack ext types for arrays: 1 ndarray, 3 numpy scalar."""
    import msgpack

    if code == 1:
        return _ndarray(data)
    if code == 3:
        return _ndarray(data)[()]
    return msgpack.ExtType(code, data)


def read_msgpack(path: str) -> Dict[str, Any]:
    """A file in flax's msgpack serialization (`flax.serialization.to_bytes`)
    as a tree of dicts with numpy leaves. Leaves of more than 2^30 bytes,
    which flax splits into chunks, are not joined: no component has one."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_unpack, raw=False)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax msgpack tree")
    return tree


def load_msgpack_component(path: str, model: torch.nn.Module, name: str,
                           model_cfg: Dict[str, Any]) -> None:
    """Load the JAX package's component export (`{params[, batch_stats]}` of
    submodule `name`) into `model.models[name]`, in place, through
    `state_dict_from_jax`."""
    tree = read_msgpack(path)
    if "params" not in tree:
        raise ValueError(f"{path}: no params in the component tree (keys {sorted(tree)})")
    sd = state_dict_from_jax({name: tree["params"]}, {name: tree.get("batch_stats", {})},
                             model_cfg)
    prefix = f"models.{name}."
    _load_state(path, {k[len(prefix):]: v for k, v in sd.items()}, model, name)


def _load_state(path: str, sd: Dict[str, torch.Tensor], model: torch.nn.Module,
                name: str) -> None:
    """Copy the component state dict `sd` (read from `path`) into
    `model.models[name]`."""
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


def _load(base: str, stem: str, model: torch.nn.Module, name: str,
          model_cfg: Dict[str, Any]) -> bool:
    """Load `<base>/<stem>.msgpack` (the JAX package's export, first, as the
    JAX package reads it) or `<base>/<stem>.pth` into `name`; False when
    there is neither."""
    path = os.path.join(base, f"{stem}.msgpack")
    if os.path.exists(path):
        load_msgpack_component(path, model, name, model_cfg)
        return True
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
            if not _load(base, stem, model, name, model_cfg):
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
                                                  model, name, model_cfg):
                raise FileNotFoundError(
                    f"Pretrained component {name} for {pretrained} not found at "
                    f"{os.path.join(root, pretrained, name)}.pth")


def _to_host(tree):
    """A copy of `tree` with every tensor detached and copied to the CPU."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _sidecar(ckpt_path: str) -> str:
    stem, ext = os.path.splitext(ckpt_path)
    return stem + ".json" if ext in (".pth", ".msgpack") else os.path.join(
        os.path.dirname(ckpt_path), "best_model.json")


class ResumeWriter:
    """Writes full-state checkpoints, at most one save in flight: a save
    first joins the previous one, so files land in order and one host
    snapshot at most waits for its write. `snapshot_seconds` and
    `write_seconds` are the last save's copy to the host (the part the
    caller waits for) and its file writes (on the thread when asynchronous).
    Over more than one rank (`parallel/dist.py`) rank 0 alone writes, from
    the unwrapped student (the keys of one process's checkpoint), and
    `wait_for_saves` ends at a barrier, so that every rank then finds the
    files in place."""

    def __init__(self):
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.snapshot_seconds = 0.0
        self.write_seconds = 0.0

    def wait_for_saves(self) -> None:
        """Block until the write in flight has landed; re-raise its error (a
        lost best or last checkpoint loses the run's recovery point)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def save_resume(self, ckpt_dir: str, model: torch.nn.Module,
                    teacher: Optional[torch.nn.Module], optimizer, best_iou: float,
                    async_write: bool = False,
                    basenames: Sequence[str] = ("best_model",)) -> List[str]:
        """Save the training state to `<ckpt_dir>/<basename>.pth` and its
        `{step, best_iou}` sidecar for each of `basenames`, in order, from one
        host snapshot (JAX `save_resume`, once per file with the same state);
        `step` is the optimizer's step count. Returns the paths."""
        self.wait_for_saves()
        paths = [os.path.join(ckpt_dir, b + ".pth") for b in basenames]
        if not dist.is_main():
            return paths
        os.makedirs(ckpt_dir, exist_ok=True)
        t0 = time.perf_counter()
        payload = {"step": optimizer.step_count, "model": model.state_dict(),
                   "optimizer": optimizer.state_dict()}
        if teacher is not None:
            payload["teacher"] = teacher.state_dict()
        payload = _to_host(payload)
        meta = {"step": optimizer.step_count, "best_iou": float(best_iou)}
        self.snapshot_seconds = time.perf_counter() - t0

        def write():
            t1 = time.perf_counter()
            for i, path in enumerate(paths):
                # the first file is serialized, the others are copies of it
                if i == 0:
                    torch.save(payload, path + ".tmp")
                else:
                    shutil.copyfile(paths[0], path + ".tmp")
                os.replace(path + ".tmp", path)
                side = _sidecar(path)
                with open(side + ".tmp", "w") as f:
                    json.dump(meta, f)
                os.replace(side + ".tmp", side)
            self.write_seconds = time.perf_counter() - t1

        def write_async():
            try:
                write()
            except Exception as e:  # re-raised by wait_for_saves on the caller's thread
                self._error = e

        if async_write:
            self._pending = threading.Thread(target=write_async, daemon=True)
            self._pending.start()
        else:
            write()
        return paths


def _load_model(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                load_model_only: bool) -> None:
    """`sd` into `model`, every tensor of the model from the file; with
    `load_model_only` the file's other tensors are not read (a pose-free
    model for inference from a run with a pose network, as flax's
    `from_state_dict` reads only the template's keys)."""
    if load_model_only:
        own = model.state_dict()
        sd = {k: v for k, v in sd.items() if k in own}
    model.load_state_dict(sd)


def load_resume(ckpt_path: str, model: torch.nn.Module, teacher: Optional[torch.nn.Module],
                optimizer, model_cfg: Optional[Dict[str, Any]] = None,
                load_model_only: bool = False) -> Tuple[int, float]:
    """Restore `ResumeWriter.save_resume`'s file, or the JAX package's
    full-state `.msgpack`, into the model, the teacher and the optimizer, in
    place (JAX `load_resume`); `model_cfg` (the run's `model` section) maps
    a JAX tree. With `load_model_only` the model's parameters and
    statistics alone, as JAX's, where the file may hold more (a pose
    network the model was built without). Returns (step, best_iou), from the sidecar
    where there is one."""
    if ckpt_path.endswith(".msgpack"):
        step = _load_jax_resume(ckpt_path, model, teacher, optimizer, model_cfg or {},
                                load_model_only)
    else:
        raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        _load_model(model, raw["model"], load_model_only)
        if not load_model_only:
            optimizer.load_state_dict(raw["optimizer"])
            if teacher is not None and "teacher" in raw:
                teacher.load_state_dict(raw["teacher"])
        step = int(raw["step"])
    best_iou = -100.0
    meta_path = _sidecar(ckpt_path)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        best_iou = meta.get("best_iou", -100.0)
        step = meta.get("step", step)
    return step, best_iou


def _load_jax_resume(path: str, model: torch.nn.Module, teacher: Optional[torch.nn.Module],
                     optimizer, model_cfg: Dict[str, Any], load_model_only: bool) -> int:
    """The JAX package's full-state `.msgpack` into the model, the EMA
    teacher and the optimizer (see `load_resume`). Returns the file's step."""
    raw = read_msgpack(path)
    params, stats = raw["params"], raw.get("batch_stats", {})
    _load_model(model, state_dict_from_jax(params, stats, model_cfg), load_model_only)
    if load_model_only:
        return int(raw["step"])
    _opt_state_from_jax(raw["opt_state"], params, stats, optimizer, model_cfg)
    optimizer.lr_scale = float(raw.get("lr_scale", 1.0))
    if teacher is not None and "ema_params" in raw:
        teacher.load_state_dict(state_dict_from_jax(raw["ema_params"], stats, model_cfg))
    return int(raw["step"])


# the optax state of each core, as `flax.serialization.to_state_dict` writes
# it: buffer kinds over the whole parameter tree (other groups' leaves masked
# to {}), and the port's name for each
_JAX_CORE_KINDS = {optim.SGD: {"trace": "momentum"}, optim.Adam: {"mu": "mu", "nu": "nu"},
                   optim.Adamax: {"mu": "mu", "nu": "nu"},
                   optim.Adadelta: {"e_g": "e_g", "e_x": "e_x"},
                   optim.Adagrad: {"sum_of_squares": "sum_of_squares"},
                   optim.RMSprop: {"nu": "nu"}}
_SCALAR = ()  # a leaf of shape () in a template


def _core_kinds(optimizer) -> Dict[str, str]:
    """The optax buffer kinds of `optimizer`'s core -> the port's names
    (none for SGD without momentum, whose core is optax's identity)."""
    if isinstance(optimizer, optim.SGD) and not optimizer.momentum:
        return {}
    return _JAX_CORE_KINDS[type(optimizer)]


def _jax_labels(tree: Dict[str, Any], model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """JAX `build_param_labels` on a parameter tree."""
    def walk(t, top, second):
        if isinstance(t, dict):
            return {k: walk(v, top, k if top == "mtl_decoder" and second is None else second)
                    for k, v in t.items()}
        return optim.frozen_label(top, second, model_cfg)

    return {k: walk(v, k, None) for k, v in tree.items()}


def _masked(params: Dict[str, Any], labels: Dict[str, Any], group: str):
    """`params`'s shapes where `labels` is `group`, {} (optax's MaskedNode)
    elsewhere."""
    if isinstance(params, dict):
        return {k: _masked(v, labels[k], group) for k, v in params.items()}
    return tuple(np.shape(params)) if labels == group else {}


def _opt_template(optimizer, params: Dict[str, Any], labels: Dict[str, Any]):
    """The optax state tree that JAX `build_optimizer` builds for the port's
    optimizer: shapes at the leaves."""
    wd = [{}] if optimizer.weight_decay else []
    inner = {}
    for group in sorted(set(_leaves(labels))):
        if group == optim.FROZEN:
            inner[group] = {"inner_state": {}}  # set_to_zero
            continue
        masked = _masked(params, labels, group)
        if isinstance(optimizer, optim.ASGD):
            state = {"count": _SCALAR, "eta": _SCALAR}
            state = {"0": {}, "1": state} if wd else state
        else:
            kinds = _core_kinds(optimizer)
            core = {k: masked for k in kinds}
            if isinstance(optimizer, optim.Adam):  # and Adamax: ScaleByAdamState
                core["count"] = _SCALAR
            parts = wd + ([core] if kinds else [])
            state = {"0": {str(i): part for i, part in enumerate(parts)},
                     "1": {"count": _SCALAR}}  # scale_by_schedule
        inner[group] = {"inner_state": state}
    tree = {"inner_states": inner}
    return {"0": {}, "1": tree} if optimizer.clip_grad_norm is not None else tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _match(template, tree, path: str = "opt_state") -> None:
    """Raise, naming the first path where `tree` differs from `template`
    (flax `from_state_dict`'s check)."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            keys = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path}: the optimizer the config builds has keys "
                             f"{sorted(template)}, the file {keys}")
        for k in sorted(template):
            _match(template[k], tree[k], f"{path}/{k}")
    elif isinstance(tree, dict) or tuple(np.shape(tree)) != template:
        got = "{}" if isinstance(tree, dict) else f"shape {tuple(np.shape(tree))}"
        raise ValueError(f"{path}: the optimizer the config builds has shape {template}, "
                         f"the file {got}")


def _merge(trees: List[Any], params):
    """One tree of `params`'s structure from group trees whose other
    groups' leaves are {}; zeros where no group has the leaf (frozen)."""
    if isinstance(params, dict):
        return {k: _merge([t[k] for t in trees], v) for k, v in params.items()}
    for t in trees:
        if not isinstance(t, dict):
            return t
    return np.zeros(np.shape(params), np.float32)


def _opt_state_from_jax(opt_state: Dict[str, Any], params: Dict[str, Any],
                        stats: Dict[str, Any], optimizer, model_cfg: Dict[str, Any]) -> None:
    """Map the optax `opt_state` of a JAX `save_resume` file onto the port's
    optimizer by parameter name: `multi_transform` holds one inner state per
    group label; SGD's `trace` is the momentum, `scale_by_adam` holds `mu`,
    `nu` and `count`; the `scale_by_schedule` count is the step; the clip's
    state is empty; asgd holds `count` and `eta` per group."""
    labels = _jax_labels(params, model_cfg)
    _match(_opt_template(optimizer, params, labels), opt_state)
    inner = (opt_state["1"] if optimizer.clip_grad_norm is not None else opt_state)
    states = {g: v["inner_state"] for g, v in inner["inner_states"].items()
              if g != optim.FROZEN}
    own = {g["label"] for g in optimizer.groups}
    if set(states) != own:
        raise ValueError(f"opt_state/inner_states: groups {sorted(states)}, the optimizer "
                         f"trains {sorted(own)}")
    sd: Dict[str, Any] = {"lr_scale": optimizer.lr_scale, "state": {}}
    if isinstance(optimizer, optim.ASGD):
        def unwrap(s):
            return s["1"] if optimizer.weight_decay else s

        sd["groups"] = {g: {"eta": float(unwrap(s)["eta"])} for g, s in states.items()}
        sd["step_count"] = int(unwrap(next(iter(states.values())))["count"])
    else:
        sd["step_count"] = int(next(iter(states.values()))["1"]["count"])
        # the core follows add_decayed_weights' empty state in the chain
        cores = [s["0"][str(1 if optimizer.weight_decay else 0)] for s in states.values()
                 ] if _core_kinds(optimizer) else []
        names = {name for g in optimizer.groups for name in g["names"]}
        for jax_kind, kind in _core_kinds(optimizer).items():
            tree = _merge([c[jax_kind] for c in cores], params)
            converted = state_dict_from_jax(tree, stats, model_cfg)
            for name in names:
                sd["state"].setdefault(name, {})[kind] = converted[name]
    optimizer.load_state_dict(sd)
