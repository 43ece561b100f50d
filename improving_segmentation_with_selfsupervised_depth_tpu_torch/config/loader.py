"""YAML config loading and the shared monodepth_options merge: the port's
copy of the JAX package's `config/loader.py` (reference train.py:156-160,
926-936). `expand_cfg_vars` lives in `config/machine.py`."""

from __future__ import annotations

from typing import Any, Dict

import yaml

from .machine import expand_cfg_vars, machine_paths

__all__ = ["expand_cfg_vars", "load_config", "merge_monodepth_options"]


def merge_monodepth_options(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Merge the shared monodepth_options block into the model and data
    sections, in place, without overriding their own keys (reference
    train.py:156-160)."""
    mono = cfg.get("monodepth_options", {})
    for section in ("model", "data"):
        cfg.setdefault(section, {})
        for k, v in mono.items():
            cfg[section].setdefault(k, v)
    return cfg


def load_config(path: str, machine: str = "ws") -> Dict[str, Any]:
    """The YAML config at `path` with its `MachineConfig.X` and $ENV strings
    expanded and the monodepth options merged (`machine` where the file
    names none)."""
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg.setdefault("machine", machine)
    expand_cfg_vars(cfg, machine_paths(cfg["machine"]))
    return merge_monodepth_options(cfg)
