"""Machine-dependent paths and their expansion in configs.

The port's copy of the JAX package's `config/machine.py` (`MachineConfig("ws")`)
and `config/loader.py::expand_cfg_vars`: the paths come from environment
variables, read when `machine_paths()` is called, with defaults under
./datasets and ./results. `DOWNLOAD_MODEL_DIR` (`SDT_MODEL_DIR`) holds the
pretrained weights, `<dir>/imnet/<backbone>.pth` and `<dir>/<name>/<component>.pth`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


def machine_paths(machine: str = "ws") -> Dict[str, str]:
    """The `MachineConfig` attributes of `machine` (only "ws" is known, as
    in the JAX package)."""
    if machine != "ws":
        raise NotImplementedError(f"Unknown machine {machine}")
    data = os.environ.get("SDT_DATA_DIR", "datasets")
    out = os.environ.get("SDT_OUT_DIR", "results")
    env = os.environ.get
    return {
        "CITYSCAPES_DIR": env("CITYSCAPES_DIR", os.path.join(data, "cityscapes")),
        "CAMVID_DIR": env("CAMVID_DIR", os.path.join(data, "camvid")),
        "MAPILLARY_DIR": env("MAPILLARY_DIR", os.path.join(data, "mapillary")),
        "LOG_DIR": env("SDT_LOG_DIR", os.path.join(out, "logs")),
        "GENERATED_DEPTH_DIR": env("SDT_GEN_DEPTH_DIR", os.path.join(out, "generated_depth")),
        "DOWNLOAD_MODEL_DIR": env("SDT_MODEL_DIR", os.path.join(out, "models")),
    }


def expand_cfg_vars(cfg: Dict[str, Any], paths: Optional[Dict[str, str]] = None) -> None:
    """In place: `MachineConfig.X[/rest]` -> the path X + rest, and $ENV
    variables, in every string value (reference train.py:926-936)."""
    paths = machine_paths() if paths is None else paths
    for k, v in cfg.items():
        if isinstance(v, dict):
            expand_cfg_vars(v, paths)
        elif isinstance(v, str):
            if "MachineConfig." in v:
                var = v.split(".")[1].split("/")[0]
                v = paths[var] + v[len("MachineConfig.") + len(var):]
            cfg[k] = os.path.expandvars(v)
