"""Offline pseudo-depth (reference loader/depth_estimator.py:15-93).

Port of the JAX package's `engine/depth_estimator.py`: builds a seg-less,
pose-less depth model from the configured SDE checkpoint, runs its pose-free
`predict_test_disp` over the train and validation splits at batch 4 in eval
mode without gradient, and writes each image's min-max-normalized disparity
as an 8-bit PNG under `generated_depth_dir` (idempotent: a batch whose PNGs
all exist is skipped, and an existing file is never rewritten).

The 8-bit quantization of the pseudo-depth is load-bearing in the reference
(SURVEY §7.6): the normalization is numpy's f32 arithmetic with a 1e-12
floor, and `round` rounds half to even, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from copy import deepcopy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config.machine import machine_paths
from ..data.loader import DataLoader, to_device_batch
from ..data.registry import build_loader
from ..models.joint import build_model
from ..ops.photometric import key_of
from .checkpoints import apply_pretraining


def decoder_variant(cfg: Dict[str, Any], dec: int, crop) -> Dict[str, Any]:
    """The decoder preset shared with the experiment generator (reference
    experiments.py:8-30), in place. Returns (cfg, load_backbone)."""
    cfg["model"]["replace_stride_with_dilation"] = [False, False, True]
    if dec in (5, 6):
        cfg["model"]["depth_args"] = {
            "intermediate_aspp": True,
            "aspp_rates": [6, 12, 18],
            "num_ch_dec": [64, 128, 128, 256, 256],
            "max_scale_size": list(crop),
        }
        load_backbone = dec == 6
    elif dec == 9:
        cfg["model"]["depth_args"] = {
            "intermediate_aspp": True,
            "aspp_rates": [6, 12, 18],
            "num_ch_dec": [64, 64, 128, 128, 256],
            "batch_norm": True,
            "max_scale_size": list(crop),
        }
        load_backbone = False
    else:
        raise NotImplementedError(dec)
    return cfg, load_backbone


# How an experiment config becomes its depth teacher (reference
# loader/depth_estimator.py:15-40), as data: section -> {key: value}, where
# _DROP removes the key. The teacher is a pose-free, seg-less depth model on
# whole, un-augmented images.
_DROP = object()
_TEACHER_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "model": {
        "arch": "joint_segmentation_depth",
        "segmentation_name": None,
        "disable_monodepth": False,
        "disable_pose": True,
    },
    "data": {
        "augmentations": {},
        "crop_h": _DROP,
        "crop_w": _DROP,
    },
}


def _teacher_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Apply `_TEACHER_OVERRIDES`, then point the backbone's and the depth
    decoder's pretraining at the one weight source (`data.depth_teacher`, a
    ResNet-101 dec6 SDE checkpoint, or `model.depth_estimator_weights`)."""
    cfg = deepcopy(cfg)
    for section, overrides in _TEACHER_OVERRIDES.items():
        for key, value in overrides.items():
            if value is _DROP:
                cfg[section].pop(key, None)
            else:
                cfg[section][key] = value
    teacher = cfg["data"].get("depth_teacher")
    own = cfg["model"].get("depth_estimator_weights")
    if teacher is not None and own is not None:
        raise ValueError("data.depth_teacher and model.depth_estimator_weights are "
                         "mutually exclusive")
    if teacher is not None:
        cfg["model"]["backbone_name"] = "resnet101"
        cfg, _ = decoder_variant(cfg, 6, (512, 512))
    source = teacher if teacher is not None else own
    if source is not None:
        for key in ("backbone_pretraining", "depth_pretraining"):
            cfg["model"][key] = source
    if cfg["model"].get("depth_pretraining") != cfg["model"].get("backbone_pretraining"):
        raise ValueError("the depth teacher needs one pretraining source for its backbone "
                         "and its depth decoder")
    return cfg


class DepthEstimator:
    """The depth teacher over the config's train and validation splits, on
    `device`. `prepare_depth_estimates` writes the PNGs; the model is built
    and its weights loaded at the first batch that needs them."""

    def __init__(self, cfg: Dict[str, Any], device: str = "cuda:0"):
        cfg = _teacher_cfg(cfg)
        self.cfg = cfg
        self.device = device
        self.depth_dir = cfg["data"]["generated_depth_dir"]
        data_cfg = dict(cfg["data"])
        data_cfg.update({"restrict_to_subset": None, "generated_depth_dir": None})
        self.train_ds = build_loader(data_cfg, "train", load_labels=False,
                                     load_sequence=False)
        self.val_ds = build_loader(data_cfg, data_cfg.get("val_split", "val"),
                                   load_labels=False, load_sequence=False)
        self.n_classes = self.train_ds.n_classes
        self.model: Optional[torch.nn.Module] = None
        # host time of each written batch, from its forward (the first's
        # includes the model's build) to its PNGs on disk
        self.batch_seconds: List[float] = []

    def build_filename(self, subname: str) -> str:
        return os.path.join(self.depth_dir, subname.replace(".jpg", ".png"))

    def _init_model(self) -> None:
        # a forked RNG: the teacher's random init (then overwritten by its
        # weights) must not move the caller's torch stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model(self.cfg["model"], self.n_classes)
        apply_pretraining(model, self.cfg["model"], machine_paths()["DOWNLOAD_MODEL_DIR"])
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def prepare_depth_estimates(self) -> int:
        """Write the missing PNGs. Returns how many it wrote."""
        written = 0
        color = key_of("color", 0, 0)
        for ds in (self.train_ds, self.val_ds):
            loader = DataLoader(ds, 4, shuffle=False, drop_last=False,
                                num_workers=self.cfg["training"].get("n_workers", 2),
                                pin_memory=torch.device(self.device).type == "cuda")
            try:
                for batch in loader:
                    if all(os.path.isfile(self.build_filename(f)) for f in batch["filename"]):
                        continue
                    t0 = time.perf_counter()
                    if self.model is None:
                        self._init_model()
                    images = to_device_batch({color: batch[color]}, self.device)
                    disp = self.model.predict_test_disp(images)["disp_0"][:, 0]
                    disp = disp.float().cpu().numpy()
                    written += self._write(batch["filename"], disp)
                    self.batch_seconds.append(time.perf_counter() - t0)
            finally:
                loader.close()
        return written

    def _write(self, subnames, disp: np.ndarray) -> int:
        from PIL import Image

        written = 0
        for subname, d in zip(subnames, disp):
            filename = self.build_filename(subname)
            os.makedirs(os.path.dirname(filename), exist_ok=True)
            dmin, dmax = d.min(), d.max()
            norm = (d - dmin) / max(dmax - dmin, 1e-12)
            img = Image.fromarray((norm * 255).round().astype(np.uint8), "L")
            if not os.path.isfile(filename):
                img.save(filename)
                written += 1
        return written
