"""Trainer entry point of the port: `train_main(cfg)`.

Port of the training loop of the JAX package's `engine/trainer.py` for the
supervised slice: it reads the same YAML schema, builds the joint model on the
device, draws batches from `data.dataset: synthetic`, and runs
`training.train_iters` steps of `engine/train_steps.py::train_step`, logging
the losses of every step. What the slice does not run yet raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

import torch

from .. import not_ported
from ..data.synthetic import make_synthetic_batch, to_device_batch
from ..models.joint import build_model
from .optim import build_optimizer
from .train_steps import step_config_from_cfg, train_step

logger = logging.getLogger("segsde_torch")


def _check_supported(cfg: Dict[str, Any]) -> None:
    data, training = cfg.get("data", {}), cfg["training"]
    if data.get("dataset") != "synthetic":
        raise not_ported(f"data.dataset {data.get('dataset')!r} (only 'synthetic')",
                         "trainer I/O")
    if training.get("val_interval") is not None:
        raise not_ported("training.val_interval (validation)", "eval")
    for key in ("save_model", "save_separate_monodepth_models", "resume", "auto_resume"):
        if training.get(key):
            raise not_ported(f"training.{key} (checkpoints)", "trainer I/O")
    for key in ("backbone_pretraining", "depth_pretraining", "pose_pretraining"):
        if cfg["model"].get(key, "none") not in (None, "none"):
            raise not_ported(f"model.{key} (pretrained weights)", "trainer I/O")


def train_main(cfg: Dict[str, Any], device: str = "cuda:0") -> List[Dict[str, float]]:
    """Train the config's model for `training.train_iters` steps.

    Returns one record per step: its losses, `step_seconds` (host clock from
    the step's start to its losses on the host, which waits for the device)
    and `data_seconds` (making and moving the batch).
    """
    mono = cfg.get("monodepth_options", {})
    for section in ("data", "model"):  # shared options (reference train.py:156-160)
        cfg.setdefault(section, {})
        for k, v in mono.items():
            cfg[section].setdefault(k, v)
    _check_supported(cfg)
    training = cfg["training"]
    seed = cfg.get("seed", 42)
    torch.manual_seed(seed)
    step_cfg = step_config_from_cfg(cfg)
    n_classes = cfg["data"].get("n_classes", 19)
    model = build_model(cfg["model"], n_classes).to(device)
    optimizer = build_optimizer(training, cfg["model"], model)
    generator = torch.Generator(device=device).manual_seed(seed)
    bs = training["batch_size"]
    h = cfg["data"].get("crop_h", cfg["data"].get("height", 512))
    w = cfg["data"].get("crop_w", cfg["data"].get("width", 1024))
    print_interval = training.get("print_interval", 100)
    logger.info("training %s on %s: batch %d at %dx%d, %d steps",
                cfg["model"].get("backbone_name", "resnet101"), device, bs, h, w,
                training["train_iters"])

    records = []
    for step in range(training["train_iters"]):
        t0 = time.perf_counter()
        batch = to_device_batch(make_synthetic_batch(
            bs, h, w, frame_ids=step_cfg.frame_ids, num_scales=len(step_cfg.scales),
            n_classes=n_classes, seed=seed + step), device)
        t1 = time.perf_counter()
        metrics = train_step(model, optimizer, batch, step_cfg, generator=generator)
        record = {k: float(v) for k, v in metrics.items()}
        record.update(step_seconds=time.perf_counter() - t1, data_seconds=t1 - t0)
        records.append(record)
        if (step + 1) % print_interval == 0:
            logger.info("Iter [%d/%d]  Loss: %.4f  seg %.4f  mono %.4f  step %.3f s",
                        step + 1, training["train_iters"], record["total_loss"],
                        record["segmentation_loss"], record["mono_loss"],
                        record["step_seconds"])
    return records
