"""Trainer entry point of the port: `train_main(cfg)`.

Port of the training loop of the JAX package's `engine/trainer.py` for the
ported steps: it reads the same YAML schema, builds the joint model on the
device (and, with `training.unlabeled_segmentation`, its EMA teacher), draws
a labeled batch (and an unlabeled one) per step from `data.dataset:
synthetic`, and runs `training.train_iters` steps of
`engine/train_steps.py::train_step`, logging the losses of every step. With
`training.val_interval` it validates (`Run.validate`, through
`engine/train_steps.py::eval_step`) after every interval's last step and
after the last step, over `data.n_samples` synthetic images (default 16) in
batches of `training.val_batch_size`, made from fixed seeds, and keeps the
mIoU, the frequency-weighted accuracy and the best mIoU (a model without a
segmentation head reports the depth metrics and no mIoU). Before the
optimizer is built, `engine/checkpoints.py::apply_pretraining` loads the
weights that `model.*_pretraining` and `enable_imnet_encoder` name from the
`DOWNLOAD_MODEL_DIR` (`SDT_MODEL_DIR`, `config/machine.py`); after the last
step, `training.save_separate_monodepth_models` exports the SDE components
to `training.log_path` (the encoder unless `freeze_backbone`). With
`training.amp` the model computes in bf16 (`models/joint.py`). What the port
does not run yet raises NotImplementedError naming its ROADMAP item.
`training.disable_depth_estimator` is accepted and, as in the JAX package,
read by nothing.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional

import torch

from .. import not_ported
from ..config.machine import expand_cfg_vars, machine_paths
from ..data.synthetic import make_synthetic_batch, to_device_batch
from ..models.joint import build_model
from ..ops.metrics import AverageMeterDict, RunningScore
from .checkpoints import apply_pretraining, save_monodepth_models
from .optim import build_optimizer
from .state import make_teacher
from .train_steps import eval_step, step_config_from_cfg, train_step

logger = logging.getLogger("segsde_torch")

# unlabeled and validation batches are drawn from seeds this far from the
# labeled ones
_UNLABELED_SEED_OFFSET = 1_000_003
_VAL_SEED_OFFSET = 2_000_003


def _check_supported(cfg: Dict[str, Any]) -> None:
    data, training = cfg.get("data", {}), cfg["training"]
    if data.get("dataset") != "synthetic":
        raise not_ported(f"data.dataset {data.get('dataset')!r} (only 'synthetic')",
                         "trainer I/O")
    if training.get("early_stopping"):
        raise not_ported("training.early_stopping", "trainer I/O")
    for key in ("save_model", "resume", "auto_resume"):
        if training.get(key):
            raise not_ported(f"training.{key} (full-state checkpoints)", "trainer I/O")
    if training.get("save_separate_monodepth_models") and training.get("save_monodepth_ema"):
        raise not_ported("training.save_monodepth_ema (exporting the EMA teacher)",
                         "trainer I/O")


def current_val_interval(cfg: Dict[str, Any], step: int) -> int:
    """`training.val_interval` at `step`: an int, or a dict of step
    thresholds to intervals, whose interval for the largest threshold below
    `step` holds (the smallest threshold's before it; reference
    train.py:117-121)."""
    v = cfg["training"]["val_interval"]
    if isinstance(v, int):
        return v
    intervals = sorted(((int(k), int(val)) for k, val in v.items()), reverse=True)
    for k, val in intervals:
        if step > k:
            return val
    return intervals[-1][1]


@dataclasses.dataclass
class Run:
    """What a training run holds: the model (and EMA teacher) on the device,
    the optimizer, the step config, the step's generator, the batch source
    and the validation scores."""

    model: torch.nn.Module
    teacher: Optional[torch.nn.Module]
    optimizer: Any
    step_cfg: Any
    generator: torch.Generator
    device: str
    batch_size: int
    height: int
    width: int
    n_classes: int
    seed: int
    val_batch_size: int
    n_val_samples: int
    mIoU: float = 0.0
    fwAcc: float = 0.0
    best_iou: float = -100.0

    def _make(self, n, seed, unlabeled=False):
        return to_device_batch(make_synthetic_batch(
            n, self.height, self.width, frame_ids=self.step_cfg.frame_ids,
            num_scales=len(self.step_cfg.scales), n_classes=self.n_classes, seed=seed,
            with_unlabeled_extras=unlabeled), self.device)

    def batches(self, step: int):
        """The labeled batch of `step` (and its unlabeled batch, or None),
        made on the host from seeds and moved to the device."""
        batch = self._make(self.batch_size, self.seed + step)
        unlabeled = (self._make(self.batch_size, self.seed + step + _UNLABELED_SEED_OFFSET,
                                True) if self.step_cfg.unlabeled else None)
        return batch, unlabeled

    def val_batches(self):
        """The validation set, the same at every validation: `n_val_samples`
        images in batches of `val_batch_size` (the last one may be smaller)."""
        for i, start in enumerate(range(0, self.n_val_samples, self.val_batch_size)):
            n = min(self.val_batch_size, self.n_val_samples - start)
            yield self._make(n, self.seed + _VAL_SEED_OFFSET + i)

    def validate(self) -> Dict[str, float]:
        """Evaluate the model on the validation set (JAX `Trainer.validate`).

        Returns the batch means of the eval step's losses and depth metrics,
        with segmentation on `Mean IoU` and `fwAcc` of the summed confusion
        matrix, and `best_iou`; `eval_seconds_per_batch` is the host time
        from an eval step's start to its metrics on the host, which waits for
        the device, averaged over the batches.
        """
        meter = AverageMeterDict()
        running = RunningScore(self.n_classes)
        # the photometric tie-break noise: the same draws at every validation
        generator = torch.Generator(device=self.device).manual_seed(0)
        seconds = []
        for batch in self.val_batches():
            t0 = time.perf_counter()
            metrics, conf, _ = eval_step(self.model, batch, self.step_cfg, generator=generator)
            meter.update({k: float(v) for k, v in metrics.items()})
            running.update_matrix(conf)
            seconds.append(time.perf_counter() - t0)
        record = dict(meter.avgs)
        if self.step_cfg.segmentation_lambda > 0:
            score, _ = running.get_scores()
            self.mIoU = score["Mean IoU : \t"]
            self.fwAcc = score["FreqW Acc : \t"]
            record.update({"Mean IoU": self.mIoU, "fwAcc": self.fwAcc})
        self.best_iou = max(self.best_iou, self.mIoU)
        record.update(best_iou=self.best_iou,
                      eval_seconds_per_batch=sum(seconds) / len(seconds))
        return record

    def step(self, batch, unlabeled_batch) -> Dict[str, torch.Tensor]:
        return train_step(self.model, self.optimizer, batch, self.step_cfg,
                          generator=self.generator, unlabeled_batch=unlabeled_batch,
                          teacher=self.teacher)


def build_run(cfg: Dict[str, Any], device: str = "cuda:0") -> Run:
    """Check the config and build its run on `device`: expands the config's
    `MachineConfig.X` paths in place and loads the pretrained weights."""
    paths = machine_paths()
    expand_cfg_vars(cfg, paths)
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
    batch_size = training["batch_size"]
    model = build_model(cfg["model"], n_classes, amp=training.get("amp", False))
    apply_pretraining(model, cfg["model"], paths["DOWNLOAD_MODEL_DIR"])
    model = model.to(device)
    return Run(model=model, teacher=make_teacher(model) if step_cfg.use_ema else None,
               optimizer=build_optimizer(training, cfg["model"], model), step_cfg=step_cfg,
               generator=torch.Generator(device=device).manual_seed(seed), device=device,
               batch_size=batch_size,
               height=cfg["data"].get("crop_h", cfg["data"].get("height", 512)),
               width=cfg["data"].get("crop_w", cfg["data"].get("width", 1024)),
               n_classes=n_classes, seed=seed,
               val_batch_size=training.get("val_batch_size", batch_size),
               n_val_samples=cfg["data"].get("n_samples", 16))


def train_main(cfg: Dict[str, Any], device: str = "cuda:0",
               run: Optional[Run] = None) -> List[Dict[str, float]]:
    """Train the config's model for `training.train_iters` steps, on `run`
    (as `build_run(cfg, device)` makes it) or on a new one.

    Returns one record per step: its losses, `step_seconds` (host clock from
    the step's start to its losses on the host, which waits for the device)
    and `data_seconds` (making and moving the batch); after a validation also
    its record (`Run.validate`) under keys prefixed `val/`.
    """
    if run is None:
        run = build_run(cfg, device)
    training = cfg["training"]
    print_interval = training.get("print_interval", 100)
    logger.info("training %s on %s: batch %d at %dx%d, %d steps",
                cfg["model"].get("backbone_name", "resnet101"), device, run.batch_size,
                run.height, run.width, training["train_iters"])

    train_iters = training["train_iters"]
    validating = training.get("val_interval") is not None
    records = []
    for step in range(train_iters):
        t0 = time.perf_counter()
        batch, unlabeled_batch = run.batches(step)
        t1 = time.perf_counter()
        metrics = run.step(batch, unlabeled_batch)
        record = {k: float(v) for k, v in metrics.items()}
        record.update(step_seconds=time.perf_counter() - t1, data_seconds=t1 - t0)
        records.append(record)
        if (step + 1) % print_interval == 0:
            logger.info("Iter [%d/%d]  Loss: %.4f  seg %.4f  mono %.4f  step %.3f s",
                        step + 1, train_iters, record["total_loss"],
                        record["segmentation_loss"], record["mono_loss"],
                        record["step_seconds"])
        if validating and ((step + 1) % current_val_interval(cfg, step + 1) == 0
                           or step + 1 == train_iters):
            val = run.validate()
            record.update({f"val/{k}": v for k, v in val.items()})
            logger.info("Validation @%d: mIoU=%.4f  best %.4f  %.3f s per batch", step + 1,
                        run.mIoU, run.best_iou, val["eval_seconds_per_batch"])
    if training.get("save_separate_monodepth_models", False):
        # component export for the SDE transfer chain (reference train.py:377-390)
        log_path = training.get("log_path") or os.path.join(machine_paths()["LOG_DIR"], "run")
        save_monodepth_models(log_path, run.model,
                              include_encoder=not cfg["model"].get("freeze_backbone", False))
        logger.info("SDE components exported to %s", log_path)
    return records
