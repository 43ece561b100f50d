"""Trainer of the port: `build_run(cfg)` and `train_main(cfg)`.

Port of the JAX package's `engine/trainer.py` (`Trainer`, l. 103-406, and
`train_main`, l. 560-587; reference train.py:154-963). It reads the same
YAML schema and builds, on the device, the joint model (with
`training.unlabeled_segmentation`, its EMA teacher), the optimizer and the
step config, and on the host the datasets of `data.dataset` through
`data/registry.py::build_loader` with their threaded loaders
(`data/loader.py`): the labeled train loader, the validation loader and,
for the semi-supervised step, the unlabeled loader, composed as the JAX
trainer composes them (`only_unlabeled`, `only_labeled`, `mix_video`,
`mix_use_gt`'s one-hot labels). On a CUDA device the loaders stack batches
into pinned memory and the trainer copies them with `non_blocking=True`.

The loop is the JAX trainer's, step for step: it starts from the resumed
iteration (0), counts a step before running it, validates when
`(step + 1) % current_val_interval(step + 1) == 0` and at
`step + 1 == train_iters`, and stops there, so a run from scratch takes
`train_iters - 1` steps. After a validation it compares the mIoU with the
best (`>=`) and saves the best checkpoint, then the rolling `last_model`,
then takes the plateau step (`reduce_lr_on_plateau`'s `lr_scale`), then
early stopping. The step's losses stay on the device until
`print_interval`, where they are averaged, logged and written
(`engine/writer.py`: `training/*`; after a validation `validation/*` and
`val_metrics/*`); with `unlabeled_segmentation.debug_images` the step's
`debug/*` tensors are drawn there too (`Run.dump_mix_debug`), and are
otherwise dropped unread. `resume` (the port's `.pth` or the JAX package's full-state
`.msgpack`) and `auto_resume` (`<log_path>/last_model.pth`) restore the
state and the iteration (`engine/checkpoints.py`). With `data.depth_teacher`,
or a depth mix mask from offline depth, on files (not `synthetic`),
`build_run` first has the depth teacher write the pseudo-depth PNGs that
the loaders read (`engine/depth_estimator.py`).
`training.save_separate_monodepth_models` exports the SDE components after
the last step (the EMA teacher's parameters with `save_monodepth_ema`).
With `training.amp` the model computes in bf16 (`models/joint.py`).
What the port does not run yet raises NotImplementedError naming its
ROADMAP item; `training.disable_depth_estimator` is read by nothing, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import yaml

from ..config.loader import merge_monodepth_options
from ..config.machine import expand_cfg_vars, machine_paths
from ..data.loader import DataLoader, infinite_iterator, to_device_batch
from ..data.registry import build_loader
from ..models.joint import build_model
from ..ops.metrics import AverageMeterDict, RunningScore
from ..utils.misc import get_logger, set_seeds
from .checkpoints import ResumeWriter, apply_pretraining, load_resume, save_monodepth_models
from .depth_estimator import DepthEstimator
from .early_stopping import EarlyStopping
from .optim import build_optimizer
from .state import make_teacher
from .train_steps import eval_step, step_config_from_cfg, train_step
from .writer import MetricsWriter

logger = logging.getLogger("segsde_torch")


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


def _colorize(img: np.ndarray, cmap: str = "plasma") -> np.ndarray:
    """A depth or disparity map as RGB (reference train.py:137-151): the
    matplotlib colormap where matplotlib is installed, else gray."""
    img = np.asarray(img, np.float64).squeeze()
    vmin, vmax = float(np.min(img)), float(np.max(img))
    norm = np.clip(img, vmin, vmax) / max(vmax, 1e-12)
    if importlib.util.find_spec("matplotlib") is None:
        return np.stack([norm, norm, norm], axis=-1)
    import matplotlib

    return matplotlib.colormaps[cmap](norm)[..., :3]


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@dataclasses.dataclass
class Run:
    """What a training run holds: its config, the model (and EMA teacher) on
    the device, the optimizer, the step config and the step's generator, the
    loaders, the run's files (log path, metrics writer, checkpoint writer),
    the plateau and early-stopping state and the validation scores."""

    cfg: Dict[str, Any]
    model: torch.nn.Module
    teacher: Optional[torch.nn.Module]
    optimizer: Any
    step_cfg: Any
    generator: torch.Generator
    device: str
    train_loader: DataLoader
    val_loader: DataLoader
    unlabeled_loader: Optional[DataLoader]
    n_classes: int
    batch_size: int
    height: int
    width: int
    log_path: str
    writer: MetricsWriter
    checkpoints: ResumeWriter
    plateau: Optional[Dict[str, Any]] = None
    early_stopping: Optional[EarlyStopping] = None
    run_id: str = "run"
    mIoU: float = 0.0
    fwAcc: float = 0.0
    best_iou: float = -100.0
    start_iter: int = 0
    unlabeled_iter: Optional[Iterator] = None
    _extra_iter: Optional[Iterator] = None
    _said_no_matplotlib: bool = False

    def __post_init__(self):
        if self.unlabeled_loader is not None:
            self.unlabeled_iter = infinite_iterator(self.unlabeled_loader)

    def to_device(self, host_batch) -> Dict[str, torch.Tensor]:
        return to_device_batch(host_batch, self.device)

    def next_unlabeled(self) -> Optional[Dict[str, torch.Tensor]]:
        """The next unlabeled batch on the device (None without one)."""
        if self.unlabeled_iter is None:
            return None
        return self.to_device(next(self.unlabeled_iter))

    def device_batches(self):
        """The next labeled batch (and unlabeled batch, or None) on the
        device, from the loaders, outside the training loop (for profiling
        and checks)."""
        if self._extra_iter is None:
            self._extra_iter = infinite_iterator(self.train_loader)
        return self.to_device(next(self._extra_iter)), self.next_unlabeled()

    def val_batches(self):
        """The validation set on the device, batch by batch, in order."""
        for host in self.val_loader:
            yield self.to_device(host)

    def step(self, batch, unlabeled_batch) -> Dict[str, torch.Tensor]:
        return train_step(self.model, self.optimizer, batch, self.step_cfg,
                          generator=self.generator, unlabeled_batch=unlabeled_batch,
                          teacher=self.teacher)

    def validate(self, step: int) -> Dict[str, float]:
        """Evaluate the model on the validation set (JAX `Trainer.validate`)
        after step `step`, write the validation scalars and images at
        `step + 1`, and set `mIoU` and `fwAcc` (not `best_iou`: the loop
        compares and saves).

        Returns the batch means of the eval step's losses and depth metrics,
        with segmentation `Mean IoU` and `fwAcc` of the summed confusion
        matrix; `eval_seconds_per_batch` is the host time from an eval
        step's start to its metrics on the host, which waits for the device,
        averaged over the batches.
        """
        training = self.cfg["training"]
        meter = AverageMeterDict()
        running = RunningScore(self.n_classes)
        # the photometric tie-break noise: the same draws at every validation
        generator = torch.Generator(device=self.device).manual_seed(0)
        n_imgs = training.get("n_tensorboard_imgs", 20)
        imgs_to_save, seconds = [], []
        for host in self.val_loader:
            batch = self.to_device(host)
            t0 = time.perf_counter()
            metrics, conf, aux = eval_step(self.model, batch, self.step_cfg, generator=generator)
            meter.update({k: float(v) for k, v in metrics.items()})
            running.update_matrix(conf)
            seconds.append(time.perf_counter() - t0)
            if len(imgs_to_save) < n_imgs:
                imgs = _host(host["color_aug_0_0"])
                gts = _host(host["lbl"]) if "lbl" in host else None
                preds = _host(aux["pred"]) if "pred" in aux else None
                disps = _host(aux["disp_0"].float()) if "disp_0" in aux else None
                for j in range(imgs.shape[0]):
                    if len(imgs_to_save) >= n_imgs:
                        break
                    imgs_to_save.append(tuple(None if a is None else a[j]
                                              for a in (imgs, gts, preds, disps)))
        self._log_val_images(imgs_to_save, step)
        record = dict(meter.avgs)
        for k, v in meter.avgs.items():
            self.writer.add_scalar("validation/" + k, v, step + 1)
        if training.get("segmentation_lambda", 1.0) > 0:
            score, class_iou = running.get_scores()
            for k, v in score.items():
                self.writer.add_scalar(f"val_metrics/{k.strip()}", v, step + 1)
            for k, v in class_iou.items():
                self.writer.add_scalar(f"val_metrics/cls_{k}", v, step + 1)
            self.mIoU = score["Mean IoU : \t"]
            self.fwAcc = score["FreqW Acc : \t"]
            record.update({"Mean IoU": self.mIoU, "fwAcc": self.fwAcc})
        record["eval_seconds_per_batch"] = sum(seconds) / len(seconds)
        return record

    def _log_val_images(self, imgs_to_save, step: int) -> None:
        """Input / GT / prediction / colorized depth per sample (reference
        train.py:904-923)."""
        decode = self.val_loader.dataset.decode_segmap_tocolor
        for j, (img, gt, pred, disp) in enumerate(imgs_to_save):
            prefix = f"{self.run_id.replace('/', '_')}/{j}"
            self.writer.add_image(f"{prefix}_0image", img, step + 1)
            if gt is not None:
                self.writer.add_image(f"{prefix}_1ground_truth", decode(gt), step + 1)
            if pred is not None:
                self.writer.add_image(f"{prefix}_2prediction", decode(pred), step + 1)
            if disp is not None:
                self.writer.add_image(f"{prefix}_3depth", _colorize(disp), step + 1)

    def dump_mix_debug(self, debug: Dict[str, torch.Tensor], step: int) -> None:
        """The step's `debug/*` tensors as `<log_path>/class_mix_debug/
        {step}_{j}_img.jpg` for its first two samples: a 2x2 figure of the
        mixed image, the mask in grey, the decoded pseudo-label and the
        depth in plasma (JAX `Trainer._dump_mix_debug`; reference
        train.py:726-744). Without matplotlib it writes nothing and says so
        once."""
        if self._said_no_matplotlib:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            from matplotlib import pyplot as plt
        except ImportError:
            logger.info("matplotlib is not installed: no class_mix_debug images")
            self._said_no_matplotlib = True
            return
        imgs = _host(debug["debug/mixed_imgs"].float()).transpose(0, 2, 3, 1)
        masks = _host(debug["debug/mix_mask"].float())
        pseudo = _host(debug["debug/pseudo_label"])
        depths = _host(debug["debug/depths"].float()) if "debug/depths" in debug else None
        out_dir = os.path.join(self.log_path, "class_mix_debug")
        os.makedirs(out_dir, exist_ok=True)
        decode = self.val_loader.dataset.decode_segmap_tocolor
        for j in range(min(2, imgs.shape[0])):
            fig, axs = plt.subplots(2, 2, figsize=(8, 8))
            axs[0][0].imshow(np.clip(imgs[j], 0, 1))
            axs[0][1].imshow(masks[j], cmap="gray")
            axs[1][0].imshow(decode(pseudo[j]))
            if depths is not None:
                axs[1][1].imshow(depths[j], cmap="plasma")
            for ax in axs.flat:
                ax.axis("off")
            fig.savefig(os.path.join(out_dir, f"{step}_{j}_img.jpg"))
            plt.close(fig)

    def tensorboard_training_images(self) -> None:
        """Write the first `n_tensorboard_trainimgs` training images and
        their labels at step 0 (reference train.py:412-431). This iterates
        the train loader, and so draws from its shuffle and the global
        random stream, before the first step, as the JAX trainer does."""
        n = self.cfg["training"].get("n_tensorboard_trainimgs", 0)
        if n == 0:
            return
        decode = self.val_loader.dataset.decode_segmap_tocolor
        saved = 0
        for batch in self.train_loader:
            imgs = _host(batch["color_aug_0_0"])
            lbls = _host(batch["lbl"]) if "lbl" in batch else None
            for j in range(imgs.shape[0]):
                if saved >= n:
                    return
                saved += 1
                prefix = f"trainset_{self.run_id.replace('/', '_')}/{saved}"
                self.writer.add_image(f"{prefix}_0image", imgs[j], 0)
                if lbls is not None:
                    self.writer.add_image(f"{prefix}_1ground_truth", decode(lbls[j]), 0)
            if saved >= n:
                return

    def train_loader_sequential(self) -> DataLoader:
        """An unshuffled loader over the train subset that keeps the last,
        partial batch (JAX `Trainer.train_loader_sequential`; label
        selection scores with it)."""
        return DataLoader(self.train_loader.dataset, self.batch_size, shuffle=False,
                          drop_last=False, num_workers=self.cfg["data"].get("n_workers", 2),
                          pin_memory=self.train_loader.pin_memory)

    def save_resume(self, *basenames: str) -> List[str]:
        """Save the full state to `<log_path>/<basename>.pth` for each of
        `basenames` (default `best_model`, as JAX `Trainer.save_resume`) from
        one host snapshot, asynchronously unless `training.async_checkpoints`
        is false. Returns the paths."""
        return self.checkpoints.save_resume(
            self.log_path, self.model, self.teacher, self.optimizer, self.best_iou,
            async_write=self.cfg["training"].get("async_checkpoints", True),
            basenames=basenames or ("best_model",))

    def load_resume(self, path: str, load_model_only: bool = False) -> None:
        """Restore a full-state checkpoint (the port's `.pth` or the JAX
        package's `.msgpack`); with `load_model_only` the model alone."""
        self.checkpoints.wait_for_saves()
        self.start_iter, self.best_iou = load_resume(
            path, self.model, self.teacher, self.optimizer, self.cfg["model"], load_model_only)

    def plateau_step(self, metric: float) -> None:
        """`reduce_lr_on_plateau`: scale the update by `factor` after more
        than `patience` validations without a better metric."""
        p = self.plateau
        if metric > p["best"]:
            p["best"] = metric
            p["count"] = 0
        else:
            p["count"] += 1
            if p["count"] > p["patience"]:
                p["count"] = 0
                # the JAX state keeps lr_scale in float32
                self.optimizer.lr_scale = float(np.float32(self.optimizer.lr_scale * p["factor"]))
                logger.info("Plateau: lr_scale -> %.2e", self.optimizer.lr_scale)

    def close(self) -> None:
        """Stop the loaders' threads and close the metrics files."""
        for it in (self._extra_iter, self.unlabeled_iter):
            if it is not None:
                it.close()
        for loader in (self.train_loader, self.val_loader, self.unlabeled_loader):
            if loader is not None:
                loader.close()
        self.writer.close()


def _merge_shared_options(cfg: Dict[str, Any]) -> None:
    """`merge_monodepth_options`, then the data section's frame ids, scales,
    crop and image size from the monodepth options, in place (JAX
    `Trainer.__init__`)."""
    merge_monodepth_options(cfg)
    mono = cfg.get("monodepth_options", {})
    cfg["data"].setdefault("frame_ids", mono.get("frame_ids", [0, -1, 1]))
    cfg["data"].setdefault("num_scales", mono.get("num_scales", 4))
    if "crop_h" in mono:
        cfg["data"].setdefault("crop_h", mono["crop_h"])
        cfg["data"].setdefault("crop_w", mono["crop_w"])
    if "height" in mono:
        cfg["data"].setdefault("img_size", [mono["height"], mono["width"]])


def _build_loaders(cfg: Dict[str, Any], seed: int, device: str):
    """The train, validation and (semi-supervised) unlabeled loaders (JAX
    `Trainer.__init__`, reference train.py:194-236), after the offline
    pseudo-depth where the run reads it from files."""
    training = cfg["training"]
    u = training.get("unlabeled_segmentation") or {}
    only_unlabeled = u.get("only_unlabeled", True)
    only_labeled = u.get("only_labeled", False)
    if only_unlabeled and only_labeled:
        raise ValueError("unlabeled_segmentation: only_unlabeled and only_labeled")
    mix_use_gt = u.get("mix_use_gt", False)
    need_offline_depth = (
        (u.get("mix_mask") in ("depth", "depthcomp", "depthhist")
         and not u.get("depthmix_online_depth", False))
        or cfg["data"].get("depth_teacher") is not None)
    if need_offline_depth and cfg["data"].get("dataset") != "synthetic":
        DepthEstimator(cfg, device).prepare_depth_estimates()
    pin_memory = torch.device(device).type == "cuda"

    data_cfg = dict(cfg["data"])
    if data_cfg.get("dataset_seed") in (None, "same"):
        data_cfg["dataset_seed"] = seed
    if cfg["model"].get("provide_uncropped_for_pose", False):
        data_cfg["load_color_full"] = True
    if not need_offline_depth:
        data_cfg.pop("generated_depth_dir", None)
    # sequence frames only with the photometric loss, labels only with the
    # segmentation loss (reference train.py:210-214)
    load_sequence = training.get("monodepth_lambda", 0.0) != 0
    load_labels = training.get("segmentation_lambda", 1.0) != 0
    train_set = build_loader(data_cfg, "train", load_labels=load_labels,
                             load_sequence=load_sequence)
    val_set = build_loader({**data_cfg, "restrict_to_subset": None},
                           data_cfg.get("val_split", "val"), load_labels=load_labels,
                           load_sequence=load_sequence)
    bs = training["batch_size"]
    nw = cfg["data"].get("n_workers", 4)
    train_loader = DataLoader(train_set, bs, shuffle=True, drop_last=True, num_workers=nw,
                              pin_memory=pin_memory)
    val_loader = DataLoader(val_set, training.get("val_batch_size", bs), shuffle=False,
                            drop_last=False, num_workers=nw, pin_memory=pin_memory)
    unlabeled_loader = None
    if u:
        u_data_cfg = dict(data_cfg)
        mix_video = u.get("mix_video", False)
        if mix_video:
            if mix_use_gt or only_labeled or only_unlabeled:
                raise ValueError("unlabeled_segmentation.mix_video excludes mix_use_gt, "
                                 "only_labeled and only_unlabeled")
            u_data_cfg.update({"only_sequences_with_segmentation": False,
                               "restrict_to_subset": None})
        u_set = build_loader(u_data_cfg, "train", load_labels=load_labels and not mix_video,
                             load_sequence=load_sequence, load_labeled=not only_unlabeled,
                             load_unlabeled=not only_labeled, load_onehot=mix_use_gt)
        unlabeled_loader = DataLoader(u_set, bs, shuffle=True, drop_last=True,
                                      num_workers=nw, pin_memory=pin_memory)
    return train_loader, val_loader, unlabeled_loader


def build_run(cfg: Dict[str, Any], device: str = "cuda:0", run_id: str = "run") -> Run:
    """Build the config's run on `device` (JAX `Trainer.__init__`): expands
    the config's `MachineConfig.X` paths and merges the shared options in
    place, seeds the host's RNGs and torch, builds the loaders, the model
    with its pretrained weights, the teacher and the optimizer, opens the
    metrics writer in `training.log_path` (default `<LOG_DIR>/<run_id>`) and
    resumes where `resume` or `auto_resume` says."""
    paths = machine_paths(cfg.get("machine", "ws"))
    expand_cfg_vars(cfg, paths)
    _merge_shared_options(cfg)
    training = cfg["training"]
    seed = cfg.get("seed", training.get("seed", 42))
    set_seeds(seed)
    torch.manual_seed(seed)
    log_path = training.get("log_path") or os.path.join(paths["LOG_DIR"], run_id)
    training["log_path"] = log_path
    os.makedirs(log_path, exist_ok=True)

    train_loader, val_loader, unlabeled_loader = _build_loaders(cfg, seed, device)
    n_classes = train_loader.dataset.n_classes
    cfg["data"]["n_classes"] = n_classes
    step_cfg = step_config_from_cfg(cfg)
    if training.get("save_separate_monodepth_models", False) and training.get(
            "save_monodepth_ema", False) and not step_cfg.use_ema:
        raise ValueError("training.save_monodepth_ema needs the EMA teacher "
                         "(training.unlabeled_segmentation)")
    model = build_model(cfg["model"], n_classes, amp=training.get("amp", False), seed=seed)
    apply_pretraining(model, cfg["model"], paths["DOWNLOAD_MODEL_DIR"])
    model = model.to(device)

    sched = training.get("lr_schedule") or {}
    plateau = None
    if sched.get("name") == "reduce_lr_on_plateau":
        plateau = {"factor": sched.get("factor", 0.1), "patience": sched.get("patience", 10),
                   "best": -np.inf, "count": 0}
    es_cfg = training.get("early_stopping") or None
    img_size = cfg["data"].get("img_size", (512, 1024))
    run = Run(cfg=cfg, model=model, teacher=make_teacher(model) if step_cfg.use_ema else None,
              optimizer=build_optimizer(training, cfg["model"], model), step_cfg=step_cfg,
              generator=torch.Generator(device=device).manual_seed(seed), device=device,
              train_loader=train_loader, val_loader=val_loader,
              unlabeled_loader=unlabeled_loader, n_classes=n_classes,
              batch_size=training["batch_size"],
              height=cfg["data"].get("crop_h") or img_size[0],
              width=cfg["data"].get("crop_w") or img_size[1],
              log_path=log_path, writer=MetricsWriter(log_path), checkpoints=ResumeWriter(),
              plateau=plateau,
              early_stopping=EarlyStopping(logger=logger, **es_cfg) if es_cfg else None,
              run_id=run_id)
    try:
        _resume(run, training)
    except Exception:
        run.close()
        raise
    return run


def _resume(run: Run, training: Dict[str, Any]) -> None:
    """`resume` (a checkpoint path), else `auto_resume` (the run's
    `last_model.pth`, where there is one), as the JAX trainer resumes."""
    resume = training.get("resume")
    if resume:
        if os.path.isfile(resume):
            run.load_resume(resume)
            logger.info("Loaded checkpoint %s (iter %d)", resume, run.start_iter)
        else:
            logger.info("No checkpoint found at %s", resume)
    elif training.get("auto_resume", False):
        last = os.path.join(run.log_path, "last_model.pth")
        if os.path.isfile(last):
            run.load_resume(last)
            logger.info("Auto-resumed %s (iter %d)", last, run.start_iter)


def _write_training_scalars(run: Run, cfg: Dict[str, Any], records, step: int) -> None:
    """At a print interval: resolve the pending records' losses (the one
    wait for the device in the interval), log their means and write them with
    the time per image, the learning rate and the host memory (JAX
    `Trainer.train`, l. 326-361)."""
    training = cfg["training"]
    meter = AverageMeterDict()
    seconds = []
    for r in records:
        for k, v in r.items():
            if isinstance(v, torch.Tensor):
                r[k] = float(v)
        meter.update({k: v for k, v in r.items() if k.endswith("loss")})
        seconds.append(r["data_seconds"] + r["step_seconds"])
    time_per_image = sum(seconds) / len(seconds) / training["batch_size"]
    logger.info("Iter [%d/%d]  Loss: %.4f  Time/Image: %.4f", step + 1,
                training["train_iters"], meter.avgs["total_loss"], time_per_image)
    for k, v in meter.avgs.items():
        run.writer.add_scalar("training/" + k, v, step + 1)
    run.writer.add_scalar("training/time_per_image", time_per_image, step + 1)
    base_lr = (training.get("optimizer") or {}).get("lr", 0.01)
    run.writer.add_scalar("training/learning_rate", base_lr * float(
        run.optimizer.factor_fn(step)) * run.optimizer.lr_scale, step + 1)
    if importlib.util.find_spec("psutil") is not None:
        import psutil

        run.writer.add_scalar("training/memory", psutil.virtual_memory().used / 1e9, step + 1)


def _loop(run: Run, cfg: Dict[str, Any]) -> List[Dict[str, float]]:
    training = cfg["training"]
    train_iters = training["train_iters"]
    print_interval = training.get("print_interval", 100)
    validating = training.get("val_interval") is not None
    saving = training.get("save_model", True)
    records: List[Dict[str, Any]] = []
    pending: List[Dict[str, Any]] = []
    step = run.start_iter
    flag = True
    if len(run.train_loader) == 0:
        raise ValueError(f"the train set ({len(run.train_loader.dataset)} items) holds no "
                         f"batch of {run.batch_size}")
    run.tensorboard_training_images()
    # JAX's loop tests `step <= train_iters` here, so that a run resumed at
    # its last iteration takes steps until its epoch ends; this one takes none
    while step + 1 < train_iters and flag:
        epoch = iter(run.train_loader)
        try:
            while True:
                t0 = time.perf_counter()
                host = next(epoch, None)
                if host is None:
                    break
                step += 1
                batch = run.to_device(host)
                unlabeled = run.next_unlabeled()
                t1 = time.perf_counter()
                record: Dict[str, Any] = dict(run.step(batch, unlabeled))
                record.update(data_seconds=t1 - t0, step_seconds=time.perf_counter() - t1)
                # the debug tensors stay on the device and are read only where
                # they are drawn
                debug = {k: record.pop(k) for k in list(record) if k.startswith("debug/")}
                records.append(record)
                pending.append(record)
                if debug and (step + 1) % print_interval == 0:
                    run.dump_mix_debug(debug, step)
                if (step + 1) % print_interval == 0:
                    _write_training_scalars(run, cfg, pending, step)
                    pending = []
                if validating and ((step + 1) % current_val_interval(cfg, step + 1) == 0
                                   or step + 1 == train_iters):
                    val = run.validate(step)
                    # JAX saves best, then last, with the same state: one
                    # host snapshot writes both
                    names = []
                    if run.mIoU >= run.best_iou:
                        run.best_iou = run.mIoU
                        if saving:
                            names.append("best_model")
                    if training.get("save_last", True) and saving:
                        names.append("last_model")
                    t_save = time.perf_counter()
                    if names:
                        run.save_resume(*names)
                    val["save_seconds"] = time.perf_counter() - t_save
                    val["best_iou"] = run.best_iou
                    record.update({f"val/{k}": v for k, v in val.items()})
                    logger.info("Validation @%d: mIoU=%.4f  best %.4f  %.3f s per batch",
                                step + 1, run.mIoU, run.best_iou,
                                val["eval_seconds_per_batch"])
                    if run.plateau is not None:
                        run.plateau_step(run.mIoU)
                    if run.early_stopping is not None and not run.early_stopping.step(run.mIoU):
                        flag = False
                        break
                if step + 1 == train_iters:
                    flag = False
                    break
        finally:
            epoch.close()
    run.checkpoints.wait_for_saves()  # land the write in flight before returning
    for r in pending:
        for k, v in r.items():
            if isinstance(v, torch.Tensor):
                r[k] = float(v)
    return records


def train_main(cfg: Dict[str, Any], device: str = "cuda:0", run: Optional[Run] = None,
               run_id: str = "run") -> List[Dict[str, float]]:
    """Train the config's model on `run` (as `build_run(cfg, device, run_id)`
    makes it; the caller closes it) or on a new one, as the JAX trainer does
    (see the module docstring); writes `cfg.yml` and the run's log file into
    its log path.

    Returns one record per step: its losses, `data_seconds` (host time
    waiting on the loaders, the copies to the device included) and
    `step_seconds` (host time of the step's call, which returns once its
    work is queued on the device); after a validation also its record
    (`Run.validate`, with `best_iou` after the comparison and
    `save_seconds`, the host time the loop waited for the checkpoint save)
    under keys prefixed `val/`. The losses are read from the device at each print
    interval and at the end.
    """
    own_run = run is None
    if own_run:
        run = build_run(cfg, device, run_id)
    training = cfg["training"]
    with open(os.path.join(run.log_path, "cfg.yml"), "w") as f:
        yaml.safe_dump(cfg, f)
    file_logger = get_logger(run.log_path)
    handler = file_logger.handlers[-1]
    logger.info("training %s on %s: batch %d at %dx%d, steps %d to %d",
                cfg["model"].get("backbone_name", "resnet101"), run.device, run.batch_size,
                run.height, run.width, run.start_iter + 1, training["train_iters"] - 1)
    try:
        records = _loop(run, cfg)
        if training.get("save_separate_monodepth_models", False):
            # component export for the SDE transfer chain (reference train.py:377-390)
            teacher = run.teacher if training.get("save_monodepth_ema", False) else None
            save_monodepth_models(run.log_path, run.model,
                                  include_encoder=not cfg["model"].get("freeze_backbone", False),
                                  params_from=teacher)
            logger.info("SDE components exported to %s", run.log_path)
    finally:
        file_logger.removeHandler(handler)
        handler.close()
        if own_run:
            run.close()
    return records
