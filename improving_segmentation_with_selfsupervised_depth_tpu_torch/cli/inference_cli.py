"""Inference CLI of the port (the JAX package's cli/inference_cli.py;
reference inference.py): load a run directory (`cfg.yml` and
`best_model.pth`, or a JAX run's `best_model.msgpack`), run segmentation and
depth over an image directory and write, per input file, the image,
`<stem>_depth.png` (the disparity in 8 bits) and `<stem>_label.png` (the
Cityscapes colours of the argmax).

    python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.inference_cli \
        --model <run-dir> [--data <image dir>] [--machine ws] [--device cuda:0]

The outputs go to `<LOG_DIR>/inference<date>/` (`SDT_OUT_DIR`, `SDT_LOG_DIR`).
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime
from typing import Any, Dict

import numpy as np
import torch
import yaml
from PIL import Image

from .. import not_ported
from ..config.machine import expand_cfg_vars, machine_paths
from ..data.loader import DataLoader, to_device_batch
from ..data.registry import build_loader
from ..engine.checkpoints import load_resume
from ..engine.train_steps import step_config_from_cfg
from ..models.joint import build_model
from ..ops import photometric
from ..ops.photometric import key_of
from ..utils.misc import set_seeds
from .export_cli import run_dir_checkpoint


def _host(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class Inference:
    """The run's model over the `val` split of `data.dataset` (reference
    inference.py:20-116), on `device`, in eval mode without gradient.
    `seconds` holds per batch the host time of the forward to its outputs on
    the device (`forward`, queued), of the copies to the host, which wait
    for it (`to_host`), and of the PNG writes (`write`)."""

    def __init__(self, cfg: Dict[str, Any], logdir: str, run_id: str,
                 device: str = "cuda:0"):
        if "monodepth_options" in cfg:
            # `update`, not setdefault: the shared options win here, as in JAX
            for section in ("data", "model"):
                cfg[section].update(cfg["monodepth_options"])
            cfg["training"].setdefault("monodepth_loss", {}).update(cfg["monodepth_options"])
        set_seeds(cfg.get("seed", 1337))
        if cfg["data"].get("dataset_seed") == "same":
            cfg["data"]["dataset_seed"] = cfg.get("seed", 1337)
        self.cfg = cfg
        self.logdir = logdir
        self.run_id = run_id
        self.device = device
        cfg["data"]["generated_depth_dir"] = None
        n_sp = int(cfg["training"].get("spatial_shards", 0) or 0)
        if n_sp > 1:
            raise not_ported(f"training.spatial_shards {n_sp} (parallel/spatial.py)",
                             "multi-GPU")

        self.val_dataset = build_loader(cfg["data"], "val", load_labels=False,
                                        load_sequence=False)
        self.n_classes = self.val_dataset.n_classes
        self.val_loader = DataLoader(
            self.val_dataset, cfg["training"].get("val_batch_size", 2),
            shuffle=False, drop_last=False, num_workers=cfg["data"].get("n_workers", 2),
            pin_memory=torch.device(device).type == "cuda")

        self.model = build_model(cfg["model"], self.n_classes,
                                 amp=cfg["training"].get("amp", False))
        self.step_cfg = step_config_from_cfg(cfg)
        if cfg["training"].get("resume"):
            path = cfg["training"]["resume"]
            if os.path.isfile(path):
                load_resume(path, self.model, None, None, cfg["model"], load_model_only=True)
            else:
                print(f"WARNING: load_resume - {path} not found")
        self.model = self.model.to(device).eval()
        self.seconds: Dict[str, list] = {"forward": [], "to_host": [], "write": []}

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The pose-free eval forward and, with a depth decoder, the test
        depths (JAX `Inference._forward`)."""
        out = self.model(batch, use_pose=False)
        if not self.step_cfg.disable_monodepth:
            out = photometric.generate_depth_test_pred(
                out, scales=self.step_cfg.scales, test_min_depth=self.step_cfg.test_min_depth,
                test_max_depth=self.step_cfg.test_max_depth)
        return out

    def run(self) -> int:
        """Write the PNGs of every input. Returns the number of inputs."""
        n = 0
        segments = self.cfg["training"].get("segmentation_lambda", 1.0) > 0
        for host in self.val_loader:
            t0 = time.perf_counter()
            outputs = self.forward(to_device_batch(host, self.device))
            t1 = time.perf_counter()
            images = _host(host[key_of("color_aug", 0, 0)])
            if segments and "semantics" in outputs:
                preds = outputs["semantics"].float().argmax(1).cpu().numpy()
            else:
                preds = [None] * images.shape[0]
            disps = (outputs["disp_0"].float()[:, 0].cpu().numpy()
                     if "disp_0" in outputs else [None] * images.shape[0])
            t2 = time.perf_counter()
            for filename, img, seg, depth in zip(host["filename"], images, preds, disps):
                fn = os.path.join(self.logdir, filename)
                os.makedirs(os.path.dirname(fn), exist_ok=True)
                stem = fn[:-4] if fn.lower().endswith((".jpg", ".png")) else fn
                Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                    fn if fn.lower().endswith((".jpg", ".png")) else fn + ".png")
                if depth is not None:
                    Image.fromarray((np.clip(depth, 0, 1) * 255).astype(np.uint8), "L"
                                    ).save(stem + "_depth.png")
                if seg is not None:
                    col = self.val_dataset.decode_segmap_tocolor(seg)
                    Image.fromarray((col * 255).astype(np.uint8)).save(stem + "_label.png")
                n += 1
            self.seconds["forward"].append(t1 - t0)
            self.seconds["to_host"].append(t2 - t1)
            self.seconds["write"].append(time.perf_counter() - t2)
        return n

    def close(self) -> None:
        self.val_loader.close()


def inference_main(cfg: Dict[str, Any], device: str = "cuda:0") -> Inference:
    """Run `cfg`'s inference into `<training.log_path>/inference<date>` and
    return the finished `Inference` (its `logdir` and `seconds`)."""
    paths = machine_paths(cfg.get("machine", "ws"))
    run_id = datetime.now().strftime("%Y-%m-%d_%H-%M-%S-%f")
    cfg["name"] = "inference" + run_id
    cfg["training"]["log_path"] = os.path.join(cfg["training"]["log_path"], cfg["name"])
    expand_cfg_vars(cfg, paths)
    logdir = cfg["training"]["log_path"]
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "cfg.yml"), "w") as fp:
        yaml.safe_dump(cfg, fp)
    inference = Inference(cfg, logdir, run_id, device=device)
    try:
        inference.run()
    finally:
        inference.close()
    return inference


def main(argv=None):
    parser = argparse.ArgumentParser(description="config")
    parser.add_argument("--model", type=str, required=True,
                        help="Model dir containing best_model.pth (or .msgpack) + cfg.yml")
    parser.add_argument("--data", type=str,
                        default="MachineConfig.CITYSCAPES_DIR/leftImg8bit_small/val/")
    parser.add_argument("--machine", type=str, default="ws")
    parser.add_argument("--spatial-shards", type=int, default=0,
                        help="Shard the image H axis over this many devices (not "
                             "ported: a value above 1 raises)")
    parser.add_argument("--device", default="cuda:0",
                        help="torch device; the kernels run on CUDA devices only")
    args = parser.parse_args(argv)

    with open(os.path.join(args.model, "cfg.yml")) as fp:
        cfg = yaml.safe_load(fp)
    cfg["machine"] = args.machine
    cfg["data"]["dataset"] = "inference"
    cfg["data"]["path"] = args.data
    cfg["model"]["disable_pose"] = True
    cfg["training"]["log_path"] = "MachineConfig.LOG_DIR"
    cfg["training"]["resume"] = run_dir_checkpoint(args.model)
    cfg["training"]["spatial_shards"] = args.spatial_shards
    return inference_main(cfg, device=args.device)


if __name__ == "__main__":
    main()
