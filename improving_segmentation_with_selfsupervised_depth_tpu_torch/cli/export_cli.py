"""Export a trained run directory to a self-contained serving artifact.

    python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.export_cli \
        --model <run-dir> --out model.pt2 [--height 512 --width 512] [--batch 1] \
        [--device cuda:0]

The run directory holds `cfg.yml` and `best_model.pth` (the port's run) or
`best_model.msgpack` (the JAX package's). The artifact is a `torch.export`
program with the checkpoint's weights in it (`engine/export.py`); load it
with `engine.export.load_exported`, without model or config code. `--batch
0` exports a symbolic batch dimension.
"""

from __future__ import annotations

import argparse
import os
import time

import yaml

from ..config.machine import machine_paths
from ..engine.checkpoints import load_resume
from ..engine.export import export_inference
from ..models.joint import build_model


def run_dir_checkpoint(run_dir: str) -> str:
    """`<run_dir>/best_model.pth`, else the JAX package's
    `best_model.msgpack`."""
    path = os.path.join(run_dir, "best_model.pth")
    return path if os.path.isfile(path) else os.path.join(run_dir, "best_model.msgpack")


def load_run_model(run_dir: str, device: str, machine: str = "ws"):
    """The run's model without its pose network, in eval mode on `device`,
    holding the run's best checkpoint. Returns (model, cfg)."""
    with open(os.path.join(run_dir, "cfg.yml")) as fp:
        cfg = yaml.safe_load(fp)
    machine_paths(cfg.get("machine", machine))
    cfg["model"]["disable_pose"] = True
    n_classes = cfg["data"].get("n_classes", 19)
    model = build_model(cfg["model"], n_classes, amp=cfg["training"].get("amp", False))
    load_resume(run_dir_checkpoint(run_dir), model, None, None, cfg["model"],
                load_model_only=True)
    return model.to(device).eval(), cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True,
                    help="Run dir containing best_model.pth (or .msgpack) + cfg.yml")
    ap.add_argument("--out", required=True, help="Output artifact path")
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1,
                    help="Batch size of the artifact; 0 exports a symbolic batch")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device the artifact runs on")
    ap.add_argument("--machine", default="ws")
    args = ap.parse_args(argv)

    model, _ = load_run_model(args.model, args.device, args.machine)
    t0 = time.perf_counter()
    data = export_inference(model, args.height, args.width,
                            batch_size=args.batch or None)
    seconds = time.perf_counter() - t0
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"exported {len(data) / 1e6:.1f} MB in {seconds:.1f} s -> {args.out}")


if __name__ == "__main__":
    main()
