"""Smoke runner of the port (the JAX package's cli/test_experiments_cli.py;
reference test_experiments.py:35-78): every variant of experiments
210/211/212 with truncated budgets (2 train iterations, immediate
validation) against real, fake on-disk or synthetic data.

    python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.test_experiments_cli \
        --synthetic --strict [--exps 210,211,212] [--runs all] [--device cuda:0]
"""

from __future__ import annotations

import argparse

import yaml

from .run_experiments_cli import parse_runs, run_experiments


def smoke_overrides(cfg):
    """Truncated budgets (reference test_experiments.py:63-73)."""
    cfg["training"]["print_interval"] = 1
    cfg["training"]["val_interval"] = {"0": 1}
    cfg["training"]["train_iters"] = 2
    cfg["training"]["n_tensorboard_imgs"] = 2
    if "label_selection" in cfg:
        cfg["label_selection"]["label_steps"] = [25, 50]
        cfg["label_selection"]["train_iters"] = [2, 2]
        if "max_iter" in (cfg["training"].get("lr_schedule") or {}):
            cfg["training"]["lr_schedule"]["max_iter"] = 2


def synthetic_overrides(cfg):
    """Redirect a config to the in-memory synthetic dataset at resnet18 and
    64x96 without pretrained weights (a run without Cityscapes on disk)."""
    smoke_overrides(cfg)
    cfg["data"].update({"dataset": "synthetic", "n_samples": 8, "path": None})
    if cfg["data"].get("restrict_to_subset"):
        cfg["data"]["restrict_to_subset"] = {"mode": "random", "n_subset": 4}
    cfg["monodepth_options"].update({"height": 64, "width": 96,
                                     "crop_h": 64, "crop_w": 64})
    cfg["data"].pop("depth_teacher", None)
    cfg["model"]["backbone_name"] = "resnet18"
    cfg["model"]["backbone_pretraining"] = "none"
    cfg["model"]["depth_pretraining"] = "none"
    cfg["model"]["pose_pretraining"] = "none"
    if cfg["model"].get("segmentation_args"):
        cfg["model"]["segmentation_args"].pop("weights", None)
    cfg["model"]["depth_estimator_weights"] = None
    if cfg.get("label_selection"):
        cfg["label_selection"]["label_steps"] = [2, 4]
        cfg["label_selection"]["train_iters"] = [2, 2]
    if cfg["training"].get("unlabeled_segmentation"):
        cfg["training"]["unlabeled_segmentation"]["depthmix_online_depth"] = True


def fake_data_overrides(cfg):
    """A smoke run against a (tiny, fake) on-disk Cityscapes tree: the real
    loader and path arithmetic, with a small model and crop and without
    what needs pretrained weights or offline pseudo-depth."""
    smoke_overrides(cfg)
    # keep exp-210's (512, 1024) img_size so the loader reads the _small
    # trees; shrink only the train crop
    cfg["monodepth_options"].update({"height": 512, "width": 1024,
                                     "crop_h": 128, "crop_w": 128})
    cfg["model"]["backbone_name"] = "resnet18"
    cfg["model"]["backbone_pretraining"] = "none"
    cfg["model"]["depth_pretraining"] = "none"
    cfg["model"]["pose_pretraining"] = "none"
    if cfg["model"].get("segmentation_args"):
        cfg["model"]["segmentation_args"].pop("weights", None)
    cfg["model"]["depth_estimator_weights"] = None
    cfg["data"].pop("depth_teacher", None)
    if cfg["data"].get("restrict_to_subset"):
        cfg["data"]["restrict_to_subset"] = {"mode": "random", "n_subset": 2}
    cfg["training"]["batch_size"] = 2
    cfg["training"]["val_batch_size"] = 2
    if cfg["training"].get("unlabeled_segmentation"):
        # no offline pseudo-depth PNGs on a fake tree: online depth, which
        # needs the photometric loss to make the mixing depths
        cfg["training"]["unlabeled_segmentation"]["depthmix_online_depth"] = True
        cfg["training"]["monodepth_lambda"] = 1.0


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="configs/cityscapes_joint.yml")
    parser.add_argument("--machine", type=str, default="ws")
    parser.add_argument("--exps", type=str, default="210,211,212")
    parser.add_argument("--synthetic", action="store_true",
                        help="Run against the in-memory synthetic dataset")
    parser.add_argument("--fake-data", action="store_true",
                        help="Run against an on-disk (fake/tiny) Cityscapes "
                             "tree with pretrained weights neutralized")
    parser.add_argument("--strict", action="store_true",
                        help="Fail on the first trial error instead of "
                             "catch-and-continue")
    parser.add_argument("--runs", type=str, default="all",
                        help="Trial index/range within each experiment "
                             "(same syntax as run_experiments --run)")
    parser.add_argument("--device", default="cuda:0",
                        help="torch device; the kernels run on CUDA devices only")
    args = parser.parse_args(argv)

    with open(args.config) as fp:
        base_cfg = yaml.safe_load(fp)
    overrides = (fake_data_overrides if args.fake_data
                 else synthetic_overrides if args.synthetic
                 else smoke_overrides)
    for exp in [int(e) for e in args.exps.split(",")]:
        run_experiments(base_cfg, exp, machine=args.machine,
                        runs=parse_runs(args.runs),
                        dry=False, config_name="smoke", overrides=overrides,
                        strict=args.strict, device=args.device)


if __name__ == "__main__":
    main()
