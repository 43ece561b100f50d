"""Experiment runner of the port (the JAX package's
cli/run_experiments_cli.py; reference run_experiments.py:15-105): expand the
generated variant grid, write one YAML per trial and dispatch the trials in
turn to `train_main` (on every visible GPU under the JAX package's rule:
`parallel/launch.py`), or to `label_selection_main` for `main:
label_selection` (one process), catching a trial's failure and going on.

    python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.run_experiments_cli \
        --config configs/cityscapes_joint.yml --exp 212 [--run 0] [--dry] \
        [--machine ws] [--device cuda:0]

The trials' YAMLs go to `$SDT_DISPATCH_DIR/<config>_<id>_<date>` (default
results/dispatcher); each trial logs under `<training.log_path>/<config>_<id>`.
"""

from __future__ import annotations

import argparse
import os
import traceback
from datetime import datetime

import yaml

from ..config.experiments import generate_experiment_cfgs
from ..config.grid import expand_grid
from ..config.machine import machine_paths
from ..label_selection import label_selection_main
from ..parallel.launch import train_main


def run_experiments(base_cfg, exp_id, machine="ws", runs="all", dry=False,
                    config_name="cityscapes_joint", overrides=None, strict=False,
                    device="cuda:0"):
    """Generate experiment `exp_id`'s trials from `base_cfg` and run those
    of `runs` ("all" or a list of trial indices) on `device`; `overrides`
    edits each trial's config before it is written. `strict=True` re-raises
    a trial's failure instead of going on to the next trial. Returns the
    directory of the trial YAMLs."""
    machine_paths(machine)  # an unknown machine raises, as JAX's MachineConfig
    cfgs = generate_experiment_cfgs(base_cfg, exp_id)
    experiment_name = f"{config_name}_{exp_id}"
    run_id = experiment_name + "_" + datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir = os.path.expandvars(os.path.join(
        os.environ.get("SDT_DISPATCH_DIR", "results/dispatcher"), run_id))
    os.makedirs(out_dir, exist_ok=True)

    i = 0
    for cfg_with_grid in cfgs:
        for cfg in expand_grid(cfg_with_grid):
            trial_i = i
            i += 1
            if runs != "all" and trial_i not in runs:
                continue
            tag = cfg.get("general", {}).get("tag", f"trial{trial_i}")
            print(f"Dispatch job {tag}")
            cfg["name"] = datetime.now().strftime("%Y-%m-%d_%H-%M-%S") + tag
            cfg["machine"] = machine
            cfg["training"]["log_path"] = os.path.join(
                cfg["training"]["log_path"], experiment_name)
            if overrides:
                overrides(cfg)
            with open(os.path.join(out_dir, f"trial_{trial_i}.yaml"), "w") as of:
                yaml.safe_dump(cfg, of, default_flow_style=False)
            if dry:
                continue
            try:
                if cfg.get("main") == "label_selection":
                    label_selection_main(cfg, device=device)
                else:
                    train_main(cfg, device=device, run_id=cfg["name"])
            except Exception:
                if strict:
                    raise
                print(traceback.format_exc())
                print("Continue with next experiment.")
    return out_dir


def parse_runs(run_arg: str):
    """"all", "a-b" (a up to b, b excluded) or "i,j,..." as trial indices."""
    if run_arg == "all":
        return "all"
    if "-" in run_arg:
        low, up = run_arg.split("-")
        return list(range(int(low), int(up)))
    return [int(v) for v in run_arg.split(",")]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", nargs="?", type=str,
                        default="configs/cityscapes_joint.yml",
                        help="Base config file to use")
    parser.add_argument("--exp", nargs="?", type=int, required=True,
                        help="Experiment id (210 | 211 | 212)")
    parser.add_argument("--dry", action="store_true")
    parser.add_argument("--machine", type=str, default="ws")
    parser.add_argument("--run", type=str, default="all",
                        help="Run index/range within the experiment")
    parser.add_argument("--device", default="cuda:0",
                        help="torch device; the kernels run on CUDA devices only")
    args = parser.parse_args(argv)

    with open(args.config) as fp:
        base_cfg = yaml.safe_load(fp)
    config_name = os.path.basename(args.config).split(".")[0]
    run_experiments(base_cfg, args.exp, machine=args.machine,
                    runs=parse_runs(args.run), dry=args.dry,
                    config_name=config_name, device=args.device)


if __name__ == "__main__":
    main()
