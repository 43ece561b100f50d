"""Train CLI of the port (the JAX package's cli/train_cli.py):

    python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.train_cli \
        --config <yaml> [--device cuda:0]

The run writes into `training.log_path`, or `<LOG_DIR>/<name>_<date>_<time>`
where the config sets none (`config/machine.py`: `SDT_OUT_DIR`,
`SDT_LOG_DIR`); with `training.auto_resume` a run started again with the
same `log_path` resumes from its `last_model.pth`.
"""

from __future__ import annotations

import argparse
import logging
from datetime import datetime

import yaml

from ..engine.trainer import train_main


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the joint model (PyTorch port)")
    parser.add_argument("--config", required=True, help="YAML experiment config")
    parser.add_argument("--device", default="cuda:0",
                        help="torch device; the kernels run on CUDA devices only")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    with open(args.config) as fp:
        cfg = yaml.safe_load(fp)
    # the run's default log path is <LOG_DIR>/<run_id> (JAX cli/train_cli.py)
    run_id = cfg.get("name", "run") + "_" + datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    train_main(cfg, device=args.device, run_id=run_id)


if __name__ == "__main__":
    main()
