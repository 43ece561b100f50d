"""Train CLI of the port (the JAX package's cli/train_cli.py):

    python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.train_cli \
        --config <yaml> [--device cuda:0]
"""

from __future__ import annotations

import argparse
import logging

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
    train_main(cfg, device=args.device)


if __name__ == "__main__":
    main()
