"""Offline Cityscapes preprocessing: downscale 2048x1024 -> 1024x512 JPEG q98.

The port's copy of the JAX package's `data/prepare_cityscapes.py`
(reference data_preprocessing/prepare_cityscapes.py:9-98): a process pool
in place of the reference's Ray workers, and the verify and repair pass for
corrupted JPEGs. It writes the same files as the JAX package's.

Usage:
  python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.data.prepare_cityscapes \
      --in-dir .../leftImg8bit_sequence --out-dir .../leftImg8bit_sequence_small [--repair]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Tuple

from ..utils.misc import recursive_glob
from .utils import antialias


def process_image(args: Tuple[str, str, str, int, float]) -> bool:
    from PIL import Image

    src, in_dir, out_dir, quality, scale = args
    dst = src.replace(in_dir, out_dir)
    dst = os.path.splitext(dst)[0] + ".jpg"
    if os.path.isfile(dst):
        return True
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with Image.open(src) as img:
        img = img.convert("RGB")
        img = img.resize((int(img.width * scale), int(img.height * scale)), antialias())
        img.save(dst, quality=quality)
    return True


def verify_image(path: str) -> bool:
    """Whether PIL decodes the file to its end."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            img.load()
        return True
    except (OSError, SyntaxError, ValueError):  # what PIL raises for a broken image
        return False


def _pool(workers: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))


def process_images(in_dir: str, out_dir: str, quality: int = 98, scale: float = 0.5,
                   workers: int = os.cpu_count() or 4, batch: int = 100) -> None:
    files = sorted(recursive_glob(in_dir, suffix=".png"))
    jobs = [(f, in_dir, out_dir, quality, scale) for f in files]
    with _pool(workers) as pool:
        for i in range(0, len(jobs), batch):
            list(pool.map(process_image, jobs[i: i + batch]))
            print(f"processed {min(i + batch, len(jobs))}/{len(jobs)}")


def repair(in_dir: str, out_dir: str, quality: int = 98, scale: float = 0.5,
           workers: int = os.cpu_count() or 4) -> List[str]:
    """Verify the outputs and write the corrupted ones again (reference
    prepare_cityscapes.py:40-54, 83-96)."""
    outputs = sorted(recursive_glob(out_dir, suffix=".jpg"))
    with _pool(workers) as pool:
        ok = list(pool.map(verify_image, outputs))
    broken = [f for f, good in zip(outputs, ok) if not good]
    for b in broken:
        os.remove(b)
        src = os.path.splitext(b.replace(out_dir, in_dir))[0] + ".png"
        process_image((src, in_dir, out_dir, quality, scale))
    print(f"repaired {len(broken)} corrupted files")
    return broken


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--in-dir", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--quality", type=int, default=98)
    parser.add_argument("--scale", type=float, default=0.5)
    parser.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    parser.add_argument("--repair", action="store_true")
    args = parser.parse_args(argv)
    process_images(args.in_dir, args.out_dir, args.quality, args.scale, args.workers)
    if args.repair:
        repair(args.in_dir, args.out_dir, args.quality, args.scale, args.workers)


if __name__ == "__main__":
    main()
