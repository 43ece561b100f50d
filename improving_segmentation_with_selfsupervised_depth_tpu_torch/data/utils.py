"""Image loading and subset restriction for the host input pipeline: the
port's copy of the JAX package's `data/utils.py` (reference
loader/loader_utils.py). PIL decodes (and releases the GIL while it does);
it is imported where an image is decoded, so the synthetic dataset and the
loader run without it. An LRU cache keeps the pseudo-depth loads, as the
reference does (loader_utils.py:17-20)."""

from __future__ import annotations

from copy import deepcopy
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

from ..utils.misc import np_local_seed


def antialias():
    """PIL's LANCZOS filter (ANTIALIAS in old PIL versions)."""
    from PIL import Image

    return getattr(Image, "LANCZOS", getattr(Image, "ANTIALIAS", 1))


def _build_size(img, width: int, height: int):
    return (img.width if width == -1 else width, img.height if height == -1 else height)


def _load(path: str, is_segmentation: bool, width: int, height: int):
    from PIL import Image

    with open(path, "rb") as f:
        with Image.open(f) as img:
            if is_segmentation:
                img = img.convert()
                img = img.resize(_build_size(img, width, height), Image.NEAREST)
            else:
                img = img.convert("RGB")
                img = img.resize(_build_size(img, width, height), antialias())
    return img


@lru_cache(maxsize=5000)
def _load_cached(path, is_segmentation, width, height):
    return _load(path, is_segmentation, width, height)


def pil_loader(path: str, std_width: int, std_height: int, is_segmentation: bool = False,
               use_cache: bool = False):
    """The image at `path` as a PIL image resized to (`std_width`,
    `std_height`) (-1 keeps a side): LANCZOS for images, NEAREST for label
    maps. `use_cache` keeps the result in an LRU cache of 5000 images."""
    fn = _load_cached if use_cache else _load
    return fn(path, is_segmentation, std_width, std_height)


def restrict_to_subset(
    files: List[Dict],
    mode: str,
    n_subset: int,
    seed: int,
    load_labeled: bool,
    load_unlabeled: bool,
    subset: Optional[List[int]] = None,
) -> List[Dict]:
    """Split the file list into the labeled subset and the unlabeled rest.

    Bit-compatible with reference loader/loader_utils.py:46-83: 'random'
    takes the first `n_subset` of the same seeded `np.random.permutation`,
    'fixed' takes the indices in `subset`.
    """
    if not (mode == "fixed" or subset is None):
        raise ValueError(f"restrict_to_subset: a subset is given with mode {mode!r}")
    if mode == "random":
        with np_local_seed(seed):
            p = np.random.permutation(len(files))
        p = p[:n_subset]
    elif mode == "fixed":
        if subset is None or len(subset) != n_subset:
            raise ValueError(f"restrict_to_subset: 'fixed' needs {n_subset} indices")
        p = subset
    else:
        raise NotImplementedError(mode)
    p = set(int(i) for i in p)

    labeled_files = [f for f in files if f["idx"] in p]
    if len(labeled_files) != n_subset:
        raise ValueError(f"restrict_to_subset: {len(labeled_files)} files of the "
                         f"{n_subset} indices")
    unlabeled_files = [deepcopy(f) for f in files if f["idx"] not in p]
    for f in unlabeled_files:
        f["labeled"] = False

    if load_labeled and load_unlabeled:
        return deepcopy(labeled_files) + unlabeled_files
    if load_labeled:
        return labeled_files
    if load_unlabeled:
        return unlabeled_files
    raise ValueError("Neither unlabeled nor labeled data specified to be loaded.")
