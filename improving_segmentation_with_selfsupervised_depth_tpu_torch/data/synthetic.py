"""Synthetic batches (numpy, NHWC), byte-for-byte those of the JAX package's
`data/synthetic.py`; `data/loader.py::to_device_batch` moves them to the
device as NCHW tensors.

Batch dict contract (reference loader/sequence_segmentation_loader.py:183-250):
  color_{f}_{s}, color_aug_{f}_{s}  float32 in [0, 1]
  K_{s}, inv_K_{s}                  (N, 4, 4) intrinsics per scale
  lbl                               int labels with ignore = 250
  pseudo_depth                      (N, H, W, 1) normalized disparity
  onehot_lbl, is_labeled            one-hot labels and a per-sample flag
                                    (`with_unlabeled_extras`, for mix_use_gt)
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from ..ops.photometric import key_of
from .loader import to_device_batch  # noqa: F401  (the batches' move to the device)


def camera_matrix(h: int, w: int) -> np.ndarray:
    """Cityscapes-style intrinsics scaled to (h, w)."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = 2262.52 / 2048 * w
    K[1, 1] = 2265.30 / 1024 * h
    K[0, 2] = 0.5 * w
    K[1, 2] = 0.5 * h
    return K


def make_synthetic_batch(
    batch_size: int = 2,
    h: int = 64,
    w: int = 96,
    frame_ids: Sequence[Any] = (0, -1, 1),
    num_scales: int = 4,
    n_classes: int = 19,
    seed: int = 0,
    with_unlabeled_extras: bool = False,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    batch: Dict[str, np.ndarray] = {}

    # smooth structured images: random low-frequency patterns + camera motion
    base = rng.uniform(0, 1, (batch_size, h // 8, w // 8, 3)).astype(np.float32)
    up = base.repeat(8, axis=1).repeat(8, axis=2)
    for f in frame_ids:
        shift = 0 if f == 0 else int(f) * 2
        img = np.roll(up, shift, axis=2)
        batch[key_of("color", f, 0)] = img
        batch[key_of("color_aug", f, 0)] = np.clip(
            img + rng.normal(0, 0.01, img.shape).astype(np.float32), 0, 1)
    for s in range(num_scales):
        hs, ws = h // 2**s, w // 2**s
        batch[key_of("color", 0, s)] = batch[key_of("color", 0, 0)][:, ::2**s, ::2**s]
        K = camera_matrix(hs, ws)
        batch[key_of("K", s)] = np.broadcast_to(K, (batch_size, 4, 4)).copy()
        batch[key_of("inv_K", s)] = np.broadcast_to(
            np.linalg.inv(K).astype(np.float32), (batch_size, 4, 4)).copy()

    lbl = rng.integers(0, n_classes, (batch_size, h, w)).astype(np.int32)
    lbl[:, : h // 8] = 250  # some ignore pixels
    batch["lbl"] = lbl
    batch["pseudo_depth"] = rng.uniform(0, 1, (batch_size, h, w, 1)).astype(np.float32)
    if with_unlabeled_extras:
        batch["onehot_lbl"] = np.eye(n_classes, dtype=np.float32)[np.clip(lbl, 0, n_classes - 1)]
        batch["is_labeled"] = np.arange(batch_size) % 2 == 0
    return batch
