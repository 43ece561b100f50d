"""In-memory synthetic dataset with the full dataset interface: the port's
copy of the JAX package's `data/synthetic_dataset.py`, item for item. The
trainer's `data.dataset: synthetic` reads it through `data/registry.py` and
`data/loader.py`, as the JAX trainer does; `data/synthetic.py` makes the
parity tests' and `cli/profile_cli.py`'s batches.

An item is seeded from `hash((index, split))`: python salts string hashes
per process, so items agree across calls of one process only (and between
the two packages only within one process).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..ops.photometric import key_of
from .base import SequenceSegmentationDataset
from .cityscapes import decode_segmap_tocolor


class SyntheticDataset(SequenceSegmentationDataset):
    n_classes = 19
    ignore_index = 250
    full_res_shape = (2048, 1024)
    fx = 2262.52
    fy = 2265.3017905988554
    u0 = 1096.98
    v0 = 513.137

    def __init__(self, root=None, n_samples: int = 16, **kwargs):
        self._n_samples = n_samples
        kwargs.setdefault("img_size", (64, 96))
        super().__init__(root=root, **kwargs)

    # -- filesystem-free hooks --
    def _prepare_filenames(self):
        self.images_base = "synthetic://"
        self.files = [f"synthetic://city/img_{i:06d}_leftImg8bit.png"
                      for i in range(self._n_samples)]

    def _filter_available_files(self):
        pass

    def get_image_path(self, index, offset=0):
        return self.files[index]["name"]

    def get_segmentation_path(self, index):
        return None

    def encode_segmap(self, mask):
        return mask

    def decode_segmap_tocolor(self, temp):
        return decode_segmap_tocolor(temp)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        rng = np.random.default_rng(hash((index, self.split)) % (2**31))
        h, w = self.crop_h, self.crop_w
        is_labeled = self.files[index]["labeled"]
        item: Dict[str, Any] = {
            "idx": np.int32(self.files[index]["idx"]),
            "filename": f"city/img_{index:06d}_leftImg8bit.png",
            "is_labeled": np.bool_(is_labeled),
        }
        base = rng.uniform(0, 1, (h // 8, w // 8, 3)).astype(np.float32)
        up = base.repeat(8, axis=0).repeat(8, axis=1)
        for f in self.frame_idxs:
            img = np.roll(up, 0 if f == 0 else int(f) * 2, axis=1)
            item[key_of("color", f, 0)] = img
            item[key_of("color_aug", f, 0)] = np.clip(
                img + rng.normal(0, 0.01, img.shape).astype(np.float32), 0, 1)
            if self.load_color_full:
                item[key_of("color_full", f, 0)] = img
                item[key_of("color_full_aug", f, 0)] = item[key_of("color_aug", f, 0)]
        for s in range(1, self.num_scales):
            item[key_of("color", 0, s)] = item[key_of("color", 0, 0)][:: 2**s, :: 2**s]
        if self.load_sequence:
            for scale in range(self.num_scales):
                K = self.get_K(0, 0, False)
                K[0, :] /= 2**scale
                K[1, :] /= 2**scale
                item[key_of("K", scale)] = K
                item[key_of("inv_K", scale)] = np.linalg.pinv(K).astype(np.float32)

        if self.load_labels:
            lbl = rng.integers(0, self.n_classes, (h, w)).astype(np.int32)
            lbl[: h // 8] = self.ignore_index
            if not is_labeled:
                lbl[:] = self.ignore_index
            item["lbl"] = lbl
            if self.load_onehot:
                item["onehot_lbl"] = self._onehot(lbl, is_labeled)
        item["pseudo_depth"] = rng.uniform(0, 1, (h, w, 1)).astype(np.float32)
        return item
