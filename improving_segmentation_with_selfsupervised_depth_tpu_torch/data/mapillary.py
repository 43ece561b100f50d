"""Mapillary Vistas dataset: the port's copy of the JAX package's
`data/mapillary.py` (reference loader/mapillary_vistas_loader.py): 65
classes, the palette read from the dataset's config.json, RGB labels encoded
to ids by color."""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.misc import recursive_glob
from .base import SequenceSegmentationDataset


class MapillaryVistasDataset(SequenceSegmentationDataset):
    n_classes = 65
    ignore_index = 250
    full_res_shape = (4000, 3000)
    fx = fy = 1.0
    u0 = v0 = 0.0

    def __init__(self, **kwargs):
        kwargs.setdefault("load_sequence", False)
        super().__init__(**kwargs)
        self.class_names, self.class_ids, self.class_colors = self._parse_config()
        colors = np.asarray(self.class_colors, dtype=np.int64)
        self._color_hash = colors[:, 0] * 256 * 256 + colors[:, 1] * 256 + colors[:, 2]

    def _parse_config(self):
        with open(os.path.join(self.root, "config.json")) as f:
            config = json.load(f)
        names, ids, colors = [], [], []
        for label_id, label in enumerate(config["labels"]):
            names.append(label["readable"])
            ids.append(label_id)
            colors.append(label["color"])
        return names, ids, colors

    def _prepare_filenames(self):
        self.images_base = os.path.join(self.root, self.split, "images")
        self.annotations_base = os.path.join(self.root, self.split, "labels")
        self.files = sorted(recursive_glob(rootdir=self.images_base, suffix=".jpg"))

    def get_image_path(self, index, offset=0):
        if offset != 0:
            raise ValueError("Mapillary Vistas has no sequence frames")
        return self.files[index]["name"].rstrip()

    def get_segmentation_path(self, index):
        img_path = self.files[index]["name"].rstrip()
        return os.path.join(
            self.annotations_base, img_path.split(os.sep)[-1].replace(".jpg", ".png"))

    def encode_segmap(self, mask):
        # mask is RGB (H, W, 3): color -> id (the last class, 65, is ignored)
        if mask.ndim == 2:
            return mask  # already ids
        h = (mask[..., 0].astype(np.int64) * 256 * 256
             + mask[..., 1].astype(np.int64) * 256 + mask[..., 2].astype(np.int64))
        id_mask = np.zeros(mask.shape[:2], dtype=np.int32)
        for label, ch in enumerate(self._color_hash):
            id_mask[h == ch] = label
        id_mask[id_mask == 65] = self.ignore_index
        return id_mask

    def decode_segmap_tocolor(self, temp):
        colors = np.asarray(self.class_colors, dtype=np.float64)
        rgb = np.zeros((*temp.shape, 3))
        valid = (temp >= 0) & (temp < self.n_classes)
        rgb[valid] = colors[temp[valid].astype(int)] / 255.0
        return rgb
