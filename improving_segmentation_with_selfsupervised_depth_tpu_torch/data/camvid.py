"""CamVid dataset: the port's copy of the JAX package's `data/camvid.py`
(reference loader/camvid_loader.py): 12 classes, no sequences."""

from __future__ import annotations

import os

import numpy as np

from ..utils.misc import recursive_glob
from .base import SequenceSegmentationDataset

_COLORS = np.array([
    [128, 128, 128], [128, 0, 0], [192, 192, 128], [128, 64, 128],
    [60, 40, 222], [128, 128, 0], [192, 128, 128], [64, 64, 128],
    [64, 0, 128], [64, 64, 0], [0, 128, 192], [0, 0, 0],
])


class CamvidDataset(SequenceSegmentationDataset):
    n_classes = 12
    ignore_index = 250
    class_names = [
        "sky", "building", "pole", "road", "pavement", "tree", "signsymbol",
        "fence", "car", "pedestrian", "bicyclist", "unlabeled",
    ]
    full_res_shape = (480, 360)
    fx = fy = 1.0
    u0 = v0 = 0.0

    def __init__(self, **kwargs):
        kwargs.setdefault("load_sequence", False)
        super().__init__(**kwargs)
        if self.frame_idxs != (0,):
            raise ValueError(f"CamVid has no sequence frames (frame_idxs {self.frame_idxs})")

    def _prepare_filenames(self):
        self.images_base = os.path.join(self.root, self.split)
        self.annotations_base = os.path.join(self.root, self.split + "annot")
        self.files = sorted(recursive_glob(rootdir=self.images_base))

    def get_image_path(self, index, offset=0):
        if offset != 0:
            raise ValueError("CamVid has no sequence frames")
        return self.files[index]["name"].rstrip()

    def get_segmentation_path(self, index):
        img_path = self.files[index]["name"].rstrip()
        return os.path.join(self.annotations_base, img_path.split(os.sep)[-1])

    def encode_segmap(self, mask):
        mask = mask.copy()
        mask[mask == 11] = self.ignore_index  # CamVid 'unlabelled'
        return mask

    def decode_segmap_tocolor(self, temp):
        rgb = np.zeros((*temp.shape, 3))
        valid = (temp >= 0) & (temp < self.n_classes)
        rgb[valid] = _COLORS[temp[valid].astype(int)] / 255.0
        return rgb
