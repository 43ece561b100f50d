"""Cityscapes dataset: the port's copy of the JAX package's
`data/cityscapes.py` (reference loader/cityscapes_loader.py).

Expects the downsampled trees that `data/prepare_cityscapes.py` writes:
`leftImg8bit_small` (512x1024) or `leftImg8bit_tiny` (256x512), with
`leftImg8bit_sequence_{small,tiny}` for the temporal frames, and the
`gtFine` labels at their own resolution (label ids, resized NEAREST).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.misc import recursive_glob
from .base import SequenceSegmentationDataset

N_CLASSES = 19
IGNORE_INDEX = 250

COLORS = [
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156], [190, 153, 153],
    [153, 153, 153], [250, 170, 30], [220, 220, 0], [107, 142, 35], [152, 251, 152],
    [0, 130, 180], [220, 20, 60], [255, 0, 0], [0, 0, 142], [0, 0, 70],
    [0, 60, 100], [0, 80, 100], [0, 0, 230], [119, 11, 32],
]

VOID_CLASSES = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1]
VALID_CLASSES = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33]

CLASS_NAMES = [
    "unlabelled", "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic_light", "traffic_sign", "vegetation", "terrain", "sky", "person",
    "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]

# label id -> train id lookup table
_ENCODE_LUT = np.full(256, IGNORE_INDEX, dtype=np.int32)
for i, v in enumerate(VALID_CLASSES):
    _ENCODE_LUT[v] = i

_COLOR_LUT = np.zeros((N_CLASSES, 3), dtype=np.float64)
for i, c in enumerate(COLORS):
    _COLOR_LUT[i] = c


def encode_segmap(mask: np.ndarray) -> np.ndarray:
    return _ENCODE_LUT[np.clip(mask, 0, 255)]


def decode_segmap_tocolor(temp: np.ndarray) -> np.ndarray:
    rgb = np.zeros((*temp.shape, 3))
    valid = (temp >= 0) & (temp < N_CLASSES)
    rgb[valid] = _COLOR_LUT[temp[valid].astype(int)] / 255.0
    return rgb


class CityscapesDataset(SequenceSegmentationDataset):
    n_classes = N_CLASSES
    ignore_index = IGNORE_INDEX
    class_names = CLASS_NAMES
    full_res_shape = (2048, 1024)
    # https://www.cityscapes-dataset.com/file-handling/?packageID=8
    fx = 2262.52
    fy = 2265.3017905988554
    u0 = 1096.98
    v0 = 513.137

    def _prepare_filenames(self):
        if self.img_size == (512, 1024):
            tree, seq_tree = "leftImg8bit_small", "leftImg8bit_sequence_small"
        elif self.img_size == (256, 512):
            tree, seq_tree = "leftImg8bit_tiny", "leftImg8bit_sequence_tiny"
        else:
            raise NotImplementedError(f"Unexpected image size {self.img_size}")
        self.images_base = os.path.join(self.root, tree, self.split)
        self.sequence_base = os.path.join(self.root, seq_tree, self.split)
        self.annotations_base = os.path.join(self.root, "gtFine", self.split)
        if self.only_sequences_with_segmentation:
            self.files = sorted(recursive_glob(rootdir=self.images_base))
        else:
            self.files = sorted(recursive_glob(rootdir=self.sequence_base))

    def get_image_path(self, index, offset=0):
        img_path = self.files[index]["name"].rstrip()
        if offset != 0:
            img_path = img_path.replace(self.images_base, self.sequence_base)
            prefix, frame_number, suffix = img_path.rsplit("_", 2)
            img_path = f"{prefix}_{int(frame_number) + offset:06d}_{suffix}"
        return img_path

    def get_segmentation_path(self, index):
        img_path = self.files[index]["name"].rstrip()
        return os.path.join(
            self.annotations_base,
            img_path.split(os.sep)[-2],
            os.path.basename(img_path)[:-15] + "gtFine_labelIds.png",
        )

    def encode_segmap(self, mask):
        return encode_segmap(mask)

    def decode_segmap_tocolor(self, temp):
        return decode_segmap_tocolor(temp)
