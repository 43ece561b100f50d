"""Label-less recursive-glob directory dataset for inference: the port's
copy of the JAX package's `data/inference_data.py` (reference
loader/inference_loader.py), with the Cityscapes palette and intrinsics."""

from __future__ import annotations

from ..utils.misc import recursive_glob
from .base import SequenceSegmentationDataset
from .cityscapes import decode_segmap_tocolor, encode_segmap


class InferenceDataset(SequenceSegmentationDataset):
    n_classes = 19
    ignore_index = 250
    full_res_shape = (2048, 1024)
    fx = 2262.52
    fy = 2265.3017905988554
    u0 = 1096.98
    v0 = 513.137

    def __init__(self, **kwargs):
        kwargs.setdefault("load_labels", False)
        super().__init__(**kwargs)

    def _prepare_filenames(self):
        self.images_base = self.root
        self.sequence_base = None
        self.annotations_base = None
        self.files = sorted(recursive_glob(rootdir=self.images_base))

    def get_image_path(self, index, offset=0):
        if offset != 0:
            raise ValueError("the inference dataset has no sequence frames")
        return self.files[index]["name"].rstrip()

    def get_segmentation_path(self, index):
        return None

    def encode_segmap(self, mask):
        return encode_segmap(mask)

    def decode_segmap_tocolor(self, temp):
        return decode_segmap_tocolor(temp)
