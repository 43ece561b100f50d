"""Sequence + segmentation base dataset (host-side numpy pipeline): the
port's copy of the JAX package's `data/base.py` (reference
loader/sequence_segmentation_loader.py:14-357), item for item and draw for
draw. Items are string-keyed dicts of numpy arrays in NHWC; the loader
(`data/loader.py`) stacks them and the trainer moves them to the device as
NCHW tensors. Per item (reference __getitem__, 183-250):

  load frames at temporal offsets -> optional shared horizontal flip ->
  random crop with per-scale intrinsics adjustment (252-288, get_K principal-
  point shift 332-342) -> multi-scale LANCZOS resize + shared-parameter
  color jitter (290-330) -> label encode (ignore=250) -> optional one-hot.

The draws: the color-jitter decision, the flip and the crop offsets come
from python's global `random` (seeded by the trainer), the jitter's
parameters from a `random.Random()` seeded from the OS, as in the JAX
package. The crop offsets are drawn even where nothing is cropped.

Batch-dict keys (string form of the reference's tuple keys):
  color_{f}_{s}, color_aug_{f}_{s}  float32 (H, W, 3) in [0, 1]
  color_full_{f}_0, color_full_aug_{f}_0  uncropped frames (`load_color_full`)
  K_{s}, inv_K_{s}                  float32 (4, 4)
  lbl                               int32 (H, W)
  pseudo_depth                      float32 (H, W, 1)
  onehot_lbl                        float32 (H, W, C)
  is_labeled                        bool; idx int32; filename str (host only)

PIL is imported where a frame is decoded, flipped, cropped, resized or
jittered, so a dataset that overrides `__getitem__` runs without it.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.photometric import key_of
from .utils import antialias, pil_loader, restrict_to_subset


def _color_jitter_params(rng: random.Random,
                         brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                         saturation=(0.8, 1.2), hue=(-0.1, 0.1)):
    """torchvision ColorJitter.get_params semantics: random factors + random
    application order (reference sequence_segmentation_loader.py:297-299)."""
    order = [0, 1, 2, 3]
    rng.shuffle(order)
    return {
        "order": order,
        "brightness": rng.uniform(*brightness),
        "contrast": rng.uniform(*contrast),
        "saturation": rng.uniform(*saturation),
        "hue": rng.uniform(*hue),
    }


def _apply_color_jitter(img, p: Dict[str, Any]):
    from PIL import Image, ImageEnhance

    for t in p["order"]:
        if t == 0:
            img = ImageEnhance.Brightness(img).enhance(p["brightness"])
        elif t == 1:
            img = ImageEnhance.Contrast(img).enhance(p["contrast"])
        elif t == 2:
            img = ImageEnhance.Color(img).enhance(p["saturation"])
        elif t == 3 and abs(p["hue"]) > 1e-6:
            hsv = np.array(img.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(p["hue"] * 255)) % 256
            img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return img


def _flip(img):
    from PIL import Image

    return img.transpose(Image.FLIP_LEFT_RIGHT)


class SequenceSegmentationDataset:
    # subclass attributes
    n_classes: int = 19
    ignore_index: int = 250
    full_res_shape: Tuple[int, int] = (2048, 1024)
    fx = fy = u0 = v0 = None

    def __init__(
        self,
        root: Optional[str],
        split: str = "train",
        img_size: Tuple[int, int] = (512, 1024),
        crop_h: Optional[int] = None,
        crop_w: Optional[int] = None,
        augmentations: Optional[Dict[str, Any]] = None,
        downsample_gt: bool = True,
        frame_idxs: Sequence[int] = (0,),
        num_scales: int = 1,
        restrict_dict: Optional[Dict[str, Any]] = None,
        dataset_seed: int = 42,
        load_labeled: bool = True,
        load_unlabeled: bool = False,
        generated_depth_dir: Optional[str] = None,
        load_onehot: bool = False,
        num_val_samples: Optional[int] = None,
        only_sequences_with_segmentation: bool = True,
        load_labels: bool = True,
        load_sequence: bool = True,
        load_color_full: bool = False,
        color_full_scale: int = 0,
        n_classes: Optional[int] = None,
    ):
        self.root = root
        self.split = split
        self.is_train = split == "train"
        self.augmentations = augmentations or {}
        self.downsample_gt = downsample_gt
        self.seed = dataset_seed
        self.restrict_dict = restrict_dict
        self.load_labeled = load_labeled
        self.load_unlabeled = load_unlabeled
        self.generated_depth_dir = generated_depth_dir
        self.load_onehot = load_onehot
        self.num_val_samples = num_val_samples
        self.img_size = img_size if isinstance(img_size, tuple) else (img_size, img_size)
        self.height, self.width = self.img_size
        self.num_scales = num_scales
        self.frame_idxs = tuple(frame_idxs)
        self.only_sequences_with_segmentation = only_sequences_with_segmentation
        self.load_labels = load_labels
        self.load_sequence = load_sequence
        # uncropped full frames for the pose network (`provide_uncropped_for_pose`)
        self.load_color_full = load_color_full
        self.color_full_scale = color_full_scale
        if self.width < self.height:
            raise ValueError(f"img_size {self.img_size}: the width is below the height")

        if not self.load_sequence:
            self.frame_idxs = (0,)
            self.num_scales = 1

        if crop_h is None or crop_w is None or not self.is_train:
            self.crop_h, self.crop_w = self.height, self.width
        else:
            self.crop_h, self.crop_w = crop_h, crop_w
        if self.crop_w < self.crop_h:
            raise ValueError(f"crop {self.crop_h}x{self.crop_w}: the width is below the height")

        self.enable_color_aug = self.augmentations.get("color_aug", False)

        self._prepare_filenames()
        self.files: List[Dict[str, Any]] = [
            {"idx": i, "name": f, "labeled": True} for i, f in enumerate(self.files)
        ]
        if len(self.files) == 0:
            raise RuntimeError(f"Found no segmentation files in {self.images_base}")

        self._filter_available_files()

        if self.split == "train" and self.restrict_dict is not None:
            self.files = restrict_to_subset(
                self.files, seed=self.seed, load_labeled=self.load_labeled,
                load_unlabeled=self.load_unlabeled, **self.restrict_dict)
        if self.split != "train" and self.num_val_samples is not None:
            self.files = self.files[: self.num_val_samples]
        if not self.files:
            raise RuntimeError(f"No files for split={split} found in {self.images_base}")

    # ---------------- subclass hooks ----------------
    def _prepare_filenames(self):
        raise NotImplementedError

    def get_image_path(self, index: int, offset: int = 0) -> str:
        raise NotImplementedError

    def get_segmentation_path(self, index: int) -> Optional[str]:
        raise NotImplementedError

    def encode_segmap(self, mask: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def decode_segmap_tocolor(self, temp: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # ---------------- pipeline ----------------
    def _filter_available_files(self):
        filtered = []
        for idx in range(len(self.files)):
            available = all(
                os.path.isfile(self.get_image_path(idx, j)) for j in self.frame_idxs
            )
            if available:
                filtered.append(self.files[idx])
            elif self.only_sequences_with_segmentation:
                raise RuntimeError(
                    f"Missing sequence frames for {self.files[idx]['name']}")
        self.files = filtered

    def __len__(self):
        return len(self.files)

    def get_color(self, index, offset, do_flip):
        img = pil_loader(self.get_image_path(index, offset), self.width, self.height)
        return _flip(img) if do_flip else img

    def get_segmentation(self, index, do_flip):
        size = (self.width, self.height) if self.downsample_gt else (-1, -1)
        lbl = pil_loader(self.get_segmentation_path(index), *size, is_segmentation=True)
        return _flip(lbl) if do_flip else lbl

    def get_teacher_depth(self, index, do_flip):
        if not self.generated_depth_dir:
            return None
        img_path = self.get_image_path(index, 0)
        subname = os.path.join(*img_path.split(os.sep)[-3:])
        depth_path = os.path.join(self.generated_depth_dir, subname.replace(".jpg", ".png"))
        depth = pil_loader(depth_path, -1, -1, is_segmentation=True, use_cache=True)
        return _flip(depth) if do_flip else depth

    def get_K(self, u_offset: float, v_offset: float, do_flip: bool) -> np.ndarray:
        u0, v0 = self.u0, self.v0
        if do_flip:
            u0 = self.full_res_shape[0] - u0
            v0 = self.full_res_shape[1] - v0
        return np.array(
            [[self.fx, 0, u0 - u_offset, 0],
             [0, self.fy, v0 - v_offset, 0],
             [0, 0, 1, 0],
             [0, 0, 0, 1]], dtype=np.float32)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        rng = random.Random()  # seeded from the OS, as in the JAX package
        is_labeled = self.files[index]["labeled"]
        item: Dict[str, Any] = {
            "idx": np.int32(self.files[index]["idx"]),
            "filename": os.path.join(*self.get_image_path(index).split(os.sep)[-3:]),
            "is_labeled": np.bool_(is_labeled),
        }
        do_color_aug = self.is_train and random.random() > 0.5 and self.enable_color_aug
        do_flip = (
            self.is_train
            and "random_horizontal_flip" in self.augmentations
            and random.random() < self.augmentations["random_horizontal_flip"]
        )

        frames = {f: self.get_color(index, f, do_flip) for f in self.frame_idxs}
        full_frames = dict(frames)  # pre-crop views for color_full keys
        lbl = self.get_segmentation(index, do_flip) if self.load_labels else None
        pseudo_depth = self.get_teacher_depth(index, do_flip)

        # --- random crop with intrinsics shift (reference 252-288) ---
        w, h = frames[0].size
        th, tw = self.crop_h, self.crop_w
        if w < tw or h < th:
            raise NotImplementedError("crop larger than image")
        x1 = random.randint(0, w - tw)
        y1 = random.randint(0, h - th)
        box = (x1, y1, x1 + tw, y1 + th)
        if (w, h) != (tw, th):
            frames = {f: img.crop(box) for f, img in frames.items()}
            if lbl is not None:
                lbl = lbl.crop(box)
            if pseudo_depth is not None:
                pseudo_depth = pseudo_depth.crop(box)

        if self.load_sequence:
            # the reference keeps full-resolution focals while shifting the
            # principal point by the load-resolution crop offset
            # (sequence_segmentation_loader.py:276-286, 332-342)
            for scale in range(self.num_scales):
                K = self.get_K(x1, y1, do_flip)
                K[0, :] /= 2**scale
                K[1, :] /= 2**scale
                item[key_of("K", scale)] = K
                item[key_of("inv_K", scale)] = np.linalg.pinv(K).astype(np.float32)

        # --- multi-scale resize + shared color jitter (reference 290-330) ---
        jitter = _color_jitter_params(rng) if do_color_aug else None
        for f, img in frames.items():
            prev = img
            for s in range(self.num_scales):
                if s > 0:
                    prev = prev.resize((tw // 2**s, th // 2**s), antialias())
                item[key_of("color", f, s)] = np.asarray(prev, np.float32) / 255.0
            aug = _apply_color_jitter(img, jitter) if jitter else img
            item[key_of("color_aug", f, 0)] = np.asarray(aug, np.float32) / 255.0

        if self.load_color_full:
            s = 2**self.color_full_scale
            for f in self.frame_idxs:
                full = full_frames[f].resize((self.width // s, self.height // s), antialias())
                item[key_of("color_full", f, 0)] = np.asarray(full, np.float32) / 255.0
                aug = _apply_color_jitter(full, jitter) if jitter else full
                item[key_of("color_full_aug", f, 0)] = np.asarray(aug, np.float32) / 255.0

        if lbl is not None:
            enc = self.encode_segmap(np.array(lbl, dtype=np.uint8).astype(np.int32))
            if not is_labeled:
                enc = np.full_like(enc, self.ignore_index)
            item["lbl"] = enc.astype(np.int32)
            if self.load_onehot:
                item["onehot_lbl"] = self._onehot(enc, is_labeled)

        if pseudo_depth is not None:
            d = np.asarray(pseudo_depth, np.float32)
            if d.ndim == 2:
                d = d[..., None]
            item["pseudo_depth"] = d / 255.0

        return item

    def _onehot(self, enc: np.ndarray, is_labeled: bool) -> np.ndarray:
        """(H, W, C) f32 one-hot of the encoded labels (ignore: all zero;
        an unlabeled item: all zero)."""
        if not is_labeled:
            return np.zeros((*enc.shape, self.n_classes), np.float32)
        dense = enc.copy()
        dense[dense == self.ignore_index] = self.n_classes
        return np.eye(self.n_classes + 1, dtype=np.float32)[dense][..., : self.n_classes]
