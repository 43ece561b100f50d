"""Dataset registry: the port's copy of the JAX package's `data/registry.py`
(reference loader/__init__.py:7-66). `get_loader(name)` maps dataset names
to dataset classes; `build_loader(cfg, split, ...)` builds them with the
split's arguments."""

from __future__ import annotations

from typing import Any, Dict


def get_loader(name: str):
    from .camvid import CamvidDataset
    from .cityscapes import CityscapesDataset
    from .inference_data import InferenceDataset
    from .mapillary import MapillaryVistasDataset
    from .synthetic_dataset import SyntheticDataset

    return {
        "cityscapes": CityscapesDataset,
        "camvid": CamvidDataset,
        "mapillary": MapillaryVistasDataset,
        "synthetic": SyntheticDataset,
        "inference": InferenceDataset,
    }[name]


def build_loader(cfg: Dict[str, Any], split: str, load_labels: bool = True,
                 load_sequence: bool = True, load_labeled: bool = True,
                 load_unlabeled: bool = False, load_onehot: bool = False):
    """The dataset of `split` (reference loader/__init__.py:19-66).

    `cfg` is the `data` section with the merged monodepth_options keys.
    `load_labeled`/`load_unlabeled`/`load_onehot` select the labeled and
    unlabeled files of the semi-supervised loader (reference
    train.py:219-236).
    """
    data_cls = get_loader(cfg["dataset"])
    restrict_dict = None
    if split == "train" and cfg.get("restrict_to_subset") is not None:
        restrict_dict = cfg["restrict_to_subset"]

    is_train = split == "train"
    kwargs = dict(
        root=cfg.get("path"),
        split=split,
        img_size=tuple(cfg.get("img_size", (512, 1024))),
        # val GT may stay at native resolution (reference loader/__init__.py:47)
        downsample_gt=True if is_train else cfg.get("val_downsample_gt", True),
        frame_idxs=tuple(cfg.get("frame_ids", (0, -1, 1))) if load_sequence else (0,),
        num_scales=cfg.get("num_scales", 4),
        augmentations=(cfg.get("augmentations") if split == "train" else None),
        crop_h=cfg.get("crop_h"),
        crop_w=cfg.get("crop_w"),
        load_labels=load_labels,
        load_sequence=load_sequence,
        load_color_full=cfg.get("load_color_full", False),
        color_full_scale=cfg.get("color_full_scale", 0) or 0,
        load_labeled=load_labeled,
        load_unlabeled=load_unlabeled,
        load_onehot=load_onehot or cfg.get("load_onehot", False),
        restrict_dict=restrict_dict,
        generated_depth_dir=cfg.get("generated_depth_dir"),
        num_val_samples=cfg.get("num_val_samples"),
        dataset_seed=cfg.get("dataset_seed", 42),
        only_sequences_with_segmentation=(
            cfg.get("only_sequences_with_segmentation", True) if is_train
            # the reference's own flag for val (loader/__init__.py:58)
            else cfg.get("val_only_sequences_with_segmentation", True)),
    )
    if cfg["dataset"] == "synthetic" and cfg.get("n_samples"):
        kwargs["n_samples"] = cfg["n_samples"]
    return data_cls(**kwargs)
