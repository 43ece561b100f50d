"""The port's data layer against the JAX package's, byte for byte.

On the fake trees of tests/test_data.py (Cityscapes, 256x512) and
tests/test_datasets_extra.py (CamVid, Mapillary), each dataset of both
packages is built with the same arguments and its items compared in every
key, dtype, shape and byte, after `random.seed(s)` on both sides: flips,
crops (drawn even where nothing is cropped: validation), `color_aug`,
`color_full` keys, one-hot labels, unlabeled items. The color jitter's
parameters come from `random.Random()` seeded from the OS in both packages;
the jitter cases replace `random.Random` by one seeded factory, reset before
each side. Then `restrict_to_subset`, `build_loader`'s semi-supervised
composition, the threaded `DataLoader` (one worker, so that the global draws
come in item order; `drop_last`, epochs that continue one shuffle generator,
`infinite_iterator`), the move to the device, and `prepare_cityscapes`'s
files. No JAX array is made: the JAX data layer is numpy and PIL.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from improving_segmentation_with_selfsupervised_depth_tpu.data import loader as jloader
from improving_segmentation_with_selfsupervised_depth_tpu.data import (
    prepare_cityscapes as jprepare,
)
from improving_segmentation_with_selfsupervised_depth_tpu.data import registry as jregistry
from improving_segmentation_with_selfsupervised_depth_tpu.data import utils as jutils
from improving_segmentation_with_selfsupervised_depth_tpu.data.camvid import (
    CamvidDataset as JCamvid,
)
from improving_segmentation_with_selfsupervised_depth_tpu.data.cityscapes import (
    CityscapesDataset as JCityscapes,
)
from improving_segmentation_with_selfsupervised_depth_tpu.data.mapillary import (
    MapillaryVistasDataset as JMapillary,
)
from improving_segmentation_with_selfsupervised_depth_tpu.data.synthetic_dataset import (
    SyntheticDataset as JSynthetic,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data import loader, registry
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data import (
    prepare_cityscapes as prepare,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data import utils
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.camvid import CamvidDataset
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.cityscapes import (
    CityscapesDataset,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.mapillary import (
    MapillaryVistasDataset,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic_dataset import (
    SyntheticDataset,
)

from tests.test_data import fake_cityscapes  # noqa: F401  (fixture)
from tests.test_datasets_extra import fake_camvid, fake_mapillary  # noqa: F401  (fixtures)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "improving_segmentation_with_selfsupervised_depth_tpu_torch"
_RANDOM = random.Random


class SeededRandoms:
    """A stand-in for `random.Random`: the n-th instance made is seeded with
    base + n, so both packages' items get the same jitter parameters."""

    def __init__(self, base=100):
        self.base, self.n = base, 0

    def __call__(self, *args):
        self.n += 1
        return _RANDOM(self.base + self.n)


def assert_items_equal(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, str):
            assert a == b, (where, k)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), (where, k)


def items_of(cls, seed, kwargs, monkeypatch=None, jitter=False):
    """All items of `cls(**kwargs)` after random.seed(seed) (and with
    `jitter`, the seeded `random.Random`)."""
    if jitter:
        monkeypatch.setattr(random, "Random", SeededRandoms())
    random.seed(seed)
    ds = cls(**kwargs)
    return ds, [ds[i] for i in range(len(ds))]


CITYSCAPES_CASES = {
    "train_flip_crop": dict(split="train", crop_h=128, crop_w=128,
                            augmentations={"random_horizontal_flip": 0.5}),
    "train_color_aug_full": dict(split="train", crop_h=64, crop_w=128, load_color_full=True,
                                 color_full_scale=1,
                                 augmentations={"random_horizontal_flip": 0.5,
                                                "color_aug": True}),
    "onehot_labeled_and_unlabeled": dict(
        split="train", crop_h=128, crop_w=256, load_onehot=True, load_unlabeled=True,
        restrict_dict={"mode": "random", "n_subset": 1}, dataset_seed=7,
        augmentations={"random_horizontal_flip": 0.5}),
    "val_uncropped_native_gt": dict(split="val", crop_h=128, crop_w=128,
                                    downsample_gt=False),
    "no_sequence_no_labels": dict(split="train", crop_h=128, crop_w=128, load_sequence=False,
                                  load_labels=False),
}


@pytest.mark.parametrize("case", sorted(CITYSCAPES_CASES))
def test_cityscapes_items_are_byte_identical(fake_cityscapes, monkeypatch, case):  # noqa: F811
    kwargs = dict(root=str(fake_cityscapes), img_size=(256, 512), frame_idxs=(0, -1, 1),
                  num_scales=4, **CITYSCAPES_CASES[case])
    jitter = kwargs.get("augmentations", {}).get("color_aug", False)
    _, want = items_of(JCityscapes, 3, kwargs, monkeypatch, jitter)
    ds, got = items_of(CityscapesDataset, 3, kwargs, monkeypatch, jitter)
    assert len(got) == len(want) and got
    for i, (g, w) in enumerate(zip(got, want)):
        assert_items_equal(g, w, f"{case}[{i}]")
    if case == "onehot_labeled_and_unlabeled":
        assert [bool(it["is_labeled"]) for it in got].count(True) == 1
        assert any(not it["onehot_lbl"].any() for it in got)
    if case == "train_color_aug_full":
        assert "color_full_aug_-1_0" in got[0] and got[0]["color_full_0_0"].shape == (128, 256, 3)
        # the seeded factory's jitter ran on some item
        assert any(not np.array_equal(it["color_aug_0_0"], it["color_0_0"]) for it in got)
    assert ds.decode_segmap_tocolor(got[0].get("lbl", np.zeros((2, 2), np.int32))).shape[-1] == 3


@pytest.mark.parametrize("name", ["camvid", "mapillary"])
def test_camvid_and_mapillary_items_are_byte_identical(fake_camvid, fake_mapillary,  # noqa: F811
                                                       name):
    if name == "camvid":
        classes = (JCamvid, CamvidDataset)
        kwargs = dict(root=str(fake_camvid), img_size=(360, 480), crop_h=128, crop_w=256,
                      frame_idxs=(0,), num_scales=1, load_sequence=False, load_onehot=True,
                      augmentations={"random_horizontal_flip": 0.5})
    else:
        classes = (JMapillary, MapillaryVistasDataset)
        kwargs = dict(root=str(fake_mapillary), img_size=(512, 704), crop_h=128, crop_w=128,
                      frame_idxs=(0,), num_scales=1, load_sequence=False,
                      augmentations={"random_horizontal_flip": 0.5})
    for split in ("train", {"camvid": "test", "mapillary": "validation"}[name]):
        _, want = items_of(classes[0], 11, dict(kwargs, split=split))
        _, got = items_of(classes[1], 11, dict(kwargs, split=split))
        assert len(got) == len(want) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            assert_items_equal(g, w, f"{name} {split}[{i}]")


@pytest.mark.parametrize("kwargs", [
    dict(split="train", img_size=(64, 96), frame_idxs=(0, -1, 1), num_scales=4,
         load_onehot=True, load_unlabeled=True, restrict_dict={"mode": "random", "n_subset": 3}),
    dict(split="val", img_size=(32, 64), frame_idxs=(0,), num_scales=1, load_sequence=False,
         load_color_full=True),
])
def test_synthetic_items_are_byte_identical(kwargs):
    """Within one process: the items are seeded from python's salted hash."""
    want = JSynthetic(n_samples=8, **kwargs)
    got = SyntheticDataset(n_samples=8, **kwargs)
    assert len(got) == len(want)
    for i in range(len(got)):
        assert_items_equal(got[i], want[i], f"synthetic[{i}]")


@pytest.mark.parametrize("mode,subset,labeled,unlabeled", [
    ("random", None, True, False), ("random", None, True, True),
    ("random", None, False, True), ("fixed", [4, 0, 7], True, True)])
def test_restrict_to_subset_matches_jax(mode, subset, labeled, unlabeled):
    files = [{"idx": i, "name": f"f{i}", "labeled": True} for i in range(12)]
    args = dict(mode=mode, n_subset=3, seed=42, load_labeled=labeled,
                load_unlabeled=unlabeled, subset=subset)
    np.random.seed(5)
    want = jutils.restrict_to_subset(files, **args)
    np.random.seed(5)
    got = utils.restrict_to_subset(files, **args)
    assert got == want and np.random.rand() == (np.random.seed(5), np.random.rand())[1]
    assert all(f["labeled"] for f in files)  # the input is not changed


def _composition(build, cfg):
    """The labeled/unlabeled file lists of the trainer's loaders."""
    out = {}
    for name, kw in (("train", {}),
                     ("unlabeled", dict(load_labeled=True, load_unlabeled=True,
                                        load_onehot=True)),
                     ("only_unlabeled", dict(load_labeled=False, load_unlabeled=True)),
                     ("val", {})):
        ds = build({**cfg, "restrict_to_subset": None} if name == "val" else cfg,
                   "val" if name == "val" else "train", **kw)
        out[name] = [(f["idx"], f["name"], f["labeled"]) for f in ds.files]
        out[name + "_attrs"] = (ds.crop_h, ds.crop_w, ds.frame_idxs, ds.num_scales,
                                ds.load_onehot, ds.downsample_gt, type(ds).__name__)
    return out


def test_build_loader_composition_matches_jax(fake_cityscapes):  # noqa: F811
    cfg = {"dataset": "cityscapes", "path": str(fake_cityscapes), "img_size": [256, 512],
           "frame_ids": [0, -1, 1], "num_scales": 4, "crop_h": 128, "crop_w": 128,
           "augmentations": {"random_horizontal_flip": 0.5}, "dataset_seed": 3,
           "restrict_to_subset": {"mode": "random", "n_subset": 2}}
    want = _composition(jregistry.build_loader, cfg)
    got = _composition(registry.build_loader, cfg)
    assert got == want
    assert len(got["train"]) == 2 and len(got["unlabeled"]) == 3 and len(got["val"]) == 3
    assert [lab for _, _, lab in got["unlabeled"]] == [True, True, False]
    assert registry.get_loader("synthetic") is SyntheticDataset
    with pytest.raises(NotImplementedError, match="ROADMAP.*CLIs and experiments"):
        registry.get_loader("inference")


def _batches(loader_mod, cls, kwargs, drop_last, epochs=3, seed=21):
    """Whole epochs only: a producer left mid-epoch would go on drawing from
    the global random stream while the other package's loader runs."""
    random.seed(seed)
    dl = loader_mod.DataLoader(cls(**kwargs), batch_size=2, shuffle=True, drop_last=drop_last,
                               num_workers=1, seed=0)
    it = loader_mod.infinite_iterator(dl)
    return len(dl), [next(it) for _ in range(epochs * len(dl))]


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_batches_match_jax(fake_cityscapes, drop_last):  # noqa: F811
    """Three epochs of a 3-item dataset at batch 2 (one batch an epoch, or
    two without drop_last), one shuffle generator across epochs."""
    kwargs = dict(root=str(fake_cityscapes), split="train", img_size=(256, 512), crop_h=64,
                  crop_w=128, frame_idxs=(0, 1), num_scales=2,
                  augmentations={"random_horizontal_flip": 0.5})
    n_want, want = _batches(jloader, JCityscapes, kwargs, drop_last)
    n_got, got = _batches(loader, CityscapesDataset, kwargs, drop_last)
    assert n_got == n_want == (1 if drop_last else 2)
    assert [len(b["filename"]) for b in got] == [len(b["filename"]) for b in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_items_equal(g, w, f"batch {i}")
    orders = [tuple(b["idx"]) for b in got]
    assert len(set(orders)) > 1  # the epochs are shuffled anew


def test_to_device_batch_and_the_loader_thread():
    ds = SyntheticDataset(n_samples=5, split="train", img_size=(32, 64), frame_idxs=(0, 1),
                          num_scales=2, load_onehot=True)
    host = loader.collate([ds[0], ds[1]])
    dev = loader.to_device_batch(host, "cpu")
    assert "filename" not in dev and dev["lbl"].dtype == torch.int64
    assert dev["color_aug_0_0"].shape == (2, 3, 32, 64) and dev["color_aug_0_0"].is_contiguous()
    assert torch.equal(dev["onehot_lbl"], torch.from_numpy(host["onehot_lbl"]).permute(0, 3, 1, 2))
    assert dev["K_0"].shape == (2, 4, 4) and dev["is_labeled"].dtype == torch.bool
    # a failing item surfaces in the consumer; an epoch left early stops its producer
    # batches of 1: the producer is still prefetching when the consumer stops
    dl = loader.DataLoader(ds, 1, shuffle=False, num_workers=2)
    dl.dataset = type("Broken", (), {"__len__": lambda s: 4,
                                     "__getitem__": lambda s, i: 1 / 0})()
    with pytest.raises(ZeroDivisionError):
        next(iter(dl))
    dl.dataset = ds
    it = iter(dl)
    next(it)
    producer = dl._producers[-1][0]
    dl.close()  # stops and joins the producer still prefetching
    assert dl._pool is None and not producer.is_alive()
    it.close()


def test_prepare_cityscapes_writes_the_jax_packages_files(tmp_path):
    src = tmp_path / "leftImg8bit" / "train" / "town"
    src.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        small = rng.integers(0, 255, (8, 16, 3), dtype=np.uint8)
        big = np.asarray(Image.fromarray(small).resize((128, 64), Image.BILINEAR))
        Image.fromarray(big).save(src / f"town_{i:06d}_000019_leftImg8bit.png")
    ins, want_dir = str(tmp_path / "leftImg8bit"), str(tmp_path / "want")
    for f in sorted(os.listdir(src)):
        jprepare.process_image((str(src / f), ins, want_dir, 98, 0.5))
    got_dir = str(tmp_path / "got")
    prepare.main(["--in-dir", ins, "--out-dir", got_dir, "--workers", "1"])
    names = sorted(os.listdir(os.path.join(want_dir, "train", "town")))
    assert names == sorted(os.listdir(os.path.join(got_dir, "train", "town"))) and len(names) == 2
    for n in names:
        with open(os.path.join(want_dir, "train", "town", n), "rb") as a, \
                open(os.path.join(got_dir, "train", "town", n), "rb") as b:
            assert a.read() == b.read(), n
    # a corrupted output is found and written again
    broken = os.path.join(got_dir, "train", "town", names[0])
    with open(broken, "r+b") as f:
        f.truncate(40)
    assert prepare.repair(ins, got_dir, workers=1) == [broken]
    with open(os.path.join(want_dir, "train", "town", names[0]), "rb") as a, \
            open(broken, "rb") as b:
        assert a.read() == b.read()


def test_the_synthetic_loader_runs_without_pil():
    code = (
        "import sys\n"
        f"from {PKG}.data import registry, loader\n"
        "cfg = {'dataset': 'synthetic', 'img_size': [32, 64], 'n_samples': 4}\n"
        "ds = registry.build_loader(cfg, 'train')\n"
        "b = next(iter(loader.DataLoader(ds, 2, num_workers=2)))\n"
        "assert b['color_aug_0_0'].shape == (2, 32, 64, 3)\n"
        "assert 'PIL' not in sys.modules, 'PIL imported'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
