"""Offline pseudo-depth in the port against the JAX package's, on the fake
Cityscapes tree of tests/test_depth_estimator.py (2 train and 2 val frames
at 256x512).

Both `DepthEstimator`s read the same teacher weights, the JAX package's
component export (`encoder.msgpack`, `depth.msgpack`, which the port reads
too; JAX's reads it into a zeroed template of the tree in place of its
`model.init`, which compiles op by op) of the port's ResNet-18 depth
model, conditioned as in tests/test_torch_port_models.py (decoder kernels halved, running
statistics from a batch) so that the disparities spread over the sigmoid's
range. Each writes its 8-bit PNGs: the port's lie at most 1 grey level from
JAX's, on at most 0.1% of the pixels (f32 op-order rounding moves a
disparity across a rounding boundary now and then; the normalization and
the round half to even are numpy's on both sides). A second call writes
nothing and leaves the files as they were; the teacher's build leaves the
caller's torch random stream where it was.
"""

import os

import jax
import numpy as np
import torch
from PIL import Image

from improving_segmentation_with_selfsupervised_depth_tpu.data.synthetic import (
    make_synthetic_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.checkpoints import (
    apply_pretraining,
    save_monodepth_models,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.depth_estimator import (
    DepthEstimator as JaxDepthEstimator,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.depth_estimator import (
    DepthEstimator,
)

from tests.test_depth_estimator import fake_cityscapes  # noqa: F401  (fixture)
from tests.test_torch_port_exp210 import (  # noqa: F401  (fixture)
    few_torch_threads,
    port_and_jax_weights,
)

MODEL_CFG = {"backbone_name": "resnet18", "segmentation_name": None, "depth_args": {},
             "frame_ids": [0], "disable_pose": True, "disable_monodepth": False,
             "num_scales": 1}


def _pngs(root):
    found = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                path = os.path.join(dirpath, f)
                found[os.path.relpath(path, root)] = path
    return found


def test_depth_estimator_pngs_match_jax(tmp_path, fake_cityscapes, monkeypatch):  # noqa: F811
    batch = make_synthetic_batch(2, 256, 512, frame_ids=(0,), num_scales=1, seed=3)
    _, variables = port_and_jax_weights(MODEL_CFG, batch, seed=3)
    models = tmp_path / "models"
    save_monodepth_models(str(models / "mono_test_weights"), variables["params"],
                          variables["batch_stats"], include_encoder=True)

    def cfg(gen_dir):
        return {
            "seed": 42,
            "model": dict(MODEL_CFG, depth_estimator_weights="mono_test_weights"),
            "monodepth_options": {"frame_ids": [0], "num_scales": 1},
            "data": {"dataset": "cityscapes", "path": str(fake_cityscapes),
                     "img_size": (256, 512), "frame_ids": [0], "num_scales": 1,
                     "generated_depth_dir": str(gen_dir), "n_workers": 2, "val_split": "val"},
            "training": {"n_workers": 2},
        }

    def init_from_template(self, example):
        """JAX `DepthEstimator._init_model` with a zeroed copy of the weights'
        tree as its template in place of `model.init`'s (which compiles each
        initializer op by op, ~30 s): its `apply_pretraining` then loads the
        weights from the export, and its forward is jitted as there."""
        zeros = jax.tree_util.tree_map(np.zeros_like, variables)
        params, stats = apply_pretraining(self.cfg["model"], zeros["params"],
                                          zeros["batch_stats"], str(models))
        self._vars = {"params": params, "batch_stats": stats}
        self._apply = jax.jit(lambda v, b: self.model.apply(
            v, b, train=False, method=self.model.predict_test_disp))

    monkeypatch.setattr(JaxDepthEstimator, "_init_model", init_from_template)
    JaxDepthEstimator(cfg(tmp_path / "jax")).prepare_depth_estimates()
    monkeypatch.setenv("SDT_MODEL_DIR", str(models))
    rng_state = torch.random.get_rng_state()
    estimator = DepthEstimator(cfg(tmp_path / "port"), device="cpu")
    assert estimator.prepare_depth_estimates() == 4
    assert torch.equal(torch.random.get_rng_state(), rng_state)

    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == 4
    for name in want:
        a = np.asarray(Image.open(got[name]), np.int16)
        b = np.asarray(Image.open(want[name]), np.int16)
        assert a.shape == (256, 512) and a.min() == 0 and a.max() == 255
        diff = np.abs(a - b)
        assert diff.max() <= 1, name
        assert (diff > 0).mean() <= 1e-3, (name, (diff > 0).mean())
        assert len(np.unique(a)) > 64  # the disparities spread over the range

    mtimes = {p: os.path.getmtime(p) for p in got.values()}
    assert DepthEstimator(cfg(tmp_path / "port"), device="cpu").prepare_depth_estimates() == 0
    assert {p: os.path.getmtime(p) for p in got.values()} == mtimes
