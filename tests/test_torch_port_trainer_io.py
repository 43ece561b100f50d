"""The port's run loop and full-state checkpoints against the JAX trainer's.

One JAX `Trainer` run, shared through a module fixture: seg-only ResNet-18
with 32x64 crops on the fake Cityscapes tree of
tests/test_trainer_cityscapes.py (validated uncropped at 256x512), 5
iterations, `val_interval` 2, `save_model` on. The port's run of the same
config trains, validates and saves at the same steps and writes the same
`metrics.jsonl` tags at the same steps (the values differ: the two models
start from other random weights). Then, on the port alone (CPU, f32):
- a full-state round trip is bit-identical, under SGD (with a plateau
  `lr_scale`) and under Adam with the EMA teacher (whose components go out
  with `save_monodepth_ema`);
- a run cut after its second step and `auto_resume`d ends at the same
  iteration, with the same files, as the uninterrupted one;
- an asynchronous writer's error surfaces at `wait_for_saves`;
- `EarlyStopping` and the plateau step match the JAX package's on score
  sequences;
- a JAX-exported component `.msgpack` loads into the port equal to
  `state_dict_from_jax` of the same tree;
- the trainer's `dataset: synthetic` batches are the JAX package's
  `SyntheticDataset` items through the loader, and validation leaves
  `best_iou` to the loop.
"""

import json
import os
import random
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from improving_segmentation_with_selfsupervised_depth_tpu.data.loader import (
    DataLoader as JDataLoader,
)
from improving_segmentation_with_selfsupervised_depth_tpu.data.synthetic_dataset import (
    SyntheticDataset as JSynthetic,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine import checkpoints as jckpt
from improving_segmentation_with_selfsupervised_depth_tpu.engine import trainer as jtrainer
from improving_segmentation_with_selfsupervised_depth_tpu.engine.early_stopping import (
    EarlyStopping as JEarlyStopping,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.full_model_interop import (
    convert_full_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.loader import (
    collate,
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import checkpoints, trainer
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.early_stopping import (
    EarlyStopping,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.interop import (
    state_dict_from_jax,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import build_model

from tests.test_torch_port_checkpoints import SDE_CFG
from tests.test_torch_port_exp210 import few_torch_threads  # noqa: F401  (fixture)
from tests.test_torch_port_step import _tiny_train_cfg
from tests.test_trainer_cityscapes import fake_cityscapes


def seg_cfg(root, log_path, train_iters=5):
    """Seg-only dilated ResNet-18, 32x64 crops of the 256x512 tree, batch 2."""
    return {
        "seed": 42,
        "model": {"arch": "joint_segmentation_depth", "backbone_name": "resnet18",
                  # stride 16: the 32x64 crop leaves a 2x4 bottleneck (the
                  # port's reflection pads need more than one row)
                  "replace_stride_with_dilation": [False, False, True],
                  "segmentation_name": "joint_seg_depth_dec",
                  "segmentation_args": {"layers": [9], "head_inter": False,
                                        "output_stride": 1},
                  "depth_args": {}, "disable_monodepth": True, "disable_pose": True,
                  "backbone_pretraining": "none"},
        "monodepth_options": {"frame_ids": [0, -1, 1], "num_scales": 1, "height": 256,
                              "width": 512, "crop_h": 32, "crop_w": 64},
        "data": {"dataset": "cityscapes", "path": str(root), "img_size": [256, 512],
                 "n_workers": 1, "augmentations": {"random_horizontal_flip": 0.5}},
        "training": {"log_path": str(log_path), "train_iters": train_iters, "batch_size": 2,
                     "val_batch_size": 2, "print_interval": 1, "val_interval": 2,
                     "optimizer": {"name": "sgd", "lr": 1e-2, "momentum": 0.9},
                     "lr_schedule": None, "segmentation_lambda": 1.0,
                     "monodepth_lambda": 0.0, "save_model": True, "n_tensorboard_imgs": 2},
    }


def tags_by_step(log_path):
    out = {}
    with open(os.path.join(log_path, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["step"], set()).add(r["tag"])
    return out


def files_of(log_path):
    """The run's files, the timestamped ones by kind."""
    return sorted("run_*.log" if f.startswith("run_") else
                  "events.out.tfevents.*" if f.startswith("events.") else f
                  for f in os.listdir(log_path))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer on the fake tree (fixture of
    tests/test_trainer_cityscapes.py, made here for the module)."""
    base = tmp_path_factory.mktemp("jax_run")
    root = fake_cityscapes.__wrapped__(base)  # the fixture's function, once for the module
    log_path = base / "log"
    cfg = seg_cfg(root, log_path)
    cfg["data"]["img_size"] = tuple(cfg["data"]["img_size"])
    t = jtrainer.Trainer(cfg, run_id="cs")
    final = t.train()
    return {"root": root, "final": final, "tags": tags_by_step(log_path),
            "files": files_of(log_path), "log_path": log_path}


def _sidecar(log_path, name):
    with open(os.path.join(log_path, f"{name}.json")) as f:
        return json.load(f)


def test_port_run_trains_validates_and_saves_at_the_jax_steps(jax_run, tmp_path):
    log_path = tmp_path / "port"
    records = trainer.train_main(seg_cfg(jax_run["root"], log_path), device="cpu")
    # the JAX trainer: steps 1-4, validations after steps 1 and 3 and at the last
    assert jax_run["final"] == len(records) == 4
    validated = [i for i, r in enumerate(records, start=1) if "val/Mean IoU" in r]
    jax_validated = sorted(s - 1 for s, tags in jax_run["tags"].items()
                           if "val_metrics/Mean IoU :" in tags)
    assert validated == jax_validated == [1, 3, 4]
    # the loop's wait for each validation's save (one snapshot for best and last)
    assert all(r["val/save_seconds"] > 0 for r in records if "val/Mean IoU" in r)
    assert tags_by_step(log_path) == jax_run["tags"]
    # train_main writes cfg.yml and the log file beside the trainer's files
    assert files_of(log_path) == sorted(["cfg.yml", "run_*.log"] + [
        f.replace(".msgpack", ".pth") for f in jax_run["files"]])
    for name in ("best_model", "last_model"):
        assert _sidecar(log_path, name)["step"] <= 4
    assert _sidecar(log_path, "last_model")["step"] == _sidecar(jax_run["log_path"],
                                                                "last_model")["step"] == 4
    best = _sidecar(log_path, "best_model")
    ious = [r["val/Mean IoU"] for r in records if "val/Mean IoU" in r]
    # the loop's `>=`: the best file is the last validation that reached the maximum
    assert best["best_iou"] == max(ious)
    assert best["step"] == max(i for i, r in enumerate(records, start=1)
                               if r.get("val/Mean IoU") == max(ious))


def test_a_cut_and_auto_resumed_run_ends_like_the_uninterrupted_one(jax_run, tmp_path):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    trainer.train_main(seg_cfg(jax_run["root"], whole), device="cpu")
    first = trainer.train_main(seg_cfg(jax_run["root"], cut, train_iters=3), device="cpu")
    assert len(first) == 2 and _sidecar(cut, "last_model")["step"] == 2
    cfg = seg_cfg(jax_run["root"], cut)
    cfg["training"]["auto_resume"] = True
    rest = trainer.train_main(cfg, device="cpu")
    assert len(rest) == 2  # steps 3 and 4
    assert "val/Mean IoU" in rest[0] and "val/Mean IoU" in rest[1]
    assert _sidecar(cut, "last_model")["step"] == _sidecar(whole, "last_model")["step"] == 4
    # the resumed run writes into the same files (its log and events files
    # are second ones)
    assert set(files_of(cut)) == set(files_of(whole))
    steps = sorted({s for s in tags_by_step(cut)})
    assert steps == sorted(tags_by_step(whole))
    # resumed at its last iteration, a run has no step left
    assert trainer.train_main(cfg, device="cpu") == []


def _state(run):
    return {"model": run.model.state_dict(),
            "teacher": run.teacher.state_dict() if run.teacher is not None else None,
            "optimizer": run.optimizer.state_dict()}


def _assert_state_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_state_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("case", ["sgd", "adam_ema"])
def test_full_state_round_trip_is_bit_identical(case, tmp_path):
    if case == "sgd":
        cfg = _tiny_train_cfg(log_path=tmp_path)
    else:
        cfg = _tiny_train_cfg("exp212_pad_online_synthetic.yml", log_path=tmp_path)
        cfg["training"]["optimizer"] = {"name": "adam", "lr": 1e-3, "backbone_lr": 1e-4,
                                        "weight_decay": 1e-4}
        cfg["training"].update(save_separate_monodepth_models=True, save_monodepth_ema=True)
    cfg["training"].update(val_interval=2, val_batch_size=2, save_model=True,
                           async_checkpoints=True)
    cfg["data"]["n_samples"] = 4
    run = trainer.build_run(cfg, "cpu")
    records = trainer.train_main(cfg, "cpu", run=run)
    assert len(records) == 2 and _sidecar(tmp_path, "last_model")["step"] == 2
    if case == "adam_ema":
        assert run.teacher is not None and run.optimizer.mu
        # PAD holds no `depth` submodule: the pose network and the encoder go out
        assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".pth")) == [
            "best_model.pth", "encoder.pth", "last_model.pth", "pose.pth", "pose_encoder.pth"]
        for name in ("pose_encoder", "pose", "encoder"):
            exported = torch.load(tmp_path / f"{name}.pth", weights_only=True)
            params = dict(run.teacher.models[name].named_parameters())
            buffers = dict(run.model.models[name].named_buffers())
            assert exported.keys() == run.model.models[name].state_dict().keys()
            for k, v in exported.items():
                assert torch.equal(v, params[k] if k in params else buffers[k]), (name, k)
        assert any(not torch.equal(p, run.model.models["encoder"].state_dict()[k])
                   for k, p in run.teacher.models["encoder"].named_parameters())
    else:
        assert run.optimizer.momentum_buffers
    run.optimizer.lr_scale = 0.25
    run.best_iou = 0.375
    path, = run.save_resume("last_model")  # over the run's own, to keep the disk use down
    run.checkpoints.wait_for_saves()
    want = _state(run)
    cfg2 = dict(cfg, training=dict(cfg["training"], resume=path))
    fresh = trainer.build_run(cfg2, "cpu")
    assert fresh.start_iter == 2 and fresh.best_iou == 0.375
    assert fresh.optimizer.lr_scale == 0.25 and fresh.optimizer.step_count == 2
    _assert_state_equal(_state(fresh), want)
    for r in (run, fresh):
        r.close()


def test_an_async_writer_error_surfaces_at_wait_for_saves(tmp_path):
    model = build_model(SDE_CFG, 19)
    opt = types.SimpleNamespace(step_count=3, state_dict=lambda: {"step_count": 3})
    writer = checkpoints.ResumeWriter()
    os.makedirs(tmp_path / "best_model.pth.tmp")  # torch.save cannot write there
    writer.save_resume(str(tmp_path), model, None, opt, 0.5, async_write=True)
    assert writer.snapshot_seconds > 0
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.wait_for_saves()
    writer.wait_for_saves()  # raised once
    os.rmdir(tmp_path / "best_model.pth.tmp")
    paths = writer.save_resume(str(tmp_path), model, None, opt, 0.5,
                               basenames=("best_model", "last_model"))
    assert paths == [str(tmp_path / "best_model.pth"), str(tmp_path / "last_model.pth")]
    for name in ("best_model", "last_model"):
        assert _sidecar(tmp_path, name) == {"step": 3, "best_iou": 0.5}
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()  # one snapshot, both files


@pytest.mark.parametrize("kwargs", [dict(patience=2), dict(patience=1, min_delta=0.1),
                                    dict(patience=3, min_delta=0.05, cumulative_delta=True)])
def test_early_stopping_and_the_plateau_match_jax(kwargs):
    scores = [0.1, 0.12, 0.11, 0.2, 0.21, 0.215, 0.22, 0.18, 0.3, 0.29, 0.28, 0.27, 0.26,
              0.25, 0.24]
    want, got = JEarlyStopping(**kwargs), EarlyStopping(**kwargs)
    assert [got.step(s) for s in scores] == [want.step(s) for s in scores]
    assert (got.best_score, got.counter) == (want.best_score, want.counter)

    plateau = {"factor": 0.5, "patience": kwargs["patience"], "best": -np.inf, "count": 0}
    jax_self = types.SimpleNamespace(plateau=dict(plateau), logger=None)
    jax_self.state = types.SimpleNamespace(lr_scale=jax.numpy.asarray(1.0, jax.numpy.float32))
    jax_self.state.replace = lambda lr_scale: types.SimpleNamespace(
        lr_scale=lr_scale, replace=jax_self.state.replace)
    jax_self.logger = types.SimpleNamespace(info=lambda *a: None)
    port_self = types.SimpleNamespace(plateau=dict(plateau),
                                      optimizer=types.SimpleNamespace(lr_scale=1.0))
    for s in scores:
        jtrainer.Trainer._plateau_step(jax_self, s)
        trainer.Run.plateau_step(port_self, s)
        assert port_self.optimizer.lr_scale == float(jax_self.state.lr_scale)
        assert port_self.plateau == jax_self.plateau
    assert port_self.optimizer.lr_scale < 1.0


def test_a_jax_component_msgpack_loads_like_state_dict_from_jax(tmp_path):
    torch.manual_seed(0)
    trained = build_model(SDE_CFG, n_classes=19)
    params, stats = jax.tree_util.tree_map(
        np.array, convert_full_model(trained.state_dict(), SDE_CFG))
    name = "mono_jax_export"
    jckpt.save_monodepth_models(str(tmp_path / name), params, stats, include_encoder=True)
    assert sorted(os.listdir(tmp_path / name)) == [
        "depth.msgpack", "encoder.msgpack", "pose.msgpack", "pose_encoder.msgpack"]
    torch.manual_seed(1)
    port = build_model(SDE_CFG, n_classes=19)
    cfg = dict(SDE_CFG, backbone_pretraining=name, depth_pretraining=name,
               pose_pretraining=name)
    checkpoints.apply_pretraining(port, cfg, str(tmp_path))
    want = state_dict_from_jax(params, stats, SDE_CFG)
    got = port.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    assert all(torch.equal(got[k], v) for k, v in trained.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def test_synthetic_batches_come_from_the_jax_synthetic_dataset(tmp_path):
    """Fault: the port's trainer made `data/synthetic.py` bench batches; it
    now reads the SyntheticDataset through the loader, as the JAX trainer."""
    cfg = _tiny_train_cfg(log_path=tmp_path)
    cfg["data"]["n_samples"] = 4
    run = trainer.build_run(cfg, "cpu")
    got, _ = run.device_batches()
    ds = JSynthetic(n_samples=4, split="train", img_size=(32, 64), frame_idxs=(0, -1, 1),
                    num_scales=4)
    order = next(iter(JDataLoader(ds, 2, shuffle=True, num_workers=1)))["idx"]
    want = to_device_batch(collate([ds[int(i)] for i in order]), "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # fault: validation set best_iou; the loop compares first, then saves
    run.best_iou = 7.0
    val = run.validate(0)
    assert run.best_iou == 7.0 and "best_iou" not in val and 0 <= run.mIoU <= 1
    run.close()
    random.seed()
