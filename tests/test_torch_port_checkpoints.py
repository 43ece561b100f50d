"""The port's pretrained weights and SDE component export against the JAX
package's `apply_pretraining`, and the dec5 -> dec6 chain through
`train_main` on the CPU.

- The port's `.pth` export read by the JAX package's `apply_pretraining`
  gives the JAX trees of the same weights, exactly.
- A seeded torchvision-layout `imnet/resnet18.pth` read by both packages
  gives equal encoder, pose encoder (conv1 repeated over the two frames and
  halved) and ImageNet encoder, exactly.
- A missing `mono*` component raises FileNotFoundError, a missing ImageNet
  file prints the warning and keeps the initialization, a `.msgpack` file
  that is not a flax component tree raises ValueError (the JAX package's
  own exports load: tests/test_torch_port_trainer_io.py).
No jitted step: the conversions are numpy. Every `mono*` component that the
JAX package reads is written first (a missing one would make it try a
download).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from improving_segmentation_with_selfsupervised_depth_tpu.engine.checkpoints import (
    apply_pretraining as jax_apply_pretraining,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.full_model_interop import (
    convert_full_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import checkpoints, trainer
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    build_model as build_port_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.resnet import ResNetEncoder

from tests.test_torch_port_exp210 import few_torch_threads  # noqa: F401  (fixture)
from tests.test_torch_port_models import TINY_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "improving_segmentation_with_selfsupervised_depth_tpu_torch"
SDE_CFG = dict(TINY_CFG, segmentation_name=None, segmentation_args=None)
MONO = "mono_test_sde_components"


def torchvision_resnet(depth, seed):
    """A seeded state_dict in torchvision's ResNet layout (no `encoder.`
    prefix, with the `fc` head), running statistics away from 0 and 1."""
    gen = torch.Generator().manual_seed(seed)
    sd = ResNetEncoder(depth).encoder.state_dict()
    for k, v in sd.items():
        if v.is_floating_point():
            v.copy_(torch.rand(v.shape, generator=gen) * 0.1 + (0.5 if "var" in k else 0.0))
    width = 512 if depth < 50 else 2048
    sd["fc.weight"] = torch.randn((1000, width), generator=gen)
    sd["fc.bias"] = torch.randn((1000,), generator=gen)
    return sd


def _trees(model, cfg):
    """The JAX (params, batch_stats) of the port's weights, as copies: the
    converter's arrays share memory with the port's tensors."""
    return jax.tree_util.tree_map(np.array, convert_full_model(model.state_dict(), cfg))


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


def test_port_export_loads_in_jax_apply_pretraining(tmp_path):
    torch.manual_seed(0)
    trained = build_port_model(SDE_CFG, n_classes=19)
    checkpoints.save_monodepth_models(str(tmp_path / MONO), trained, include_encoder=True)
    assert sorted(os.listdir(tmp_path / MONO)) == [
        "depth.pth", "encoder.pth", "pose.pth", "pose_encoder.pth"]
    cfg = dict(SDE_CFG, backbone_pretraining=MONO, depth_pretraining=MONO, pose_pretraining=MONO)
    torch.manual_seed(1)
    fresh = build_port_model(SDE_CFG, n_classes=19)
    params, stats = jax_apply_pretraining(cfg, *_trees(fresh, SDE_CFG), str(tmp_path))
    want_params, want_stats = _trees(trained, SDE_CFG)
    for name in ("encoder", "depth", "pose_encoder", "pose"):
        _assert_trees_equal(params[name], want_params[name], name)
        if name in want_stats:
            _assert_trees_equal(stats[name], want_stats[name], name)
    # and the port reads its own export back
    checkpoints.apply_pretraining(fresh, cfg, str(tmp_path))
    for k, v in trained.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_torchvision_resnet18_loads_alike_in_both_packages(tmp_path):
    os.makedirs(tmp_path / "imnet")
    tv = torchvision_resnet(18, seed=3)
    torch.save(tv, tmp_path / "imnet" / "resnet18.pth")
    cfg = dict(SDE_CFG, backbone_pretraining="imnet", enable_imnet_encoder=True)
    torch.manual_seed(2)
    port = build_port_model(cfg, n_classes=19)
    params, stats = jax_apply_pretraining(cfg, *_trees(port, cfg), str(tmp_path))
    checkpoints.apply_pretraining(port, cfg, str(tmp_path))
    want_params, want_stats = _trees(port, cfg)
    for name in ("encoder", "pose_encoder", "imnet_encoder"):
        _assert_trees_equal(params[name], want_params[name], name)
        _assert_trees_equal(stats[name], want_stats[name], name)
    sd = port.state_dict()
    for name in ("encoder", "imnet_encoder"):
        assert torch.equal(sd[f"models.{name}.encoder.layer4.1.bn2.running_var"],
                           tv["layer4.1.bn2.running_var"])
        assert torch.equal(sd[f"models.{name}.encoder.conv1.weight"], tv["conv1.weight"])
    assert torch.equal(sd["models.pose_encoder.encoder.conv1.weight"],
                       torch.cat([tv["conv1.weight"]] * 2, dim=1) / 2)


def test_missing_and_unported_weights(tmp_path, capsys):
    torch.manual_seed(0)
    port = build_port_model(dict(SDE_CFG, enable_imnet_encoder=True), n_classes=19)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    # no imnet file: a warning, the initialization stays
    checkpoints.apply_pretraining(port, dict(SDE_CFG, enable_imnet_encoder=True),
                                  str(tmp_path))
    assert "WARNING: imnet weights for resnet18 not found" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())
    # a mono component that is not there
    with pytest.raises(FileNotFoundError, match="depth"):
        checkpoints.apply_pretraining(port, dict(SDE_CFG, depth_pretraining=MONO),
                                      str(tmp_path))
    # the JAX package's export format, read in place of the .pth; an empty
    # msgpack map is no component tree
    os.makedirs(tmp_path / MONO)
    (tmp_path / MONO / "depth.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="no params"):
        checkpoints.apply_pretraining(port, dict(SDE_CFG, depth_pretraining=MONO),
                                      str(tmp_path))


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        f"import {PKG}.engine.checkpoints, {PKG}.config.machine, {PKG}.engine.trainer\n"
        f"import {PKG}.cli.train_cli, {PKG}.cli.profile_cli, {PKG}.utils.misc\n"
        f"import {PKG}.engine.writer, {PKG}.engine.early_stopping\n"
        f"import {PKG}.data.prepare_cityscapes, {PKG}.data.synthetic_dataset\n"
        f"import {PKG}.label_selection, {PKG}.label_selection.driver\n"
        f"import {PKG}.label_selection.scoring, {PKG}.engine.depth_estimator\n"
        f"import {PKG}.data.preselected, {PKG}.ops.losses, {PKG}.engine.optim\n"
        f"from {PKG}.data import registry, loader, base, utils, cityscapes, camvid, mapillary\n"
        "registry.get_loader('cityscapes')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', "
        "'improving_segmentation_with_selfsupervised_depth_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _tiny(name):
    with open(os.path.join(ROOT, PKG, "configs", name)) as fp:
        cfg = yaml.safe_load(fp)
    cfg["model"].update(backbone_name="resnet18",
                        depth_args={"intermediate_aspp": True, "aspp_rates": [1, 2]})
    # validation runs at the uncropped size, as in the JAX trainer
    cfg["monodepth_options"].update(height=32, width=64, crop_h=32, crop_w=64)
    cfg["training"].update(batch_size=2, val_batch_size=2)
    # three batches an epoch: each of the 3 steps sees other frames
    cfg["data"]["n_samples"] = 6
    return cfg


def test_dec5_then_dec6_through_train_main_shrunk(tmp_path, monkeypatch):
    """The packaged SDE configs at resnet18 and 32x64 on the CPU: dec5 with
    its frozen ImageNet backbone and the dec5 pose source, its export, then
    dec6 (amp, feature distance) from that export."""
    models = tmp_path / "models"
    monkeypatch.setenv("SDT_MODEL_DIR", str(models))
    monkeypatch.setenv("SDT_OUT_DIR", str(tmp_path))
    os.makedirs(models / "imnet")
    torch.save(torchvision_resnet(18, seed=4), models / "imnet" / "resnet18.pth")
    pose_src = models / "mono_cityscapes_1024x512_r101dil_aspp_dec5"
    torch.manual_seed(5)
    src = build_port_model(SDE_CFG, n_classes=19)
    checkpoints.save_component(str(pose_src), src, "pose_encoder")
    checkpoints.save_component(str(pose_src), src, "pose")

    cfg5 = _tiny("sde_dec5_crop_synthetic.yml")
    run5 = trainer.build_run(cfg5, "cpu")
    enc = {k: v.clone() for k, v in run5.model.models["encoder"].state_dict().items()}
    assert torch.equal(run5.model.models["pose"].state_dict()["net.3.weight"],
                       src.state_dict()["models.pose.net.3.weight"])
    records = trainer.train_main(cfg5, "cpu", run=run5)
    assert len(records) == 3 and all(np.isfinite(v) for r in records for v in r.values())
    # val_interval 2: validated after steps 1 and 3, as the JAX trainer
    assert "val/depth/abs_rel" in records[0] and "val/Mean IoU" not in records[0]
    params = dict(run5.model.models["encoder"].named_parameters())
    for k, v in run5.model.models["encoder"].state_dict().items():
        if k in params:  # frozen
            assert torch.equal(v, enc[k]), k
        elif k.endswith("running_mean"):  # train-mode BatchNorm all the same
            assert not torch.equal(v, enc[k]), k
    out = cfg5["training"]["log_path"]
    assert out == str(models / "mono_cityscapes_1024x512_r101dil_aspp_dec5_posepretrain_crop512x512bs4")
    assert sorted(f for f in os.listdir(out) if f.endswith(".pth")) == [
        "depth.pth", "pose.pth", "pose_encoder.pth"]
    checkpoints.save_component(out, run5.model, "encoder")

    cfg6 = _tiny("sde_dec6_crop_synthetic.yml")
    run6 = trainer.build_run(cfg6, "cpu")
    assert run6.model.amp and run6.step_cfg.photometric_dtype == torch.bfloat16
    for name in ("encoder", "depth", "pose_encoder", "pose"):
        for k, v in run6.model.models[name].state_dict().items():
            assert torch.equal(v, run5.model.models[name].state_dict()[k]), (name, k)
    records = trainer.train_main(cfg6, "cpu", run=run6)
    feat = [r["feat_dist_loss"] for r in records]
    assert all(np.isfinite(f) and f > 0 for f in feat) and len(set(feat)) == 3
