"""The port's inference and export against the JAX package's.

One JAX `model.init` of the resnet18 `joint_seg_depth_dec` model (the
tiny flagship of tests/test_torch_port_models.py) at 64x96, its decoder
kernels halved and running statistics set from a batch (as
`shared_weights` conditions them: outputs stay O(10)), is saved with JAX
`save_resume` into a run directory with `cfg.yml`, as tests/test_export.py
builds one. Then:
- JAX `Inference` and the port's `Inference` (through each package's
  `inference_cli.main`) run over 4 seeded PNGs: the image PNGs are equal
  byte for byte, `_depth.png` within 1 grey level, `_label.png` equal except
  at pixels whose top-two JAX logits lie within 1e-4;
- the port's `torch.export` artifact of the same weights, at a fixed batch
  and with a symbolic batch, matches the port's eager forward within 1e-5
  and JAX's forward (the JAX `Inference`'s own jitted program) within
  `ATOL` 1e-4; the symbolic batch serves n = 1, 2 and 3;
- the port's own run directory (`best_model.pth` from a one-step
  `train_main` on the CPU) through `inference_cli.main` and `export_cli.main`.

The file compiles two JAX programs: the jitted `model.init` (~11 s; op by
op it takes ~41 s) and the JAX `Inference`'s forward. torch runs on two
threads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from PIL import Image

from improving_segmentation_with_selfsupervised_depth_tpu.cli import inference_cli as jax_cli
from improving_segmentation_with_selfsupervised_depth_tpu.config import MachineConfig
from improving_segmentation_with_selfsupervised_depth_tpu.engine.checkpoints import (
    save_resume,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.state import TrainState
from improving_segmentation_with_selfsupervised_depth_tpu_torch.cli import (
    export_cli,
    inference_cli,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.export import (
    export_inference,
    load_exported,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.trainer import (
    train_main,
)

from tests.test_torch_port_models import ATOL, TINY_CFG, jax_tiny_model, shared_weights

H, W = 64, 96
N_IMAGES = 4
EXPORT_ATOL = 1e-5  # the artifact against the eager forward: the same torch ops


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for the port's CPU ops: the test processes share
    the machine's cores, and more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def machine_config_restored():
    """JAX's `MachineConfig` keeps its paths in class attributes."""
    saved = {k: v for k, v in vars(MachineConfig).items() if k.isupper()}
    yield
    for k, v in saved.items():
        setattr(MachineConfig, k, v)


def _write_images(root):
    rng = np.random.default_rng(5)
    for i in range(N_IMAGES):
        sub = root / f"seq{i % 2}"
        sub.mkdir(parents=True, exist_ok=True)
        base = rng.uniform(0, 255, (8, 12, 3)).astype(np.uint8)
        img = Image.fromarray(base).resize((W, H), Image.BICUBIC)
        img.save(sub / f"frame_{i:03d}.png")


def _outputs(logdir):
    """{relative stem: (image PNG bytes, depth array, label array)}."""
    out = {}
    for root, _, files in os.walk(logdir):
        for f in files:
            if f.endswith(".png") and not f.endswith(("_depth.png", "_label.png")):
                stem = os.path.join(root, f[:-4])
                with open(stem + ".png", "rb") as fp:
                    img = fp.read()
                out[os.path.relpath(stem, logdir)] = (
                    img, np.asarray(Image.open(stem + "_depth.png"), np.int16),
                    np.asarray(Image.open(stem + "_label.png"), np.int16))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory, machine_config_restored):
    """The JAX run directory, the images, both packages' inference outputs
    and the JAX `Inference` (its jitted forward and loader)."""
    tmp = tmp_path_factory.mktemp("serving")
    model, variables, batch = jax_tiny_model(seed=3, h=H, w=W, bs=4)
    variables, _ = shared_weights(variables, batch)
    run_dir = tmp / "jax_run"
    cfg = {"model": dict(TINY_CFG), "seed": 42, "machine": "ws",
           "monodepth_options": {"frame_ids": [0, -1, 1], "num_scales": 4,
                                 "height": H, "width": W},
           "data": {"dataset": "cityscapes", "n_classes": 19, "img_size": [H, W],
                    "n_workers": 1, "dataset_seed": "same"},
           "training": {"val_batch_size": 2, "segmentation_lambda": 1.0,
                        "monodepth_loss": {"test_min_depth": 1e-3, "test_max_depth": 80}}}
    run_dir.mkdir()
    with open(run_dir / "cfg.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=optax.identity().init(
                           variables["params"]))
    save_resume(str(run_dir), state, 0.0)
    _write_images(tmp / "images")

    # the JAX Inference's template state: shapes only, no second model.init
    # (its `load_resume` fills it from the file)
    def template_state(model_, rng, example, tx):
        shapes = jax.eval_shape(lambda: model_.init({"params": rng, "dropout": rng}, example))
        zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        return TrainState(step=jnp.asarray(0, jnp.int32), params=zeros["params"],
                          batch_stats=zeros.get("batch_stats", {}),
                          opt_state=tx.init(zeros["params"]))

    captured = []

    class CapturingInference(jax_cli.Inference):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            captured.append(self)

    logdirs = {}
    saved = (jax_cli.create_train_state, jax_cli.Inference)
    jax_cli.create_train_state, jax_cli.Inference = template_state, CapturingInference
    try:
        for side, cli in (("jax", jax_cli), ("port", inference_cli)):
            os.environ["SDT_LOG_DIR"] = str(tmp / f"logs_{side}")
            argv = ["--model", str(run_dir), "--data", str(tmp / "images")]
            cli.main(argv + (["--device", "cpu"] if side == "port" else []))
            (name,) = os.listdir(tmp / f"logs_{side}")
            logdirs[side] = tmp / f"logs_{side}" / name
    finally:
        jax_cli.create_train_state, jax_cli.Inference = saved
        os.environ.pop("SDT_LOG_DIR", None)
    return run_dir, tmp / "images", logdirs, captured[0]


def _jax_forward_on_the_images(jax_inference):
    """The JAX Inference's jitted forward on its own batches: images (N, H,
    W, 3), logits (N, H, W, C) and disparities (N, H, W, 1), numpy."""
    imgs, logits, disps = [], [], []
    for batch in jax_inference.val_loader:
        b = {k: jnp.asarray(np.asarray(v)) for k, v in batch.items() if k != "filename"}
        out = jax_inference._forward(b)
        imgs.append(np.asarray(b["color_aug_0_0"]))
        logits.append(np.asarray(out["semantics"], np.float32))
        disps.append(np.asarray(out["disp_0"], np.float32))
    return np.concatenate(imgs), np.concatenate(logits), np.concatenate(disps)


def test_inference_writes_the_jax_pngs(served):
    _, _, logdirs, jax_inference = served
    got, want = _outputs(logdirs["port"]), _outputs(logdirs["jax"])
    assert sorted(got) == sorted(want) and len(got) == N_IMAGES
    assert sorted(got)[0] == os.path.join("images", "seq0", "frame_000")
    _, logits, _ = _jax_forward_on_the_images(jax_inference)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 1e-4
    for i, stem in enumerate(sorted(got)):
        img, depth, label = got[stem]
        jimg, jdepth, jlabel = want[stem]
        assert img == jimg, stem
        assert depth.shape == jdepth.shape == (H, W)
        assert np.abs(depth - jdepth).max() <= 1, stem
        differs = np.any(label != jlabel, axis=-1)
        assert not np.any(differs & ~near_tie[i]), stem
    assert len({d.tobytes() for _, d, _ in got.values()}) == N_IMAGES  # not constant


@pytest.mark.parametrize("batch", ["fixed", "symbolic"])
def test_export_matches_the_eager_forward_and_jax(served, batch):
    run_dir, _, _, jax_inference = served
    model, _ = export_cli.load_run_model(str(run_dir), "cpu")
    serve = load_exported(export_inference(model, H, W,
                                           batch_size=2 if batch == "fixed" else None))
    imgs, logits, disps = _jax_forward_on_the_images(jax_inference)
    x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy())
    sizes = [(0, 2), (2, 4)] if batch == "fixed" else [(0, 1), (1, 4), (0, 2)]
    for lo, hi in sizes:
        out = serve(x[lo:hi])
        assert set(out) == {"semantics", "disp_0"}
        with torch.no_grad():
            eager = model({"color_aug_0_0": x[lo:hi]}, use_pose=False)
        for k, ref in (("semantics", logits), ("disp_0", disps)):
            assert out[k].shape == (hi - lo, ref.shape[-1], H, W)
            np.testing.assert_allclose(out[k].numpy(), eager[k].numpy(), atol=EXPORT_ATOL,
                                       rtol=0, err_msg=k)
            np.testing.assert_allclose(out[k].numpy().transpose(0, 2, 3, 1), ref[lo:hi],
                                       atol=ATOL, rtol=0, err_msg=k)


def test_inference_and_export_of_a_port_run_dir(tmp_path, monkeypatch):
    """A one-step `train_main` on the CPU writes `best_model.pth`; the
    inference CLI's label PNGs are the argmax of the export CLI's artifact
    on the same images and its depth PNGs within 1 grey level of the
    artifact's disparity."""
    monkeypatch.setenv("SDT_OUT_DIR", str(tmp_path / "out"))
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "improving_segmentation_with_selfsupervised_depth_tpu_torch",
                        "configs", "sde_supervised_synthetic.yml")
    with open(path) as fp:
        cfg = yaml.safe_load(fp)
    cfg["model"].update(backbone_name="resnet18",
                        depth_args={"intermediate_aspp": True, "aspp_rates": [1, 2]})
    cfg["monodepth_options"].update(height=H, width=W, crop_h=H, crop_w=H)
    cfg["data"]["n_samples"] = 4
    cfg["training"].update(batch_size=2, train_iters=2, val_interval=1, save_model=True,
                           log_path=str(tmp_path / "run"))
    records = train_main(cfg, device="cpu")
    assert len(records) == 1 and os.path.isfile(tmp_path / "run" / "best_model.pth")
    _write_images(tmp_path / "images")
    inference = inference_cli.main(["--model", str(tmp_path / "run"), "--data",
                                    str(tmp_path / "images"), "--device", "cpu"])
    assert sorted(inference.seconds) == ["forward", "to_host", "write"]
    out = tmp_path / "model.pt2"
    export_cli.main(["--model", str(tmp_path / "run"), "--out", str(out), "--height", str(H),
                     "--width", str(W), "--batch", "0", "--device", "cpu"])
    serve = load_exported(str(out))
    written = _outputs(inference.logdir)
    assert len(written) == N_IMAGES
    for stem, (_, depth, label) in written.items():
        img = np.asarray(Image.open(os.path.join(inference.logdir, stem + ".png")), np.float32)
        res = serve(torch.from_numpy(img.transpose(2, 0, 1)[None] / 255.0))
        pred = res["semantics"][0].argmax(0).numpy()
        colors = inference.val_dataset.decode_segmap_tocolor(pred)
        assert np.array_equal(label, (colors * 255).astype(np.uint8))
        disp = np.clip(res["disp_0"][0, 0].numpy(), 0, 1) * 255
        assert np.abs(depth - disp.astype(np.uint8)).max() <= 1
    with pytest.raises(NotImplementedError, match=r"spatial_shards 2 .*multi-GPU"):
        inference_cli.main(["--model", str(tmp_path / "run"), "--data",
                            str(tmp_path / "images"), "--device", "cpu",
                            "--spatial-shards", "2"])
