"""One supervised SDE train step in the port against the JAX package's.

Both start from the same weights (tests/test_torch_port_models.py: JAX init,
conditioned, loaded into the port) and take one step of the `sde` step
configuration on the same batch: CE + min-reprojection photometric loss with
automasking and smoothness, SGD with momentum, a backbone lr group and grad
clip 10. JAX runs its CPU path (the XLA f32 warp; the identity losses take
the XLA SSIM chain there); the port runs the plain versions of K1 and K2.
The tie-break noise is derived from the JAX key exactly as the JAX step
derives it and injected into the port.

Tolerances: losses rtol 1e-4 and parameters / running statistics after the
step atol 1e-5, both f32 on the CPU (see the models test for why batch 4).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from improving_segmentation_with_selfsupervised_depth_tpu.engine.optim import (
    build_optimizer as jax_build_optimizer,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.state import TrainState
from improving_segmentation_with_selfsupervised_depth_tpu.engine.train_steps import (
    StepConfig as JaxStepConfig,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.train_steps import (
    make_train_step,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic import (
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.interop import (
    state_dict_from_jax,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.optim import (
    build_optimizer,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.train_steps import (
    StepConfig,
    train_step,
)

from tests.test_torch_port_kernels import xla_warp  # noqa: F401  (fixture)
from tests.test_torch_port_models import (
    TINY_CFG,
    jax_tiny_model,
    no_flax_dropout,
    shared_weights,
)

# bench.py:220-224 (_TRAINING_CFG)
TRAINING_CFG = {
    "optimizer": {"name": "sgd", "lr": 1e-2, "momentum": 0.9, "backbone_lr": 1e-3},
    "lr_schedule": {"name": "multi_step", "milestones": [10**6], "gamma": 0.1},
    "clip_grad_norm": 10.0,
}
STEP_FIELDS = dict(monodepth_lambda=1.0, segmentation_lambda=1.0, frame_ids=(0, -1, 1),
                   scales=(0, 1, 2, 3), photometric_dtype=None)


def test_train_step_matches_jax(xla_warp):
    model, variables, batch = jax_tiny_model()
    variables, port = shared_weights(variables, batch)
    n, h, w = batch["lbl"].shape

    tx = jax_build_optimizer(TRAINING_CFG, TINY_CFG, variables["params"])
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    rng = jax.random.PRNGKey(0)
    with fnn.intercept_methods(no_flax_dropout):
        step = jax.jit(make_train_step(model, JaxStepConfig(**STEP_FIELDS), tx))
        new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                  None, rng)
    # the JAX step's tie-break draw: fold_in(rng, step) -> split 8 -> k_mono
    # (train_steps.py:234-235) -> split (photometric.py:200-202)
    k_mono = jax.random.split(jax.random.fold_in(rng, 0), 8)[1]
    _, sub = jax.random.split(k_mono)
    noise = np.asarray(jax.random.normal(sub, (n, h, w, 2))).transpose(0, 3, 1, 2)

    opt = build_optimizer(TRAINING_CFG, TINY_CFG, port)
    got = train_step(port, opt, to_device_batch(batch, "cpu"), StepConfig(**STEP_FIELDS),
                     tie_break_noise=torch.from_numpy(noise.copy()))

    for k in ("total_loss", "segmentation_loss", "mono_loss"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4, err_msg=k)
    assert float(metrics["mono_loss"]) > 0
    ref_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_state.params),
                                 jax.tree_util.tree_map(np.asarray, new_state.batch_stats),
                                 TINY_CFG)
    moved = 0
    init_sd = state_dict_from_jax(variables["params"], variables["batch_stats"], TINY_CFG)
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=1e-5, err_msg=k)
        moved += int(not torch.equal(ref_sd[k], init_sd[k]))
    assert moved > 100  # the step did move the weights and statistics


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX unimported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import improving_segmentation_with_selfsupervised_depth_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', "
        "'improving_segmentation_with_selfsupervised_depth_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _tiny_train_cfg(name="sde_supervised_synthetic.yml", log_path=None):
    """A packaged config at resnet18, 32x64, batch 2 and 2 steps
    (`train_iters` 3: the loop runs train_iters - 1 steps, as the JAX
    trainer's), writing into `log_path`."""
    import yaml

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "improving_segmentation_with_selfsupervised_depth_tpu_torch",
                        "configs", name)
    with open(path) as fp:
        cfg = yaml.safe_load(fp)
    cfg["model"].update(backbone_name="resnet18",
                        depth_args={"intermediate_aspp": True, "aspp_rates": [1, 2]})
    cfg["monodepth_options"].update(height=32, width=64)
    cfg["training"].update(batch_size=2, train_iters=3)
    if log_path is not None:
        cfg["training"]["log_path"] = str(log_path)
    return cfg


def test_train_cli_runs_the_packaged_config_shrunk(tmp_path, caplog):
    import logging

    import yaml

    from improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.train_cli import main

    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(_tiny_train_cfg(log_path=tmp_path / "run")))
    with caplog.at_level(logging.INFO, logger="segsde_torch"):
        main(["--config", str(path), "--device", "cpu"])
    iters = [r.getMessage() for r in caplog.records if r.getMessage().startswith("Iter [")]
    # the JAX trainer's numbering: its first step logs as iteration 2
    assert len(iters) == 2 and iters[-1].startswith("Iter [3/3]")


def test_train_main_runs_the_exp212_config_shrunk(tmp_path):
    """The packaged exp-212 config (PAD, EMA teacher, online DepthMix, fused
    K2/K3 error) through train_main on the CPU, shrunk: the plain versions run
    and no kernel is launched."""
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.trainer import (
        train_main,
    )
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import reprojection

    cfg = _tiny_train_cfg("exp212_pad_online_synthetic.yml", log_path=tmp_path)
    assert cfg["training"]["fused_reprojection"] and cfg["model"]["segmentation_name"] == "mtl_pad"
    launches = reprojection.reprojection_error_grad.launches
    records = train_main(cfg, device="cpu")
    assert len(records) == 2 and reprojection.reprojection_error_grad.launches == launches
    for r in records:
        assert all(np.isfinite(v) for v in r.values()) and r["unlabeled_loss"] > 0
    assert records[0]["total_loss"] != records[1]["total_loss"]


@pytest.mark.parametrize("section,key,value", [
    ("model", "remat", True),
    ("model", "depth_args", {"intermediate_aspp": True, "aspp_rates": [1, 2], "dropout": 0.1}),
    ("model", "pose_model_input", "all"),
    ("training", "fuse_unlabeled_forward", True),
    ("training", "unlabeled_segmentation", {"mix_mask": "depthcomp", "debug_images": True}),
    ("model", "depth_args", {"intermediate_aspp": True, "aspp_rates": [1, 2],
                             "use_skips": False}),
    ("data", "dataset", "inference"),
])
def test_what_the_slice_does_not_run_raises(section, key, value, tmp_path):
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.trainer import (
        train_main,
    )

    cfg = _tiny_train_cfg(log_path=tmp_path)
    cfg[section][key] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_main(cfg, device="cpu")

