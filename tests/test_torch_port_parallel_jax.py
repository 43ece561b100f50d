"""The port's s212 step at world size 2 (two gloo ranks on the CPU,
`parallel/launch.py`) against the JAX package's `jit_train_step` on a
2-device CPU data mesh (`jax.devices()[:2]`), from the same weights (JAX
init, conditioned as in tests/test_torch_port_step212.py, carried across by
`engine/interop.py::state_dict_from_jax`) and the same draws (derived from
the JAX step's key and injected global-shaped), dropout off on both sides.
Tolerances of tests/test_torch_port_step212.py: losses rtol 1e-4;
parameters, running statistics and EMA parameters atol 1e-5; both ranks'
states equal. Apart from tests/test_torch_port_parallel.py so that the two
run on two workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from improving_segmentation_with_selfsupervised_depth_tpu.data.synthetic import (
    make_synthetic_batch,
)
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
from improving_segmentation_with_selfsupervised_depth_tpu.ops import resample as jax_resample
from improving_segmentation_with_selfsupervised_depth_tpu.parallel import (
    data_mesh,
    jit_train_step,
    replicate,
    shard_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.interop import (
    state_dict_from_jax,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.parallel import compare
from improving_segmentation_with_selfsupervised_depth_tpu_torch.parallel.launch import launch

from tests.test_torch_port_models import no_flax_dropout
from tests.test_torch_port_semi import PAD_CFG, pad, pad_shared_weights  # noqa: F401
from tests.test_torch_port_step212 import (
    METRICS,
    S212,
    TRAINING_212,
    _jax_draws,
    pad_shared_weights_port,
)

WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_mesh_step(pad):
    """The JAX s212 step on a 2-device data mesh from the conditioned PAD
    weights (as tests/test_torch_port_step212.py::jax_step, jitted over the
    mesh): (variables, batches, draws, metrics, new state)."""
    model, variables, batch = pad
    variables, _ = pad_shared_weights(variables, batch, gate_scale=0.5)
    ubatch = make_synthetic_batch(4, 64, 128, frame_ids=(0, -1, 1), num_scales=4, seed=7,
                                  with_unlabeled_extras=True)
    n, h, w = batch["lbl"].shape
    rng = next(k for k in map(jax.random.PRNGKey, range(50))
               if _jax_draws(k, 1, 1, 1)[1].jitter_apply > 0.2
               and _jax_draws(k, 1, 1, 1)[1].blur_apply > 0.5)
    tx = jax_build_optimizer(TRAINING_212, PAD_CFG, variables["params"])
    mesh = data_mesh(jax.devices()[:WORLD])
    state = replicate(TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 opt_state=tx.init(variables["params"]),
                                 ema_params=jax.tree_util.tree_map(jnp.array,
                                                                   variables["params"])), mesh)
    saved = dict(jax_resample._WARP_CONFIG)
    jax_resample.configure_warp("xla")
    try:
        with fnn.intercept_methods(no_flax_dropout):
            step = jit_train_step(make_train_step(model, JaxStepConfig(**S212), tx), mesh)
            new_state, metrics = step(state, shard_batch(batch, mesh), shard_batch(ubatch, mesh),
                                      rng)
    finally:
        jax_resample._WARP_CONFIG.update(saved)
    new_state = jax.tree_util.tree_map(np.asarray, new_state)
    return (variables, batch, ubatch, _jax_draws(rng, n, h, w),
            {k: float(metrics[k]) for k in METRICS}, new_state)


def test_s212_step_at_world_2_matches_jax_on_a_2_device_mesh(jax_mesh_step, tmp_path):
    variables, batch, ubatch, (noise, draws), ref, new_state = jax_mesh_step
    port = pad_shared_weights_port(variables)
    torch.save(port.state_dict(), tmp_path / "pad.pth")
    spec = {"model_cfg": PAD_CFG, "training": TRAINING_212,
            "step": dict(S212, fused_pred_loss=True), "seed": 0,
            "state": str(tmp_path / "pad.pth"), "dropout": False,
            "batches": [(batch, ubatch)], "noises": [noise],
            "draws": [dataclasses.asdict(draws)]}
    ranks = launch(compare.run_steps, (spec,), world=WORLD, devices=["cpu"] * WORLD, threads=2)
    got = ranks[0]
    for k in METRICS:
        np.testing.assert_allclose(got["losses"][0][k], ref[k], rtol=1e-4, err_msg=k)
    want = state_dict_from_jax(new_state.params, new_state.batch_stats, PAD_CFG)
    for k, v in got["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
        assert torch.equal(ranks[1]["state"][k], v), k
    want_ema = state_dict_from_jax(new_state.ema_params, new_state.batch_stats, PAD_CFG)
    for k, v in got["teacher"].items():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(), atol=1e-5, err_msg=k)
