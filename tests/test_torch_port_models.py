"""The port's models against the JAX package's, on the same weights.

JAX `model.init` makes the weights; `state_dict_from_jax` loads them into the
port; both run the same batch from `make_synthetic_batch` (NHWC for JAX, NCHW
for the port). Dropout is off on both sides (Flax dropout intercepted to the
identity, torch dropout p = 0), because the two frameworks draw different
masks.

Tolerance 1e-4: both sides run f32 on the CPU, so outputs differ by op-order
rounding accumulated through ~40 layers (~1e-6 relative). Two conditioning
steps keep the outputs O(10), as a trained model's are, so that this rounding
stays below the tolerance: the running statistics are set from the batch's
own statistics, and the decoder kernels are halved (a fresh fan-out init without
BatchNorm grows the decoder's activations about twofold per conv). Batch 4:
the ASPP pooled branch's BatchNorm normalizes over N values, and at N = 2
some channels have a batch variance far below eps, where the JAX package's
one-pass f32 variance E[x^2] - E[x]^2 is off by up to 1% and moves the
running statistics by ~4e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from flax import linen as fnn

from improving_segmentation_with_selfsupervised_depth_tpu.data.synthetic import (
    make_synthetic_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.full_model_interop import (
    convert_full_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.torch_interop import (
    convert_resnet_encoder,
)
from improving_segmentation_with_selfsupervised_depth_tpu.models import (
    ResNetEncoder as JaxResNetEncoder,
)
from improving_segmentation_with_selfsupervised_depth_tpu.models import build_model
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic import (
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.interop import (
    state_dict_from_jax,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    build_model as build_port_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.resnet import (
    ResNetEncoder,
)

ATOL = 1e-4

# the tiny flagship (__graft_entry__.py:35-39) with head dropout off
TINY_CFG = {
    "backbone_name": "resnet18",
    "replace_stride_with_dilation": [False, False, True],
    "segmentation_name": "joint_seg_depth_dec",
    "segmentation_args": {"layers": [9], "head_dropout": 0.0},
    "depth_args": {"intermediate_aspp": True, "aspp_rates": [1, 2]},
    "frame_ids": [0, -1, 1],
    "num_scales": 4,
}


def no_flax_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def jax_tiny_model(seed=0, h=64, w=128, bs=4):
    """(JAX model, its freshly initialised variables as numpy, numpy batch)."""
    model = build_model(TINY_CFG, n_classes=19)
    batch = make_synthetic_batch(bs, h, w, frame_ids=(0, -1, 1), num_scales=4, seed=seed)
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(model.init)({"params": key, "dropout": key},
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    return model, jax.tree_util.tree_map(np.asarray, variables), batch


def calibrate_running_stats(module, inputs):
    """Running stats := the batch's mean and its variance + 0.5, from one
    train-mode pass with momentum 1. The + 0.5 keeps eval mode from scaling a
    near-constant channel up by up to 1/sqrt(eps), which would amplify
    rounding as much."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    module.train()
    with torch.no_grad():
        module(inputs)
    for m in bns:
        m.momentum = 0.1
        m.running_var.add_(0.5)
        m.num_batches_tracked.zero_()


def shared_weights(variables, batch):
    """The port on the JAX weights, conditioned as the module docstring says.

    Returns (JAX variables, port model) holding identical weights and stats.
    """
    def halve_decoders(path, v):
        keys = [p.key for p in path]
        in_decoder = keys[0] == "depth" or keys[:2] == ["segmentation", "unet_dec"]
        return v * np.float32(0.5) if in_decoder and keys[-1] == "kernel" else v

    params = jax.tree_util.tree_map_with_path(halve_decoders, variables["params"])
    port = build_port_model(TINY_CFG, n_classes=19)
    port.load_state_dict(state_dict_from_jax(params, variables["batch_stats"], TINY_CFG))
    for m in port.modules():
        if isinstance(m, (nn.Dropout, nn.Dropout2d)):
            m.p = 0.0
    calibrate_running_stats(port, to_device_batch(batch, "cpu"))
    # copies: the converter's arrays share memory with the port's buffers
    _, stats = jax.tree_util.tree_map(np.array, convert_full_model(port.state_dict(), TINY_CFG))
    return {"params": params, "batch_stats": stats}, port


@pytest.fixture(scope="module")
def tiny():
    return jax_tiny_model()


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_joint_model_outputs_match_jax(tiny, train):
    model, variables, batch = tiny
    variables, port = shared_weights(variables, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with fnn.intercept_methods(no_flax_dropout):
        apply = jax.jit(lambda v, b: model.apply(v, b, train=train, mutable=["batch_stats"]))
        ref, mutated = apply(variables, jb)
    port.train(train)
    with torch.no_grad():
        got = port(to_device_batch(batch, "cpu"))

    keys = [k for k in ref if k.startswith(("disp_", "axisangle_", "translation_"))]
    keys.append("semantics")
    assert len(keys) == 4 + 2 + 2 + 1
    for k in keys:
        g = _nhwc(got[k]) if k.startswith(("disp_", "semantics")) else got[k].numpy()
        np.testing.assert_allclose(g, np.asarray(ref[k]), atol=ATOL, err_msg=k)
    if train:  # the running statistics moved the same way
        sd = state_dict_from_jax(variables["params"], jax.tree_util.tree_map(
            np.asarray, mutated["batch_stats"]), TINY_CFG)
        for k, v in port.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=1e-5, err_msg=k)


def test_state_dict_round_trip_is_exact(tiny):
    _, variables, _ = tiny
    params, stats = convert_full_model(
        state_dict_from_jax(variables["params"], variables["batch_stats"], TINY_CFG), TINY_CFG)
    flat_ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        {"params": params, "batch_stats": stats})[0])
    assert len(flat_got) == len(flat_ref)
    for path, ref in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), ref, err_msg=str(path))
    # the port's modules hold exactly the keys that came from the JAX trees
    port = build_port_model(TINY_CFG, n_classes=19)
    assert set(port.state_dict()) == set(state_dict_from_jax(
        variables["params"], variables["batch_stats"], TINY_CFG))


def test_resnet101_dilated_encoder_matches_jax():
    enc = JaxResNetEncoder(depth=101, replace_stride_with_dilation=(False, False, True))
    x = np.random.default_rng(4).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(enc.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = ResNetEncoder(101, replace_stride_with_dilation=(False, False, True))
    sd = state_dict_from_jax({"encoder": variables["params"]},
                             {"encoder": variables["batch_stats"]}, {})
    port.load_state_dict({k[len("models.encoder."):]: v for k, v in sd.items()})
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    calibrate_running_stats(port, xt)
    _, stats = jax.tree_util.tree_map(np.array, convert_resnet_encoder(port.state_dict(), 101))
    ref = jax.jit(lambda v, x: enc.apply(v, x, train=False))(
        {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
    port.eval()
    with torch.no_grad():
        got = port(xt)
    assert [tuple(f.shape[1:]) for f in got] == [
        (64, 32, 32), (256, 16, 16), (512, 8, 8), (1024, 4, 4), (2048, 4, 4)]
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=ATOL, err_msg=f"f{i}")
