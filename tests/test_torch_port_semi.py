"""The semi-supervised modules of the port against the JAX package's.

Strong augmentation (color jitter, Gaussian blur) with the JAX draws passed
in, mixing and the depthcomp, class and depth-histogram masks (exact), the
EMA update, the PAD decoder's
outputs and state_dict round trip, and the PAD optimizer groups. Inputs come
from numpy seeds; dropout is off on both sides.

Tolerances: augmentation atol 1e-6 (f32 on [0, 1] values, op-order rounding
only); EMA atol 1e-7; PAD outputs atol 1e-4, as for the other models
(tests/test_torch_port_models.py explains the conditioning).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from improving_segmentation_with_selfsupervised_depth_tpu.data.synthetic import (
    make_synthetic_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine import state as jstate
from improving_segmentation_with_selfsupervised_depth_tpu.engine.full_model_interop import (
    convert_full_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.optim import (
    build_param_labels,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.train_steps import (
    StepConfig as JaxStepConfig,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.train_steps import (
    generate_mix_mask as jax_generate_mix_mask,
)
from improving_segmentation_with_selfsupervised_depth_tpu.models import build_model
from improving_segmentation_with_selfsupervised_depth_tpu.ops import image as jimage
from improving_segmentation_with_selfsupervised_depth_tpu.ops import mixing as jmixing
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic import (
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import state
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.interop import (
    state_dict_from_jax,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.optim import (
    build_optimizer,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.train_steps import (
    StepConfig,
    StepDraws,
    generate_mix_mask,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    build_model as build_port_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.layers import (
    SelfAttention,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import image, mixing

from tests.test_torch_port_models import calibrate_running_stats, no_flax_dropout

# the exp-212 model (bench.py:190-208, pad=True) cut to resnet18 and ASPP
# rates [1, 2]
PAD_CFG = {
    "backbone_name": "resnet18",
    "replace_stride_with_dilation": [False, False, True],
    "segmentation_name": "mtl_pad",
    "segmentation_args": {"final_layer": 9, "distillation_layer": 7, "side_output": True},
    "depth_args": {"intermediate_aspp": True, "aspp_rates": [1, 2]},
    "frame_ids": [0, -1, 1],
    "num_scales": 4,
}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _images(seed, n=2, h=24, w=40):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("apply_draw", [0.7, 0.1], ids=["applied", "skipped"])
def test_color_jitter_matches_jax(apply_draw):
    img = _images(1)
    key = jax.random.PRNGKey(3)
    ref = jimage.color_jitter(key, jnp.asarray(img), s=0.25,
                              apply_prob_draw=jnp.float32(apply_draw))
    # the JAX draws (ops/image.py:160-164)
    kb, kc, ks, kh = jax.random.split(key, 4)
    factors = [float(jax.random.uniform(k, (), minval=0.75, maxval=1.25)) for k in (kb, kc, ks)]
    factors.append(float(jax.random.uniform(kh, (), minval=-0.25, maxval=0.25)))
    got = image.color_jitter(_nchw(img), s=0.25, factors=factors, apply_draw=apply_draw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-6)
    if apply_draw < 0.2:
        assert np.array_equal(_nhwc(got), img)


@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 64, 128)])
def test_gaussian_blur_matches_jax(shape):
    img = _images(2, *shape)
    key = jax.random.PRNGKey(5)
    ref = jimage.gaussian_blur(key, jnp.asarray(img), apply_prob_draw=jnp.float32(0.9))
    sigma = float(jax.random.uniform(jax.random.split(key)[0], (), minval=0.15, maxval=1.15))
    got = image.gaussian_blur(_nchw(img), sigma=sigma, apply_draw=0.9)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-6)
    assert torch.equal(image.gaussian_blur(_nchw(img), sigma=sigma, apply_draw=0.3),
                       _nchw(img))


def test_augmentations_draw_from_a_generator():
    img = _nchw(_images(3))
    a = image.color_jitter(img, generator=torch.Generator().manual_seed(1))
    b = image.color_jitter(img, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, img)
    a = image.gaussian_blur(img, generator=torch.Generator().manual_seed(2))
    assert a.shape == img.shape and not torch.equal(a, img)


def test_mix_and_depthcomp_mask_match_jax_exactly():
    rng = np.random.default_rng(6)
    disps = rng.uniform(0, 1, (4, 16, 24)).astype(np.float32)
    data = rng.uniform(0, 1, (4, 16, 24, 3)).astype(np.float32)
    soft = rng.uniform(0, 1, (4, 16, 24, 19)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    for thr in (0.0, 0.4):
        ref = jmixing.generate_depthcomp_mask(jnp.asarray(disps), key, 0.03, thr)
        got = mixing.generate_depthcomp_mask(torch.from_numpy(disps), 0.03, thr)
        assert np.array_equal(got.numpy(), np.asarray(ref))
    lo_hi = (0.2, 0.6)
    ref = jmixing.generate_depthcomp_mask(jnp.asarray(disps), key, 0.03, lo_hi)
    draw = float(jax.random.uniform(key, (), minval=0.2, maxval=0.6))
    got = mixing.generate_depthcomp_mask(torch.from_numpy(disps), 0.03, lo_hi,
                                         threshold_draw=draw)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    thr = rng.uniform(0.1, 0.4, (4, 1, 1)).astype(np.float32)
    ref_depth = jmixing.generate_depth_mask(jnp.asarray(disps), jnp.asarray(thr))
    got_depth = mixing.generate_depth_mask(torch.from_numpy(disps), torch.from_numpy(thr))
    assert np.array_equal(got_depth.numpy(), np.asarray(ref_depth))

    mask = np.asarray(ref)
    ref_d, ref_t = jmixing.mix(jnp.asarray(mask), jnp.asarray(data), jnp.asarray(soft))
    got_d, got_t = mixing.mix(torch.from_numpy(mask.copy()), _nchw(data), _nchw(soft))
    assert np.array_equal(_nhwc(got_d), np.asarray(ref_d))
    assert np.array_equal(_nhwc(got_t), np.asarray(ref_t))


def test_class_and_depthhist_masks_are_not_ported():
    """The ClassMix and depth-histogram masks through the steps' mask
    dispatch (`generate_mix_mask`), against the JAX package's with its draws
    passed in: equal masks."""
    rng = np.random.default_rng(9)
    n, c = 4, 19
    labels = rng.integers(0, c, (n, 24, 40)).astype(np.int32)
    labels[1] = np.where(labels[1] < 6, labels[1], 2)
    depths = (rng.uniform(0, 1, (n, 24, 40)) ** 2).astype(np.float32)
    key = jax.random.PRNGKey(11)
    for mask_name, draws in (
            ("class", StepDraws(class_scores=torch.from_numpy(
                np.asarray(jax.random.uniform(key, (n, c))).copy()))),
            ("depthhist", StepDraws(depthhist_u=torch.from_numpy(
                np.asarray(jax.random.uniform(key, (n,))).copy())))):
        ref = np.asarray(jax_generate_mix_mask(
            JaxStepConfig(mix_mask=mask_name, num_classes=c), key, jnp.asarray(labels),
            jnp.asarray(depths)))
        got = generate_mix_mask(StepConfig(mix_mask=mask_name, num_classes=c),
                                torch.from_numpy(labels), torch.from_numpy(depths), draws)
        assert np.array_equal(got.numpy(), ref), mask_name
        assert 0 < ref.mean() < 1


@pytest.fixture(scope="module")
def pad():
    """(JAX PAD model, its variables as numpy, numpy batch) at 64x128, batch 4."""
    model = build_model(PAD_CFG, n_classes=19)
    batch = make_synthetic_batch(4, 64, 128, frame_ids=(0, -1, 1), num_scales=4, seed=8)
    key = jax.random.PRNGKey(8)
    variables = jax.jit(model.init)({"params": key, "dropout": key},
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    return model, jax.tree_util.tree_map(np.asarray, variables), batch


def pad_shared_weights(variables, batch, gate_scale=0.0):
    """The port on the JAX PAD weights, conditioned like
    tests/test_torch_port_models.py::shared_weights: decoder kernels halved,
    running statistics from the batch. `gate_scale` > 0 replaces the zero
    SelfAttention gates by scaled copies of their feature kernels, so that the
    attention weights are live."""
    def condition(path, v):
        keys = [p.key for p in path]
        if keys[:1] == ["mtl_decoder"] and keys[-1] == "kernel":
            if keys[1] in ("sa_depth", "sa_seg") and keys[2] == "Conv_1":
                return np.asarray(variables["params"][keys[0]][keys[1]]["Conv_0"]["kernel"]
                                  ) * np.float32(gate_scale)
            if keys[1] in ("depth_dec", "seg_dec"):
                return v * np.float32(0.5)
        return v

    params = jax.tree_util.tree_map_with_path(condition, variables["params"])
    port = build_port_model(PAD_CFG, n_classes=19)
    port.load_state_dict(state_dict_from_jax(params, variables["batch_stats"], PAD_CFG))
    for m in port.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    calibrate_running_stats(port, to_device_batch(batch, "cpu"))
    _, stats = jax.tree_util.tree_map(np.array, convert_full_model(port.state_dict(), PAD_CFG))
    return {"params": params, "batch_stats": stats}, port


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pad_outputs_match_jax(pad, train):
    model, variables, batch = pad
    variables, port = pad_shared_weights(variables, batch, gate_scale=0.5)
    gates = [m.attention.weight for m in port.modules() if isinstance(m, SelfAttention)]
    assert len(gates) == 2 and all(float(g.detach().abs().max()) > 0 for g in gates)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with fnn.intercept_methods(no_flax_dropout):
        ref, mutated = jax.jit(lambda v, b: model.apply(v, b, train=train,
                                                        mutable=["batch_stats"]))(variables, jb)
    port.train(train)
    with torch.no_grad():
        got = port(to_device_batch(batch, "cpu"))
    keys = [k for k in ref if k.startswith(("disp_", "axisangle_", "translation_"))]
    keys += ["semantics", "intermediate_semantics"]
    assert len(keys) == 4 + 2 + 2 + 2
    for k in keys:
        g = _nhwc(got[k]) if k.startswith(("disp_", "semantics", "intermediate")) \
            else got[k].numpy()
        np.testing.assert_allclose(g, np.asarray(ref[k]), atol=1e-4, err_msg=k)
    if train:
        sd = state_dict_from_jax(variables["params"], jax.tree_util.tree_map(
            np.asarray, mutated["batch_stats"]), PAD_CFG)
        for k, v in port.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=1e-5, err_msg=k)


def test_pad_state_dict_round_trip_is_exact(pad):
    _, variables, _ = pad
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], PAD_CFG)
    params, stats = convert_full_model(sd, PAD_CFG)
    flat_ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        {"params": params, "batch_stats": stats})[0])
    assert len(flat_got) == len(flat_ref)
    for path, ref in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), ref, err_msg=str(path))
    port = build_port_model(PAD_CFG, n_classes=19)
    assert set(port.state_dict()) == set(sd)
    # the port initialises the gates to zero, as the JAX package does
    assert all(float(m.attention.weight.detach().abs().max()) == 0 for m in port.modules()
               if isinstance(m, SelfAttention))


def test_pad_optimizer_groups_match_jax_labels(pad):
    _, variables, _ = pad
    labels = build_param_labels(variables["params"], PAD_CFG)
    # every JAX parameter filled with its leaf index, through the converter:
    # each port parameter then names the JAX leaf, and so the JAX label, it is
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    index = {path: i for i, (path, _) in enumerate(flat)}
    marked = jax.tree_util.tree_map_with_path(
        lambda p, v: np.full(v.shape, index[p], np.float32), variables["params"])
    sd = state_dict_from_jax(marked, variables["batch_stats"], PAD_CFG)
    flat_labels = [lbl for _, lbl in jax.tree_util.tree_flatten_with_path(labels)[0]]
    port = build_port_model(PAD_CFG, n_classes=19)
    port.load_state_dict(sd)
    opt = build_optimizer({"optimizer": {"name": "sgd", "lr": 1e-2, "depth_lr": 1e-3}},
                          PAD_CFG, port)
    seen = 0
    for group in opt.groups:
        for p in group["params"]:
            assert flat_labels[int(p.flatten()[0])] == group["label"]
            seen += 1
    assert seen == len(flat) == len(list(port.parameters()))
    assert {g["label"]: g["lr"] for g in opt.groups}["depth"] == 1e-3


def test_ema_update_matches_jax(pad):
    _, variables, batch = pad
    names = state.ema_model_names({}, PAD_CFG)
    assert names == jstate.ema_model_names({}, PAD_CFG) == ("depth", "encoder", "mtl_decoder")
    rng = np.random.default_rng(9)
    params = variables["params"]
    new_params = jax.tree_util.tree_map(
        lambda v: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32), params)
    student = build_port_model(PAD_CFG, n_classes=19)
    student.load_state_dict(state_dict_from_jax(new_params, variables["batch_stats"], PAD_CFG))
    teacher = build_port_model(PAD_CFG, n_classes=19)
    teacher.load_state_dict(state_dict_from_jax(params, variables["batch_stats"], PAD_CFG))
    ema = jax.tree_util.tree_map(np.asarray, params)
    jax_update = jax.jit(jstate.update_ema, static_argnums=(3, 4))
    for step in (0, 5):
        ema = jax_update(ema, new_params, jnp.asarray(step, jnp.int32), 0.99, names)
        state.update_ema(teacher, student, step, 0.99, names)
        ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ema),
                                  variables["batch_stats"], PAD_CFG)
        for k, v in teacher.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-7, err_msg=k)
    # pose networks are outside the PAD EMA: still the teacher's initial weights
    init = state_dict_from_jax(params, variables["batch_stats"], PAD_CFG)
    k = "models.pose.net.0.weight"
    assert torch.equal(teacher.state_dict()[k], init[k])
