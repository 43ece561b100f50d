"""The model and step options of the port against the JAX package's.

Model forwards: the port's initialisation from a seed, conditioned as in
tests/test_torch_port_models.py (decoder kernels halved, running statistics
from the batch, dropout off), carried into the JAX trees by inverting
`state_dict_from_jax` on a template from `jax.eval_shape` (every JAX leaf is
tagged with its index, converted, and read back from the port's key), so no
JAX `model.init` runs; JAX `model.apply` runs op by op (its per-op compiles
are shared by the cases). Tolerance 1e-4, f32 on both sides (`ATOL` of
tests/test_torch_port_models.py). Batch 4 at 64x96, resnet18.

The photometric loss is held against the JAX functions under `pred_layout:
nhwc` within 1e-5 (losses and their gradients with respect to the
disparities and the poses, f32); the fused step
(`fuse_unlabeled_forward`, online DepthMix) against one jitted JAX step at
tests/test_fused_forward.py's size (resnet18, one scale, 64x96, batch 2 + 2,
dropout off), with the JAX step's draws injected. The other step cases hold
the port against itself: the fused steps against the unfused ones on
duplicated halves (as tests/test_fused_forward.py holds JAX's), `remat`
against no remat, the unlabeled step without the teacher against the
supervised one.
"""

import copy
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
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
from improving_segmentation_with_selfsupervised_depth_tpu.models import build_model
from improving_segmentation_with_selfsupervised_depth_tpu.ops import photometric as jax_photometric
from improving_segmentation_with_selfsupervised_depth_tpu.ops import resample as jax_resample
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic import (
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.interop import (
    state_dict_from_jax,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.optim import (
    build_optimizer,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.state import make_teacher
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.train_steps import (
    StepConfig,
    StepDraws,
    _monodepth_loss,
    step_config_from_cfg,
    train_step,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    build_model as build_port_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.layers import (
    ChannelDropout,
)

from tests.test_torch_port_models import ATOL, calibrate_running_stats, no_flax_dropout
from tests.test_torch_port_exp210 import two_pass_batchnorm_variance
from tests.test_torch_port_step212 import _jax_draws

N, H, W = 4, 64, 96
SMALL = (64, 64)  # the port-only step cases
PORT_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "improving_segmentation_with_selfsupervised_depth_tpu_torch")
BASE = {
    "backbone_name": "resnet18",
    "segmentation_name": "joint_seg_depth_dec",
    "segmentation_args": {"layers": [9], "head_dropout": 0.0},
    "depth_args": {"intermediate_aspp": True, "aspp_rates": [1, 2]},
    "frame_ids": [0, -1, 1],
    "num_scales": 4,
}
ASPP = {"intermediate_aspp": True, "aspp_rates": [1, 2]}
# the model options, each on the base configuration; the pose options on a
# model without the segmentation decoder
MODEL_CASES = {
    "skip_proj": {"depth_args": dict(ASPP, n_project_skip_ch=8)},
    # on PAD: the options reach its two decoders as they reach unet_dec
    "no_skips": {"segmentation_name": "mtl_pad", "segmentation_args": {},
                 "depth_args": dict(ASPP, use_skips=False)},
    "aspp_no_pooling": {"depth_args": dict(ASPP, aspp_pooling=False)},
    "two_output_channels": {"depth_args": dict(ASPP, num_output_channels=2)},
    "dropout": {"depth_args": dict(ASPP, dropout=0.3)},
    "pose_all": {"segmentation_name": None, "pose_model_input": "all"},
    "pose_all_unbatched": {"segmentation_name": None, "pose_model_input": "all",
                           "pose_pair_batching": False},
    "uncropped_for_pose": {"segmentation_name": None, "provide_uncropped_for_pose": True},
    "stereo": {"segmentation_name": None, "frame_ids": [0, -1, 1, "s"]},
    "stereo_only": {"segmentation_name": None, "frame_ids": [0, "s"]},
    "remat": {"remat": True},
}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for the port's CPU ops: the test processes share
    the machine's cores, and more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def options_batch(frame_ids, seed, n=N, h=H, w=W, num_scales=4):
    """`make_synthetic_batch` with a stereo frame "s" (the target shifted by
    4 pixels, and `stereo_T`, a 0.1 baseline along x) and the uncropped
    pose inputs `color_full_aug_{f}_0` (the frames mirrored, so that they
    differ from `color_aug_{f}_0`)."""
    temporal = [f for f in frame_ids if f != "s"]
    b = make_synthetic_batch(n, h, w, frame_ids=temporal, num_scales=num_scales, seed=seed)
    if "s" in frame_ids:
        b["color_s_0"] = np.roll(b["color_0_0"], 4, axis=2)
        b["color_aug_s_0"] = np.roll(b["color_aug_0_0"], 4, axis=2)
        stereo = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
        stereo[:, 0, 3] = 0.1
        b["stereo_T"] = stereo
    for f in temporal:
        b[f"color_full_aug_{f}_0"] = np.ascontiguousarray(b[f"color_aug_{f}_0"][:, :, ::-1])
    return b


def port_to_jax(port, jax_model, batch, model_cfg):
    """The JAX variables holding the port's weights and statistics: the
    inverse of `state_dict_from_jax` on an `eval_shape` template. Checks that
    every JAX leaf and every port tensor is carried."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jax_model.init({"params": key, "dropout": key}, b),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    tagged = treedef.unflatten([np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)])
    tags = state_dict_from_jax(tagged["params"], tagged["batch_stats"], model_cfg)
    state = port.state_dict()
    assert set(tags) == set(state)
    values = [None] * len(leaves)
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = v.detach().numpy()
        values[int(tags[k].flatten()[0])] = (a.transpose(2, 3, 1, 0) if a.ndim == 4
                                             else a).copy()
    assert all(v is not None and v.shape == x.shape for v, x in zip(values, leaves))
    return treedef.unflatten(values)


def conditioned_port(model_cfg, batch, seed):
    """The port from `seed`, decoder kernels halved, running statistics
    from `batch`, every dropout at p = 0."""
    torch.manual_seed(seed)
    port = build_port_model(model_cfg, n_classes=19)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.startswith(("models.depth.", "models.segmentation.unet_dec.",
                                "models.mtl_decoder.depth_dec.",
                                "models.mtl_decoder.seg_dec.")) and p.dim() == 4:
                p.mul_(0.5)
    for m in port.modules():
        if isinstance(m, torch.nn.Dropout2d | torch.nn.Dropout):
            m.p = 0.0
    calibrate_running_stats(port, to_device_batch(batch, "cpu"))
    return port


_COMPARED = ("disp_", "axisangle_", "translation_", "cam_T_cam_", "semantics",
             "intermediate_semantics")


def _compare_outputs(got, ref, atol=ATOL):
    keys = [k for k in ref if k.startswith(_COMPARED)]
    assert sorted(keys) == sorted(k for k in got if k.startswith(_COMPARED))
    for k in keys:
        g = (_nhwc(got[k]) if k.startswith(("disp_", "semantics", "intermediate"))
             else got[k].detach().numpy())
        np.testing.assert_allclose(g, np.asarray(ref[k]), atol=atol, err_msg=k)
    return keys


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def option_model(request):
    """(case, config, batch, port, its conditioned state, JAX model and
    variables) of one model option, shared by its eval and train cases."""
    case = request.param
    cfg = {**BASE, **MODEL_CASES[case]}
    batch = options_batch(cfg["frame_ids"], seed=1)
    port = conditioned_port(cfg, batch, seed=2)
    model = build_model(cfg, n_classes=19)
    state = {k: v.clone() for k, v in port.state_dict().items()}
    return case, cfg, batch, port, state, model, port_to_jax(port, model, batch, cfg)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_model_option_forward_matches_jax(option_model, train):
    """Train mode normalizes with the batch statistics, in JAX with its
    two-pass variance (tests/test_torch_port_exp210.py): its one-pass
    E[x^2] - E[x]^2 loses digits on the small late-stage batches."""
    case, cfg, batch, port, state, model, variables = option_model
    port.load_state_dict(state)
    with fnn.intercept_methods(no_flax_dropout), two_pass_batchnorm_variance():
        ref, mutated = model.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                                   train=train, mutable=["batch_stats"])
    port.train(train)
    if case == "dropout":
        # eval mode ignores the configured p; in train mode the frameworks
        # draw different masks (test_channel_dropout_zeroes_whole_channels_...
        # holds it there), so it is off on both sides
        drops = [m for m in port.modules() if isinstance(m, ChannelDropout)]
        assert len(drops) == 18  # every ConvBlock of the two decoders
        for m in drops:
            m.p = 0.0 if train else 0.3
    with torch.set_grad_enabled(case == "remat" and train):
        got = port(to_device_batch(batch, "cpu"))
        if torch.is_grad_enabled():  # the recompute runs in the backward
            sum(v.float().sum() for k, v in got.items() if k.startswith(("disp_", "sem"))
                ).backward()
    keys = _compare_outputs(got, ref)
    poses = [k for k in keys if k.startswith("cam_T_cam")]
    assert len(poses) == len([f for f in cfg["frame_ids"][1:] if f != "s"])
    if case == "two_output_channels":
        assert got["disp_0"].shape[1] == 2
    if train:  # the running statistics moved once, the same way
        sd = state_dict_from_jax(variables["params"], jax.tree_util.tree_map(
            np.asarray, mutated["batch_stats"]), cfg)
        for k, v in port.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=1e-5, err_msg=k)


def test_channel_dropout_zeroes_whole_channels_and_repeats_with_its_seed():
    p = 0.3
    drop = ChannelDropout(p, seed=5)
    x = torch.rand((8, 64, 6, 7)) + 0.5
    y = drop(x)
    zeroed = (y == 0).all(dim=(2, 3))
    kept = ~zeroed
    assert torch.equal((y != 0).any(dim=(2, 3)), kept)  # whole planes or nothing
    torch.testing.assert_close(y[kept], (x / (1 - p))[kept], rtol=0, atol=0)
    assert 0.15 < zeroed.float().mean() < 0.45
    again = ChannelDropout(p, seed=5)
    assert torch.equal(again(x), y)
    assert not torch.equal(drop(x), y)  # the generator moves on
    drop.generator = torch.Generator().manual_seed(5)
    assert torch.equal(drop(x), y)
    state = torch.get_rng_state()
    drop(x)
    assert torch.equal(torch.get_rng_state(), state)  # the global RNG is not drawn
    drop.eval()
    assert drop(x) is x


def _dropout_masks(seed):
    """The (N, C) masks that each ChannelDropout of a small model with
    dropout 0.5 in every ConvBlock drew in one train-mode forward, in module
    order, the model built with the run seed `seed`."""
    cfg = {**BASE, "depth_args": dict(ASPP, dropout=0.5)}
    torch.manual_seed(0)  # the same weights whatever `seed`
    model = build_port_model(cfg, n_classes=19, seed=seed).train()
    masks = []
    for m in model.modules():
        if isinstance(m, ChannelDropout):
            m.register_forward_hook(lambda _, __, y: masks.append((y == 0).all(dim=(2, 3))))
    with torch.no_grad():
        model(to_device_batch(options_batch(BASE["frame_ids"], 1, n=2, h=SMALL[0],
                                            w=SMALL[1]), "cpu"))
    assert len(masks) == 18  # every ConvBlock of the depth and U-Net decoders
    return masks


def test_same_shaped_dropouts_of_one_forward_draw_different_masks():
    """upconv_i_0 and upconv_i_1, and the depth and U-Net decoders, output
    the same (N, C): each module draws from its own stream."""
    masks = _dropout_masks(seed=42)
    same_shape = [(i, j) for i in range(len(masks)) for j in range(i)
                  if masks[i].shape == masks[j].shape]
    assert len(same_shape) >= 18
    for i, j in same_shape:
        assert not torch.equal(masks[i], masks[j]), (i, j)
    assert all(0 < float(m.float().mean()) < 1 for m in masks if m.numel() >= 32)


def test_dropout_masks_follow_the_run_seed():
    first = _dropout_masks(seed=42)
    assert all(torch.equal(a, b) for a, b in zip(first, _dropout_masks(seed=42)))
    other = _dropout_masks(seed=43)
    assert sum(torch.equal(a, b) for a, b in zip(first, other)) <= 1


# ---------------------------------------------------------------------------
# the photometric loss: pred_layout, stereo frames, remat
# ---------------------------------------------------------------------------

def _photometric_inputs(frame_ids, seed):
    """A batch and smooth disparities and poses (numpy NHWC and (N, 4, 4)),
    and the JAX noise key."""
    batch = options_batch(frame_ids, seed, n=2, h=32, w=64)
    rng = np.random.default_rng(seed)
    disps = {f"disp_{s}": (0.05 + 0.3 * rng.uniform(0, 1, (2, 32 >> s, 64 >> s, 1))
                           ).astype(np.float32) for s in range(4)}
    poses = {}
    for f in frame_ids[1:]:
        if f == "s":
            continue
        T = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
        T[:, :3, 3] = rng.normal(0, 0.05, (2, 3))
        poses[f"cam_T_cam_0_{f}"] = T
    return batch, disps, poses


def _jax_photometric(frame_ids, batch, disps, poses, key, pred_layout="nhwc", **loss_kw):
    """JAX's per-scale losses and their gradients w.r.t. disparities and poses."""
    scales = (0, 1, 2, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(d, p):
        out = jax_photometric.generate_images_pred(
            jb, {**d, **p}, scales=scales, frame_ids=frame_ids, min_depth=0.1,
            max_depth=100.0, pred_layout=pred_layout)
        losses = jax_photometric.compute_losses(
            key, jb, out, scales=scales, frame_ids=frame_ids, disparity_smoothness=1e-3,
            pred_layout=pred_layout, **loss_kw)
        return losses["loss"], losses

    saved = dict(jax_resample._WARP_CONFIG)
    jax_resample.configure_warp("xla")  # the full-f32 warp (the Pallas one rounds to bf16)
    try:
        (_, losses), (gd, gp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(v) for k, v in disps.items()},
            {k: jnp.asarray(v) for k, v in poses.items()})
    finally:
        jax_resample._WARP_CONFIG.update(saved)
    return ({k: float(v) for k, v in losses.items()},
            {**{k: np.asarray(v) for k, v in gd.items()},
             **{k: np.asarray(v) for k, v in gp.items()}})


def _jax_noise(key, n, h, w, f):
    """compute_losses' tie-break draw from its key, NCHW."""
    z = jax.random.normal(jax.random.split(key)[1], (n, h, w, f))
    return torch.from_numpy(np.asarray(z).transpose(0, 3, 1, 2).copy())


def _port_photometric(frame_ids, batch, disps, poses, noise, fused_pred=False, remat=False):
    """The port's total loss, per-scale losses and gradients (NHWC for the
    disparities), through the step's `_monodepth_loss`."""
    tb = to_device_batch(batch, "cpu")
    leaves = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()).requires_grad_()
              for k, v in disps.items()}
    leaves.update({k: torch.from_numpy(v).requires_grad_() for k, v in poses.items()})
    cfg = StepConfig(monodepth_lambda=1.0, frame_ids=tuple(frame_ids),
                     fused_pred_loss=fused_pred, remat_photometric=remat)
    loss = _monodepth_loss(cfg, tb, dict(leaves), None, noise)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out = {k: (_nhwc(g) if k.startswith("disp") else g.numpy())
           for k, g in zip(leaves, grads)}
    return float(loss.detach()), out


@pytest.fixture(scope="module", params=[(0, -1, 1), (0, -1, 1, "s")], ids=["mono", "stereo"])
def photometric_case(request):
    frame_ids = request.param
    batch, disps, poses = _photometric_inputs(frame_ids, seed=11)
    key = jax.random.PRNGKey(3)
    ref_losses, ref_grads = _jax_photometric(frame_ids, batch, disps, poses, key)
    noise = _jax_noise(key, 2, 32, 64, len(frame_ids) - 1)
    return frame_ids, batch, disps, poses, noise, ref_losses, ref_grads


@pytest.mark.parametrize("fused_pred", [False, True], ids=["chain", "k2k3"])
def test_nhwc_losses_and_gradients_match_jax(photometric_case, fused_pred):
    """JAX's `pred_layout: nhwc` (one warp per frame and scale) against the
    port's one packed warp, which it runs for either layout."""
    frame_ids, batch, disps, poses, noise, ref_losses, ref_grads = photometric_case
    loss, grads = _port_photometric(frame_ids, batch, disps, poses, noise, fused_pred)
    np.testing.assert_allclose(loss, ref_losses["loss"], atol=1e-5, rtol=0)
    assert sorted(grads) == sorted(ref_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref_grads[k], atol=1e-5, rtol=0, err_msg=k)
    assert max(np.abs(g).max() for g in ref_grads.values()) > 1e-3


@pytest.mark.parametrize("fused_pred", [False, True], ids=["chain", "k2k3"])
def test_remat_photometric_equals_stored(photometric_case, fused_pred):
    """`remat_photometric` gives the stored chain's loss and gradients (f32,
    op-order rounding)."""
    frame_ids, batch, disps, poses, noise = photometric_case[:5]
    want_loss, want = _port_photometric(frame_ids, batch, disps, poses, noise, fused_pred)
    loss, grads = _port_photometric(frame_ids, batch, disps, poses, noise, fused_pred,
                                    remat=True)
    np.testing.assert_allclose(loss, want_loss, atol=1e-6, rtol=0)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[k], atol=1e-6, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the step options
# ---------------------------------------------------------------------------

FUSED_CFG = {
    "backbone_name": "resnet18",
    "segmentation_name": "joint_seg_depth_dec",
    # no ASPP (its fixed 0.5 dropout) and no head dropout, as in
    # tests/test_fused_forward.py
    "segmentation_args": {"layers": [9], "head_dropout": 0.0},
    "depth_args": {},
    "frame_ids": [0, -1, 1],
    "num_scales": 1,
}
SEG_ONLY_CFG = dict(FUSED_CFG, disable_monodepth=True, disable_pose=True)
SGD = {"optimizer": {"name": "sgd", "lr": 1e-2, "momentum": 0.9}, "lr_schedule": None}
ONLINE = dict(monodepth_lambda=1.0, segmentation_lambda=1.0, frame_ids=(0, -1, 1), scales=(0,),
              unlabeled=True, use_ema=True, mix_mask="depthcomp", unlabeled_color_jitter=True,
              unlabeled_blur=True, mix_use_gt=True, depthcomp_margin=0.03,
              depthcomp_foreground_threshold=0.0, depthmix_online_depth=True)
OFFLINE = dict(ONLINE, monodepth_lambda=0.0, depthmix_online_depth=False, mix_mask=None,
               unlabeled_color_jitter=False, unlabeled_blur=False)
METRICS = ("total_loss", "segmentation_loss", "mono_loss", "unlabeled_loss",
           "segmentation_total_loss", "mono_total_loss")
DRAWS = StepDraws(jitter=(1.1, 0.9, 1.2, 0.05), jitter_apply=0.9, blur_sigma=0.8,
                  blur_apply=0.9)


def _fused_batches(identical_halves, size=(H, W), n=2):
    batch = make_synthetic_batch(n, *size, frame_ids=(0, -1, 1), num_scales=1)
    extras = make_synthetic_batch(n, *size, frame_ids=(0, -1, 1), num_scales=1, seed=7,
                                  with_unlabeled_extras=True)
    if not identical_halves:
        return batch, extras
    ubatch = dict(batch)
    ubatch.update(onehot_lbl=extras["onehot_lbl"], is_labeled=extras["is_labeled"])
    return batch, ubatch


def _port_step(port, model_cfg, fields, batch, ubatch, draws, noise=None, remat=False,
               **cfg_kw):
    """One port step on a copy of `port` (with `remat`, its encoder's
    blocks checkpointed): (metrics as floats, the copy)."""
    model = copy.deepcopy(port)
    model.models["encoder"].encoder.remat = remat
    teacher = make_teacher(model)
    got = train_step(model, build_optimizer(SGD, model_cfg, model),
                     to_device_batch(batch, "cpu"), StepConfig(**fields, **cfg_kw),
                     tie_break_noise=noise,
                     unlabeled_batch=to_device_batch(ubatch, "cpu") if ubatch else None,
                     teacher=teacher, draws=draws)
    return {k: float(v) for k, v in got.items() if not k.startswith("debug/")}, model


@pytest.fixture(scope="module")
def jax_fused_step():
    """The JAX fused online-DepthMix step (one jit) from the port's
    conditioned weights, on distinct halves."""
    batch, ubatch = _fused_batches(identical_halves=False)
    port = conditioned_port(FUSED_CFG, batch, seed=12)
    model = build_model(FUSED_CFG, n_classes=19)
    variables = port_to_jax(port, model, batch, FUSED_CFG)
    rng = next(k for k in map(jax.random.PRNGKey, range(50))
               if _jax_draws(k, 1, 1, 1)[1].jitter_apply > 0.2
               and _jax_draws(k, 1, 1, 1)[1].blur_apply > 0.5)
    tx = jax_build_optimizer(SGD, FUSED_CFG, variables["params"])
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       ema_params=jax.tree_util.tree_map(jnp.array, variables["params"]))
    saved = dict(jax_resample._WARP_CONFIG)
    jax_resample.configure_warp("xla")
    try:
        with fnn.intercept_methods(no_flax_dropout):
            step = jax.jit(make_train_step(
                model, JaxStepConfig(**ONLINE, fuse_unlabeled_forward=True), tx))
            new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                      {k: jnp.asarray(v) for k, v in ubatch.items()}, rng)
    finally:
        jax_resample._WARP_CONFIG.update(saved)
    # the fused pass draws its tie-break noise from the labeled key over 2N
    noise, draws = _jax_draws(rng, 4, H, W)
    draws = dataclasses.replace(draws, tie_break_noise_u=None, tie_break_noise_fused=noise)
    return (port, batch, ubatch, draws, {k: float(metrics[k]) for k in METRICS}, variables,
            jax.tree_util.tree_map(np.asarray, new_state))


def test_fused_step_matches_jax(jax_fused_step):
    port, batch, ubatch, draws, ref, variables, new_state = jax_fused_step
    got, model = _port_step(port, FUSED_CFG, ONLINE, batch, ubatch, draws,
                            fuse_unlabeled_forward=True)
    for k in METRICS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert ref["mono_total_loss"] == pytest.approx(2 * ref["mono_loss"])
    assert ref["mono_loss"] > 0 and ref["unlabeled_loss"] > 0
    want = state_dict_from_jax(new_state.params, new_state.batch_stats, FUSED_CFG)
    init = state_dict_from_jax(variables["params"], variables["batch_stats"], FUSED_CFG)
    moved = 0
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
        moved += int(not torch.equal(want[k], init[k]))
    assert moved > len(want) // 2


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_fused_step_equals_unfused_on_duplicated_halves(mode):
    """With the unlabeled half a copy of the labeled one, the 2N batch's
    BatchNorm statistics are each half's, so the fused step equals the
    unfused one up to op-order rounding (tests/test_fused_forward.py's
    argument and tolerances); the offline mode with no mix mask and no
    augmentation, so that the mixed half is a copy too."""
    model_cfg, fields = (FUSED_CFG, ONLINE) if mode == "online" else (SEG_ONLY_CFG, OFFLINE)
    batch, ubatch = _fused_batches(identical_halves=True, size=SMALL)
    port = conditioned_port(model_cfg, batch, seed=13)
    gen = torch.Generator().manual_seed(3)
    noise, noise_u = (torch.randn((2, 2, *SMALL), generator=gen) for _ in range(2))
    unfused, m_u = _port_step(port, model_cfg, fields, batch, ubatch,
                              dataclasses.replace(DRAWS, tie_break_noise_u=noise_u), noise)
    fused, m_f = _port_step(port, model_cfg, fields, batch, ubatch, dataclasses.replace(
        DRAWS, tie_break_noise_fused=torch.cat([noise, noise_u])), fuse_unlabeled_forward=True)
    for k in METRICS:
        assert np.isfinite(fused[k]), k
        assert abs(fused[k] - unfused[k]) <= 1e-4 * max(1.0, abs(unfused[k])), (
            k, fused[k], unfused[k])
    assert fused["unlabeled_loss"] > 0
    moved = 0
    for (k, a), b in zip(m_f.named_parameters(), m_u.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=5e-3,
                                   atol=5e-6, err_msg=k)
        moved += int(not torch.equal(a, dict(port.named_parameters())[k]))
    assert moved > 10


@pytest.fixture(scope="module")
def small_port():
    """The conditioned FUSED_CFG port and distinct halves at SMALL, with the
    labeled pass's tie-break noise and draws, shared by the step cases."""
    batch, ubatch = _fused_batches(identical_halves=False, size=SMALL)
    noise = torch.randn((2, 2, *SMALL), generator=torch.Generator().manual_seed(4))
    return (conditioned_port(FUSED_CFG, batch, seed=14), batch, ubatch, noise,
            dataclasses.replace(DRAWS, tie_break_noise_u=noise.flip(0)))


@pytest.mark.parametrize("fields", [
    dict(ONLINE, monodepth_lambda=0.0),  # online DepthMix without the photometric loss
    dict(OFFLINE, monodepth_lambda=1.0),  # offline DepthMix with it
    dict(ONLINE, unlabeled=False, use_ema=False),  # no unlabeled branch
], ids=["online_no_mono", "offline_mono", "supervised"])
def test_fuse_knob_where_no_gate_opens_runs_unfused(small_port, fields):
    port, batch, ubatch, noise, draws = small_port
    a, m_a = _port_step(port, FUSED_CFG, fields, batch, ubatch, draws, noise)
    b, m_b = _port_step(port, FUSED_CFG, fields, batch, ubatch, draws, noise,
                        fuse_unlabeled_forward=True)
    assert a == b
    for x, y in zip(m_a.state_dict().values(), m_b.state_dict().values()):
        assert torch.equal(x, y)


def test_unlabeled_without_the_teacher_is_the_supervised_step(small_port):
    port, batch, ubatch, noise, _ = small_port
    sup, m_s = _port_step(port, FUSED_CFG, dict(ONLINE, unlabeled=False, use_ema=False),
                          batch, None, DRAWS, noise)
    semi, m_u = _port_step(port, FUSED_CFG, dict(ONLINE, use_ema=False), batch, ubatch, DRAWS,
                           noise)
    assert sup == semi and "unlabeled_loss" not in semi
    for x, y in zip(m_s.state_dict().values(), m_u.state_dict().values()):
        assert torch.equal(x, y)


def test_remat_step_keeps_one_batchnorm_update_and_the_gradients(small_port):
    """One step with `model.remat` against one without, from the same
    weights: the parameters, the running statistics and their update count
    after the step are the same (the recompute in the backward leaves the
    statistics alone)."""
    port, batch, ubatch, noise, draws = small_port
    plain, m_p = _port_step(port, FUSED_CFG, ONLINE, batch, ubatch, draws, noise)
    remat, m_r = _port_step(port, FUSED_CFG, ONLINE, batch, ubatch, draws, noise, remat=True)
    assert m_r.models["encoder"].encoder.remat and not m_p.models["encoder"].encoder.remat
    for k in METRICS:
        np.testing.assert_allclose(remat[k], plain[k], rtol=1e-6, err_msg=k)
    before = port.state_dict()
    sd_r = m_r.state_dict()
    for k, v in m_p.state_dict().items():
        np.testing.assert_allclose(sd_r[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
        if k.endswith("num_batches_tracked") and k.startswith("models.encoder"):
            # three student forwards (labeled, unlabeled, mixed), one update each
            assert int(v) == int(before[k]) + 3


def _packaged(name):
    with open(os.path.join(PORT_PKG, "configs", name)) as fp:
        return yaml.safe_load(fp)


@pytest.mark.parametrize("section,key,value", [
    ("model", "remat", True),
    ("model", "pose_model_input", "all"),
    ("model", "provide_uncropped_for_pose", True),
    ("model", "frame_ids", [0, -1, 1, "s"]),
    ("model", "depth_args", dict(ASPP, dropout=0.2, n_project_skip_ch=16, use_skips=True,
                                 aspp_pooling=False, num_output_channels=1)),
    ("model", "depth_args", dict(ASPP, use_skips=False)),
    ("training", "fuse_unlabeled_forward", True),
    ("training", "pred_layout", "nhwc"),
    ("training", "remat_photometric", True),
])
def test_build_model_and_step_config_accept_every_option(section, key, value):
    cfg = _packaged("exp212_pad_online_synthetic.yml")
    cfg["model"]["backbone_name"] = "resnet18"
    cfg[section][key] = value
    with torch.device("meta"):  # the modules without their initialisation's cost
        build_port_model(cfg["model"], n_classes=19)
    step_cfg = step_config_from_cfg(cfg)
    if key == "pred_layout":  # accepted, and run as the packed warp
        del cfg[section][key]
        assert step_cfg == step_config_from_cfg(cfg)
    elif section == "training":
        assert getattr(step_cfg, key) == value


def test_not_ported_is_left_for_multi_gpu_only():
    """The port's `not_ported` errors: one, `--spatial-shards`."""
    calls = []
    for root, _, files in os.walk(PORT_PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fp:
                    calls += [(name, m.group(1)) for m in re.finditer(
                        r"raise not_ported\((.{0,200})", fp.read(), re.S)]
    assert len(calls) == 1 and calls[0][0] == "inference_cli.py", calls
    assert '"multi-GPU"' in calls[0][1]
    with pytest.raises(ValueError, match="pred_layout"):
        step_config_from_cfg({"training": {"pred_layout": "nchw"}})
