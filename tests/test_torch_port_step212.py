"""One exp-212 train step in the port against the JAX package's.

The `s212` step (bench.py:255-264: PAD decoder, mean teacher, online-depth
DepthMix with the depthcomp mask, color jitter and blur, mix_use_gt), cut to
resnet18 at 64x128, batch 4, with the exp-212 optimizer (experiments.py:261,
319: SGD lr 1e-2, backbone 1e-3, depth 1e-3, pose 1e-6, momentum 0.9, weight
decay 5e-4, clip 10). Both sides start from the same weights (JAX init,
conditioned as in tests/test_torch_port_semi.py, SelfAttention gates live)
and take one step on the same labeled and unlabeled batches. Dropout is off
on both sides. The port gets the JAX step's own draws, derived from its key
exactly as the JAX step derives them (train_steps.py:234-236): the two
tie-break noises, the color-jitter factors, the blur sigma and the two apply
draws.

The port runs with `fused_reprojection` off (autograd of the SSIM chain) and
on (plain K2 forward, plain K3 backward); the JAX package's fused path on the
CPU is its XLA chain, so one JAX step is the reference for both. The
photometric chain runs in f32 (`photometric_dtype` null).

Tolerances: losses rtol 1e-4; parameters, running statistics and EMA
parameters after the step atol 1e-5 (f32, op-order rounding only). Both
steps return their mix debug images (`debug_images`): the mixed images and
the mask's depths within 1e-5, the mix mask and the pseudo-label equal.
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
    train_step,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    build_model as build_port_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import reprojection

from tests.test_torch_port_models import no_flax_dropout
from tests.test_torch_port_semi import PAD_CFG, pad, pad_shared_weights  # noqa: F401

TRAINING_212 = {
    "optimizer": {"name": "sgd", "lr": 1e-2, "backbone_lr": 1e-3, "depth_lr": 1e-3,
                  "pose_lr": 1e-6, "momentum": 0.9, "weight_decay": 5e-4},
    "clip_grad_norm": 10.0,
}
S212 = dict(monodepth_lambda=1.0, segmentation_lambda=1.0, frame_ids=(0, -1, 1),
            scales=(0, 1, 2, 3), unlabeled=True, use_ema=True, mix_mask="depthcomp",
            unlabeled_color_jitter=True, unlabeled_blur=True, mix_use_gt=True,
            depthcomp_margin=0.03, depthcomp_foreground_threshold=0.0,
            depthmix_online_depth=True, ema_names=("depth", "encoder", "mtl_decoder"))
METRICS = ("total_loss", "segmentation_loss", "mono_loss", "unlabeled_loss",
           "segmentation_total_loss", "mono_total_loss")


def _jax_draws(rng, n, h, w):
    """The JAX step's draws from its key (train_steps.py:234-236,
    photometric.py:200-202, train_steps.py:213-224, ops/image.py:117-164)."""
    _, k_mono, _, _, k_strong, k_mono_u, _, _ = jax.random.split(jax.random.fold_in(rng, 0), 8)

    def noise(k):
        z = jax.random.normal(jax.random.split(k)[1], (n, h, w, 2))
        return torch.from_numpy(np.asarray(z).transpose(0, 3, 1, 2).copy())

    k_draw_j, k_jit, k_draw_b, k_blur = jax.random.split(k_strong, 4)
    kb, kc, ks, kh = jax.random.split(k_jit, 4)
    factors = [float(jax.random.uniform(k, (), minval=0.75, maxval=1.25)) for k in (kb, kc, ks)]
    factors.append(float(jax.random.uniform(kh, (), minval=-0.25, maxval=0.25)))
    draws = StepDraws(
        tie_break_noise_u=noise(k_mono_u), jitter=factors,
        jitter_apply=float(jax.random.uniform(k_draw_j, ())),
        blur_sigma=float(jax.random.uniform(jax.random.split(k_blur)[0], (),
                                            minval=0.15, maxval=1.15)),
        blur_apply=float(jax.random.uniform(k_draw_b, ())))
    return noise(k_mono), draws


@pytest.fixture(scope="module")
def jax_step(pad):
    """The JAX s212 step from the conditioned PAD weights: (variables, batches,
    draws, metrics, new state)."""
    model, variables, batch = pad
    variables, _ = pad_shared_weights(variables, batch, gate_scale=0.5)
    ubatch = make_synthetic_batch(4, 64, 128, frame_ids=(0, -1, 1), num_scales=4, seed=7,
                                  with_unlabeled_extras=True)
    n, h, w = batch["lbl"].shape
    # the first key whose draws apply both jitter (> 0.2) and blur (> 0.5)
    rng = next(k for k in map(jax.random.PRNGKey, range(50))
               if _jax_draws(k, 1, 1, 1)[1].jitter_apply > 0.2
               and _jax_draws(k, 1, 1, 1)[1].blur_apply > 0.5)
    tx = jax_build_optimizer(TRAINING_212, PAD_CFG, variables["params"])
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       ema_params=jax.tree_util.tree_map(jnp.array, variables["params"]))
    saved = dict(jax_resample._WARP_CONFIG)
    jax_resample.configure_warp("xla")  # the full-f32 warp (the Pallas one rounds to bf16)
    try:
        with fnn.intercept_methods(no_flax_dropout):
            step = jax.jit(make_train_step(model, JaxStepConfig(**S212, debug_images=True),
                                           tx))
            new_state, metrics = step(
                state, {k: jnp.asarray(v) for k, v in batch.items()},
                {k: jnp.asarray(v) for k, v in ubatch.items()}, rng)
    finally:
        jax_resample._WARP_CONFIG.update(saved)
    new_state = jax.tree_util.tree_map(np.asarray, new_state)
    ref = {k: float(metrics[k]) for k in METRICS}
    ref.update({k: np.asarray(v) for k, v in metrics.items() if k.startswith("debug/")})
    return variables, batch, ubatch, _jax_draws(rng, n, h, w), ref, new_state


@pytest.mark.parametrize("fused", [False, True], ids=["autograd", "k3"])
def test_s212_step_matches_jax(jax_step, fused):
    variables, batch, ubatch, (noise, draws), ref, new_state = jax_step
    assert draws.jitter_apply > 0.2 and draws.blur_apply > 0.5  # both augmentations ran
    port = pad_shared_weights_port(variables)
    teacher = make_teacher(port)
    opt = build_optimizer(TRAINING_212, PAD_CFG, port)
    launches = reprojection.reprojection_error_grad.launches
    got = train_step(port, opt, to_device_batch(batch, "cpu"),
                     StepConfig(**S212, fused_pred_loss=fused, debug_images=True),
                     tie_break_noise=noise, unlabeled_batch=to_device_batch(ubatch, "cpu"),
                     teacher=teacher, draws=draws)
    assert reprojection.reprojection_error_grad.launches == launches  # CPU: plain versions
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), ref[k], rtol=1e-4, err_msg=k)
    check_debug_images(got, ref)
    assert ref["mono_total_loss"] > ref["mono_loss"] > 0 and ref["unlabeled_loss"] > 0

    want = state_dict_from_jax(new_state.params, new_state.batch_stats, PAD_CFG)
    init = state_dict_from_jax(variables["params"], variables["batch_stats"], PAD_CFG)
    moved = 0
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
        moved += int(not torch.equal(want[k], init[k]))
    assert moved > 100
    want_ema = state_dict_from_jax(new_state.ema_params, new_state.batch_stats, PAD_CFG)
    for k, v in teacher.named_parameters():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(), atol=1e-5, err_msg=k)


def check_debug_images(got, ref):
    """The step's `debug/*` tensors (`debug_images`) against the JAX step's:
    the mixed images (NCHW against NHWC) and the mask's depths within 1e-5
    (f32, op-order rounding), the mix mask and the pseudo-label equal."""
    assert sorted(k for k in got if k.startswith("debug/")) == sorted(
        k for k in ref if k.startswith("debug/")) == [
        "debug/depths", "debug/mix_mask", "debug/mixed_imgs", "debug/pseudo_label"]
    np.testing.assert_allclose(got["debug/mixed_imgs"].numpy().transpose(0, 2, 3, 1),
                               ref["debug/mixed_imgs"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["debug/depths"].numpy(), ref["debug/depths"], atol=1e-5,
                               rtol=0)
    assert np.array_equal(got["debug/mix_mask"].numpy(), ref["debug/mix_mask"])
    assert np.array_equal(got["debug/pseudo_label"].numpy(), ref["debug/pseudo_label"])
    mask = ref["debug/mix_mask"]
    assert 0 < mask.mean() < 1 and set(np.unique(mask)) <= {0.0, 1.0}


def pad_shared_weights_port(variables):
    """The port holding the (already conditioned) JAX weights and statistics."""
    port = build_port_model(PAD_CFG, n_classes=19)
    port.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                             PAD_CFG))
    for m in port.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return port
