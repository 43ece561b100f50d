"""The exp-210 pieces of the port against the JAX package's.

The berhu loss, the ClassMix mask and the depth-histogram thresholds (their
draws passed in), then two train steps against `make_train_step`, each at
resnet18, 64x128, batch 4 labeled + 4 unlabeled:
- `s210` (bench.py:245-253): the segmentation-only model (no depth decoder,
  no pose network), the EMA teacher, offline DepthMix (the depthcomp mask on
  the unlabeled batch's pseudo-depth), color jitter and blur, mix_use_gt;
- a second step configuration with what `s210` leaves off: the depth decoder
  without a pose network and `monodepth_lambda` 0, the berhu pseudo-depth
  loss in log space, `freeze_backbone_bn`, `depthmix_online_depth` (on the
  pseudo-depth, as without the photometric loss), `backward_first_pseudo_label`
  and the ClassMix mask.
The weights are the port's initialisation, conditioned as in
tests/test_torch_port_models.py (decoder kernels halved, running statistics
from a batch) and converted to the JAX trees with the JAX package's
`convert_full_model`, so no JAX `model.init` runs. Dropout is off on both
sides; the port gets the JAX step's own draws (its key split as the JAX step
splits it). The optimizer is bench.py:220-224's.

With the encoder frozen, the ASPP projection BatchNorm of both decoders sees
inputs whose mean lies far above their spread, where Flax's default one-pass
f32 variance E[x^2] - E[x]^2 loses digits: its running statistics came out
up to 2.3e-5 away from the port's (Welford) ones, and within 1e-6 when the
JAX reference computed the two-pass variance. That step's JAX reference runs
Flax BatchNorm with `use_fast_variance=False` (the same statistics, computed
exactly); nothing else of it changes.

Tolerances: berhu rtol 1e-6 (f32, op order); the class mask exact (integer
ranks of the same scores); the depth-histogram thresholds rtol 1e-6: the
two log1p differ in the last bit at about a quarter of the pixels, which
moves none of them across a bin edge here (the test counts it), so the
histograms are equal and the thresholds differ only by the rounding of the
edges and of expm1; the steps' losses rtol 1e-4, parameters, running statistics and
EMA parameters atol 1e-5 (f32 on the CPU, op-order rounding only); their mix
debug images as tests/test_torch_port_step212.py holds them.
"""

import contextlib
import dataclasses

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from improving_segmentation_with_selfsupervised_depth_tpu.data.synthetic import (
    make_synthetic_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.full_model_interop import (
    convert_full_model,
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
from improving_segmentation_with_selfsupervised_depth_tpu.ops import losses as jlosses
from improving_segmentation_with_selfsupervised_depth_tpu.ops import mixing as jmixing
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
    train_step,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    build_model as build_port_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.layers import (
    SelfAttention,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import losses, mixing

from tests.test_torch_port_models import TINY_CFG, calibrate_running_stats, no_flax_dropout
from tests.test_torch_port_step import TRAINING_CFG
from tests.test_torch_port_step212 import _jax_draws, check_debug_images

N, H, W = 4, 64, 128
# the exp-210 model (bench.py:246-247), and the depth decoder without pose
SEG_CFG = dict(TINY_CFG, disable_monodepth=True, disable_pose=True)
FROZEN_CFG = dict(TINY_CFG, disable_pose=True, freeze_backbone_bn=True)
COMMON = dict(segmentation_lambda=1.0, frame_ids=(0, -1, 1), scales=(0, 1, 2, 3),
              unlabeled=True, use_ema=True, unlabeled_color_jitter=True,
              unlabeled_blur=True, mix_use_gt=True)
S210 = dict(COMMON, monodepth_lambda=0.0, mix_mask="depthcomp", depthcomp_margin=0.03,
            depthcomp_foreground_threshold=0.0)
OTHER = dict(COMMON, monodepth_lambda=0.0, pseudo_depth_lambda=1.0,
             pseudo_depth_loss_log=True, depthmix_online_depth=True,
             backward_first_pseudo_label=True, mix_mask="class")
METRICS = ("total_loss", "segmentation_loss", "unlabeled_loss", "pseudo_depth_loss",
           "segmentation_total_loss", "mono_total_loss")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for the port's CPU ops: the test processes share
    the machine's cores, and more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_and_jax_weights(model_cfg, batch, seed, gate_scale=0.0):
    """(port model, JAX variables) holding the same weights and statistics:
    the port's initialisation from `seed`, decoder kernels halved and running
    statistics from `batch` (tests/test_torch_port_models.py explains why),
    dropout off. `gate_scale` > 0 makes PAD's SelfAttention gates scaled
    copies of their feature kernels, so that they are live (as in
    tests/test_torch_port_semi.py)."""
    torch.manual_seed(seed)
    # freeze_backbone_bn is set after the running statistics are
    port = build_port_model(dict(model_cfg, freeze_backbone_bn=False), n_classes=19)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.startswith(("models.depth.", "models.segmentation.unet_dec.",
                                "models.mtl_decoder.depth_dec.",
                                "models.mtl_decoder.seg_dec.")) and p.dim() == 4:
                p.mul_(0.5)
        for m in port.modules():
            if isinstance(m, SelfAttention):
                m.attention.weight.copy_(m.conv.weight * gate_scale)
    for m in port.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    calibrate_running_stats(port, to_device_batch(batch, "cpu"))
    port.freeze_backbone_bn = model_cfg.get("freeze_backbone_bn", False)
    params, stats = jax.tree_util.tree_map(np.array,
                                           convert_full_model(port.state_dict(), model_cfg))
    return port, {"params": params, "batch_stats": stats}


def test_berhu_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (2, 1, 16, 24)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 1, 16, 24)).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, 1, 16, 24)) > 0.3).astype(np.float32)
    for apply_log in (False, True):
        ref = jlosses.berhu(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
                            apply_log=apply_log)
        got = losses.berhu(torch.from_numpy(pred), torch.from_numpy(target),
                           torch.from_numpy(mask), apply_log=apply_log)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # every error above the threshold and below it occurs
    absdiff = np.abs(target - pred) * mask
    c = 0.2 * absdiff.max()
    assert (absdiff > c).any() and ((absdiff <= c) & (absdiff > 0)).any()


def test_class_mask_matches_jax():
    rng = np.random.default_rng(1)
    n, c = 6, 19
    labels = rng.integers(0, c, (n, 16, 24)).astype(np.int32)
    labels[0] = rng.integers(0, 5, (16, 24))       # 5 classes present (odd)
    labels[1] = 3                                  # one class: nothing selected
    labels[2, :4] = 250                            # ignored pixels
    labels[3] = np.where(labels[3] < 8, labels[3], 11)  # 9 classes
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jmixing.generate_class_mask(key, jnp.asarray(labels), c, 250))
    scores = torch.from_numpy(np.asarray(jax.random.uniform(key, (n, c))).copy())
    got = mixing.generate_class_mask(torch.from_numpy(labels), c, 250, scores=scores)
    assert np.array_equal(got.numpy(), ref)
    assert ref[1].sum() == 0 and ref[2, :4].sum() == 0 and 0 < ref.mean() < 1


def test_depthhist_thresholds_match_jax():
    rng = np.random.default_rng(2)
    n = 4
    depth = np.concatenate([
        rng.uniform(0, 1, (1, 32, 48)),                     # flat histogram
        rng.exponential(0.2, (1, 32, 48)),                  # a peak at the near end
        np.clip(rng.normal(0.6, 0.05, (1, 32, 48)), 0, 1),  # one narrow peak
        rng.uniform(0, 1, (1, 32, 48)) ** 3,
    ]).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jmixing.depthhist_thresholds(jnp.asarray(depth), key))
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (n,))).copy())
    got = mixing.depthhist_thresholds(torch.from_numpy(depth), u=u).numpy()
    # the bins each framework's log1p puts the pixels in (the same f32 formula)
    def bins(logd):
        dmin, dmax = logd.min(1, keepdims=True), logd.max(1, keepdims=True)
        width = (dmax - dmin) / np.float32(100) + np.float32(1e-12)
        return np.clip(((logd - dmin) / width).astype(np.int32), 0, 99)

    logd_t = torch.log1p(torch.from_numpy(depth).reshape(n, -1)).numpy()
    logd_j = np.asarray(jnp.log1p(jnp.asarray(depth).reshape(n, -1)))
    moved = int((bins(logd_t) != bins(logd_j)).sum())
    print(f"log1p differs in the last bit at {int((logd_t != logd_j).sum())} of {depth.size} "
          f"pixels; {moved} pixels change bins")
    assert moved == 0
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.all(np.isfinite(got)) and len(set(np.round(got, 6))) == n


@contextlib.contextmanager
def two_pass_batchnorm_variance():
    """Flax BatchNorm with `use_fast_variance=False` while traced."""
    compute_stats = flax_norm._compute_stats

    def exact(*args, **kwargs):
        return compute_stats(*args, **{**kwargs, "use_fast_variance": False})

    flax_norm._compute_stats = exact
    try:
        yield
    finally:
        flax_norm._compute_stats = compute_stats


def _jax_step(model_cfg, step_fields, seed, exact_variance=False):
    """One JAX train step from the port's conditioned weights: (port model,
    batches, port draws, tie-break noise, JAX metrics, JAX state before and
    after)."""
    batch = make_synthetic_batch(N, H, W, frame_ids=(0, -1, 1), num_scales=4, seed=seed)
    ubatch = make_synthetic_batch(N, H, W, frame_ids=(0, -1, 1), num_scales=4,
                                  seed=seed + 1, with_unlabeled_extras=True)
    port, variables = port_and_jax_weights(model_cfg, batch, seed)
    # the first key whose draws apply both jitter (> 0.2) and blur (> 0.5)
    rng = next(k for k in map(jax.random.PRNGKey, range(50))
               if _jax_draws(k, 1, 1, 1)[1].jitter_apply > 0.2
               and _jax_draws(k, 1, 1, 1)[1].blur_apply > 0.5)
    noise, draws = _jax_draws(rng, N, H, W)
    k_mix = jax.random.split(jax.random.fold_in(rng, 0), 8)[3]
    scores = np.asarray(jax.random.uniform(k_mix, (N, 19)))
    draws = dataclasses.replace(draws, class_scores=torch.from_numpy(scores.copy()))
    model = build_model(model_cfg, n_classes=19)
    tx = jax_build_optimizer(TRAINING_CFG, model_cfg, variables["params"])
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       ema_params=jax.tree_util.tree_map(jnp.array, variables["params"]))
    variance = two_pass_batchnorm_variance() if exact_variance else contextlib.nullcontext()
    with fnn.intercept_methods(no_flax_dropout), variance:
        step = jax.jit(make_train_step(model, JaxStepConfig(**step_fields, debug_images=True),
                                       tx))
        new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                  {k: jnp.asarray(v) for k, v in ubatch.items()}, rng)
    ref = {k: float(metrics[k]) for k in METRICS}
    ref.update({k: np.asarray(v) for k, v in metrics.items() if k.startswith("debug/")})
    return (port, batch, ubatch, draws, noise, ref, variables,
            jax.tree_util.tree_map(np.asarray, new_state))


@pytest.fixture(scope="module")
def s210_step():
    return _jax_step(SEG_CFG, S210, seed=20)


@pytest.fixture(scope="module")
def other_step():
    return _jax_step(FROZEN_CFG, dict(OTHER, freeze_backbone_bn=True), seed=30,
                     exact_variance=True)


def _check_step(jax_step, model_cfg, fields, frozen):
    port, batch, ubatch, draws, noise, ref, variables, new_state = jax_step
    teacher = make_teacher(port)
    enc_before = {k: v.clone() for k, v in port.models["encoder"].state_dict().items()}
    opt = build_optimizer(TRAINING_CFG, model_cfg, port)
    got = train_step(port, opt, to_device_batch(batch, "cpu"),
                     StepConfig(**fields, debug_images=True), tie_break_noise=noise,
                     unlabeled_batch=to_device_batch(ubatch, "cpu"), teacher=teacher,
                     draws=draws)
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), ref[k], rtol=1e-4, err_msg=k)
    check_debug_images(got, ref)
    assert float(got["feat_dist_loss"]) == 0.0 and float(got["mono_loss"]) == 0.0
    assert ref["unlabeled_loss"] > 0

    want = state_dict_from_jax(new_state.params, new_state.batch_stats, model_cfg)
    init = state_dict_from_jax(variables["params"], variables["batch_stats"], model_cfg)
    assert set(want) == set(port.state_dict())  # the converter carries every tensor
    moved = 0
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
        moved += int(not torch.equal(want[k], init[k]))
    assert moved > len(want) // 2
    want_ema = state_dict_from_jax(new_state.ema_params, new_state.batch_stats, model_cfg)
    for k, v in teacher.named_parameters():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(), atol=1e-5, err_msg=k)

    # freeze_backbone_bn: the encoder's running statistics stay as they were,
    # in the port and in JAX; otherwise both move
    stats = [k for k in enc_before if k.endswith(("running_mean", "running_var"))]
    after = port.models["encoder"].state_dict()
    unchanged = [torch.equal(after[k], enc_before[k]) for k in stats]
    jax_unchanged = [torch.equal(want["models.encoder." + k], init["models.encoder." + k])
                     for k in stats]
    assert all(unchanged) == all(jax_unchanged) == frozen
    if not frozen:
        assert not any(unchanged)


def test_s210_step_matches_jax(s210_step):
    assert "pseudo_depth" in s210_step[2]  # the offline DepthMix depths
    _check_step(s210_step, SEG_CFG, S210, frozen=False)
    assert "models.depth.decoder.0.block.0.conv.weight" not in s210_step[0].state_dict()
    assert not any(k.startswith("models.pose") for k in s210_step[0].state_dict())


def test_offline_pseudo_depth_class_mix_frozen_bn_step_matches_jax(other_step):
    assert other_step[5]["pseudo_depth_loss"] > 0
    _check_step(other_step, FROZEN_CFG, OTHER, frozen=True)
