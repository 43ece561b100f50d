"""SDE pretraining in the port against the JAX package: Adam, frozen groups,
the ImageNet encoder with its feature-distance loss, and the bf16 model.

(a) Two train steps of `make_train_step` against the port's `train_step`
    (resnet18, 64x128, batch 4, a new batch each step): Adam (optax's eps
    1e-8, dec6's lr 1e-5) with weight decay, a pose lr group and a schedule
    that halves the lr at step 1, `freeze_backbone` (and
    `freeze_segmentation` without a head, as the published configs set it),
    the ImageNet encoder and `feat_dist_lambda` 0.01, in f32. The weights are
    the port's initialisation, conditioned as in
    tests/test_torch_port_exp210.py (decoder kernels halved, running
    statistics from the batch, the ImageNet encoder's too) and converted
    with the JAX package's `convert_full_model`; dropout is off on both
    sides, and each step's tie-break noise is derived from its JAX key as
    the JAX step derives it. JAX runs its f32 XLA warp.
(b) The optimizer alone, on the same gradients: the port's Adam (and SGD)
    against the optax chain of the JAX `build_optimizer`, three steps, with
    the frozen groups, per-group lrs, weight decay, the schedule, Adam's
    bias correction at t = 1, 2, 3 and the masked clip.
(c) `build_param_labels` against the port's `param_labels` and optimizer
    groups, for each freeze flag, on the SDE model with the ImageNet encoder
    and on the PAD model.
(d) The model's train-mode forward under amp (`torch.autocast` on the CPU)
    against the JAX model built with `dtype=jnp.bfloat16`.
(e) One SGD step with the backbone trained (dec6 as published: no
    `freeze_backbone`, the ImageNet encoder, `feat_dist_lambda` 0.01), in
    f32: the gradients of every submodule against JAX's, read from JAX's
    parameters after the step. Most of the encoder's gradient is the
    feature distance's.
(f) The backward under amp: the parameter gradients of a smooth function
    of the train-mode outputs (random projections of the disparities and
    poses, plus the feature distance) against the JAX bf16 model's.

Why (a) holds the parameters two ways. On random weights only ~5% of the
pixels take the reprojection error in the photometric min (the rest take
the identity error, which has no gradient), and ~500 of 32,768 pixels per
scale have their two smallest candidates within 1e-6: f32 op order flips
the choice at 19-41 pixels per scale, so the port on 1 and on 6 CPU threads
gives gradients up to 1.4% of each tensor's largest apart, and the port and
JAX up to 2-4%. Adam normalizes each element, so an element whose gradient
lies inside that noise takes a step of about lr in either direction. (a)
therefore holds every parameter and running statistic to 3.4 lr, the most
two Adam steps in opposite directions can differ by here (|step| <= lr at
t = 1, <= 1.4 lr / 2 at t = 2 with the halved lr), and at least 98% of the
elements of each tensor to 1e-5 (one element of a 64-element tensor may lie
beyond it); (b) holds the optimizer's arithmetic on equal gradients to
1e-7. Measured on 2 threads: every element within 2.9e-5, at most one of
64 (1.6%) beyond 1e-5, the losses within 8e-6 relative.

Tolerances: (a) losses rtol 1e-4 (f32 on the CPU, op-order rounding),
parameters and running statistics as just said; the frozen encoder's and
the ImageNet encoder's parameters bit-identical to their start, on both
sides. (b) 1e-7 plus two f32 units of the parameter (rtol 2.4e-7): the
steps are ~1e-4 and the two sides round them in another order.
(d) The two bf16 models are held by their distance from the f32 model (the
port's f32 forward, equal to JAX's to 2e-5, tests/test_torch_port_models.py):
the port's bf16 outputs and running statistics may lie at most twice as far
from it as JAX's bf16 ones, and the port's must differ from it (bf16 is on).
A tolerance set from bf16 alone (2% of each output's largest magnitude,
five units of 2^-8) did not hold: JAX's own bf16 model lies 0.9-8.1% of
each output's largest magnitude from its f32 model (disp_3 the furthest),
the port's 1.1-5.5%, and the two 1.0-11.8% from each other. Measured
ratios of the port's distance to JAX's: 0.68-1.63. The f32 points (the
disparity's sigmoid, the pose mean, the geometry, BatchNorm statistics)
are asserted by dtype.
(e) losses rtol 1e-4; gradients per submodule within 1e-2 (encoder, depth)
and 2e-2 (pose encoder, pose decoder) of JAX's in L2 norm: the photometric
min's near-ties (as in (a)) move f32 gradients by that much. Measured:
encoder 3.6e-5, depth 1.7e-3, pose encoder 9.2e-3, pose 8.6e-3; from
another seed (weights and batch 40) the encoder 4.4e-3, the pose 9.0e-3.
Without the feature distance the port's encoder gradient lies 1.0 of the
norm from JAX's, so the bound sees the feature distance's gradient.
(f) The gradient is of a smooth function, so that no discrete choice
flips between the two bf16 models; bf16 noise is still large on random
weights (each model's bf16 gradient lies 10-40% of the f32 gradient's norm
from it). Per submodule, the port's bf16 gradient lies at most 1.5 times
as far from the port's f32 gradient as JAX's bf16 gradient does, and at
most twice as far from JAX's bf16 gradient (two independent noises of
equal size lie sqrt(2) apart). Measured ratios 0.99-1.29 and 1.06-1.47. A
backward that drops BatchNorm's gradient through the batch statistics
under bf16 fails by 10x, one that scales each BatchNorm's input gradient by
0.9 fails the first bound at 1.98 (the encoder).
"""

import collections
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from improving_segmentation_with_selfsupervised_depth_tpu.engine.optim import (
    build_param_labels,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.state import TrainState
from improving_segmentation_with_selfsupervised_depth_tpu.engine.train_steps import (
    StepConfig as JaxStepConfig,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.train_steps import (
    make_train_step,
)
from improving_segmentation_with_selfsupervised_depth_tpu.models import build_model
from improving_segmentation_with_selfsupervised_depth_tpu.ops import resample as jax_resample
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic import (
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.interop import (
    state_dict_from_jax,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.optim import (
    FROZEN,
    build_optimizer,
    param_labels,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.train_steps import (
    StepConfig,
    train_step,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    build_model as build_port_model,
)

from tests.test_torch_port_exp210 import few_torch_threads  # noqa: F401  (fixture)
from tests.test_torch_port_models import TINY_CFG, calibrate_running_stats, no_flax_dropout
from tests.test_torch_port_step212 import PAD_CFG

N, H, W = 4, 64, 128
# the dec5/dec6 model at resnet18 width: no segmentation head, the ImageNet
# encoder (dilated like the backbone), the backbone frozen
SDE_CFG = dict(TINY_CFG, segmentation_name=None, segmentation_args=None,
               enable_imnet_encoder=True, freeze_backbone=True, freeze_segmentation=True)
LR = 1e-5
TRAINING = {"optimizer": {"name": "adam", "lr": LR, "pose_lr": LR / 2, "weight_decay": 1e-2},
            "lr_schedule": {"name": "multi_step", "milestones": [1], "gamma": 0.5}}
STEP = dict(monodepth_lambda=1.0, feat_dist_lambda=0.01, segmentation_lambda=0.0,
            frame_ids=(0, -1, 1), scales=(0, 1, 2, 3), photometric_dtype=None)
METRICS = ("total_loss", "mono_loss", "feat_dist_loss", "mono_total_loss")


def sde_weights(model_cfg, batch, seed):
    """(port model, JAX variables) with the same weights and statistics: the
    port's initialisation from `seed`, depth decoder kernels halved, running
    statistics from `batch` (the ImageNet encoder's on its own, as it runs
    in eval mode), dropout off."""
    torch.manual_seed(seed)
    port = build_port_model(model_cfg, n_classes=19)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.startswith("models.depth.") and p.dim() == 4:
                p.mul_(0.5)
    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    tb = to_device_batch(batch, "cpu")
    calibrate_running_stats(port, tb)
    calibrate_running_stats(port.models["imnet_encoder"], tb["color_aug_0_0"])
    params, stats = jax.tree_util.tree_map(np.array,
                                           convert_full_model(port.state_dict(), model_cfg))
    return port, {"params": params, "batch_stats": stats}


def _noise(rng, step):
    """The JAX step's tie-break draw at `step` (train_steps.py:234-235,
    photometric.py:200-202), NCHW."""
    k_mono = jax.random.split(jax.random.fold_in(rng, step), 8)[1]
    z = jax.random.normal(jax.random.split(k_mono)[1], (N, H, W, 2))
    return torch.from_numpy(np.asarray(z).transpose(0, 3, 1, 2).copy())


@pytest.fixture(scope="module")
def two_steps():
    """Two JAX steps from the conditioned weights: (port model, batches,
    noises, JAX metrics per step, variables before, state after)."""
    batches = [make_synthetic_batch(N, H, W, frame_ids=(0, -1, 1), num_scales=4, seed=s)
               for s in (40, 41)]
    port, variables = sde_weights(SDE_CFG, batches[0], seed=40)
    model = build_model(SDE_CFG, n_classes=19)
    tx = jax_build_optimizer(TRAINING, SDE_CFG, variables["params"])
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    rng = jax.random.PRNGKey(5)
    saved = dict(jax_resample._WARP_CONFIG)
    jax_resample.configure_warp("xla")  # the JAX package's full-f32 warp
    try:
        with fnn.intercept_methods(no_flax_dropout):
            step = jax.jit(make_train_step(model, JaxStepConfig(**STEP), tx))
            metrics = []
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, None, rng)
                metrics.append({k: float(m[k]) for k in METRICS})
    finally:
        jax_resample._WARP_CONFIG.update(saved)
    return (port, batches, [_noise(rng, i) for i in range(2)], metrics, variables,
            jax.tree_util.tree_map(np.asarray, state))


def test_two_adam_steps_with_frozen_backbone_and_feat_dist_match_jax(two_steps):
    port, batches, noises, ref, variables, new_state = two_steps
    start = {k: v.clone() for k, v in port.state_dict().items()}
    opt = build_optimizer(TRAINING, SDE_CFG, port)
    for i, (b, noise) in enumerate(zip(batches, noises)):
        got = train_step(port, opt, to_device_batch(b, "cpu"), StepConfig(**STEP),
                         tie_break_noise=noise)
        for k in METRICS:
            np.testing.assert_allclose(float(got[k]), ref[i][k], rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
        assert ref[i]["feat_dist_loss"] > 0 and float(got["segmentation_loss"]) == 0.0
    assert ref[0]["feat_dist_loss"] != ref[1]["feat_dist_loss"]

    want = state_dict_from_jax(new_state.params, new_state.batch_stats, SDE_CFG)
    init = state_dict_from_jax(variables["params"], variables["batch_stats"], SDE_CFG)
    assert set(want) == set(port.state_dict())
    params = dict(port.named_parameters())
    moved = 0
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        moved += int(not torch.equal(want[k], init[k]))
        err = (v - want[k]).abs()
        assert float(err.max()) <= 3.4 * LR, (k, float(err.max()))
        beyond = float((err > 1e-5).float().mean())
        assert beyond <= 0.02, (k, beyond)
    assert moved > len(want) // 3

    # frozen: the encoder's parameters and the whole ImageNet encoder stay
    # bit for bit, in the port and in JAX; the encoder's running statistics
    # move (freeze_backbone is not freeze_backbone_bn)
    for k, v in port.state_dict().items():
        top = k.split(".")[1]
        if top == "imnet_encoder" or (top == "encoder" and k in params):
            assert torch.equal(v, start[k]) and torch.equal(want[k], init[k]), k
        if top == "encoder" and k.endswith("running_mean"):
            assert not torch.equal(v, start[k]) and not torch.equal(want[k], init[k]), k
    assert not any(p.requires_grad for n, p in params.items()
                   if n.startswith(("models.encoder.", "models.imnet_encoder.")))
    assert sum(len(g["params"]) for g in opt.groups) == sum(
        p.requires_grad for p in params.values())


SGD_TRAINING = {"optimizer": {"name": "sgd", "lr": 1e3}}


def test_sgd_step_with_trained_backbone_and_feat_dist_matches_jax():
    """dec6 as published trains the backbone under the feature distance.
    One SGD step (no momentum, no weight decay) of the port against JAX's
    `make_train_step`: the gradients, read from JAX's parameters as
    (before - after) / lr, per submodule."""
    cfg = dict(SDE_CFG, freeze_backbone=False)
    batch = make_synthetic_batch(N, H, W, frame_ids=(0, -1, 1), num_scales=4, seed=42)
    port, variables = sde_weights(cfg, batch, seed=42)
    model = build_model(cfg, n_classes=19)
    tx = jax_build_optimizer(SGD_TRAINING, cfg, variables["params"])
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    rng = jax.random.PRNGKey(6)
    saved = dict(jax_resample._WARP_CONFIG)
    jax_resample.configure_warp("xla")
    try:
        with fnn.intercept_methods(no_flax_dropout):
            new_state, ref = jax.jit(make_train_step(model, JaxStepConfig(**STEP), tx))(
                state, {k: jnp.asarray(v) for k, v in batch.items()}, None, rng)
    finally:
        jax_resample._WARP_CONFIG.update(saved)
    before = state_dict_from_jax(variables["params"], variables["batch_stats"], cfg)
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_state.params),
                                variables["batch_stats"], cfg)
    lr = SGD_TRAINING["optimizer"]["lr"]

    grads = {}
    for feat_dist in (STEP["feat_dist_lambda"], 0.0):
        model_copy = copy.deepcopy(port)
        opt = build_optimizer(SGD_TRAINING, cfg, model_copy)
        got = train_step(model_copy, opt, to_device_batch(batch, "cpu"),
                         StepConfig(**dict(STEP, feat_dist_lambda=feat_dist)),
                         tie_break_noise=_noise(rng, 0))
        grads[feat_dist] = {k: p.grad.double() for k, p in model_copy.named_parameters()
                            if p.grad is not None}
        if feat_dist:
            for k in METRICS:
                np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    with_fd, without_fd = grads[STEP["feat_dist_lambda"]], grads[0.0]
    assert not any(k.startswith("models.imnet_encoder.") for k in with_fd)
    for top, rtol in (("encoder", 1e-2), ("depth", 1e-2), ("pose_encoder", 2e-2),
                      ("pose", 2e-2)):
        keys = [k for k in with_fd if k.split(".")[1] == top]
        want = torch.cat([((before[k] - after[k]).double() / lr).flatten() for k in keys])
        err = float((torch.cat([with_fd[k].flatten() for k in keys]) - want).norm())
        off = float((torch.cat([without_fd[k].flatten() for k in keys]) - want).norm())
        print(f"{top}: |port - JAX| / |JAX| {err / float(want.norm()):.3e}; without the "
              f"feature distance {off / float(want.norm()):.3e}")
        assert err <= rtol * float(want.norm()), top
        if top == "encoder":  # the feature distance's gradient is most of it
            assert off >= 0.5 * float(want.norm())


@pytest.fixture(scope="module")
def models():
    """One port model of each base (SDE with the ImageNet encoder, PAD with
    it), built once: the freeze flags and optimizers below do not change
    what is built. Tests take copies or restore `requires_grad`."""
    built = {}
    for base, cfg in (("sde", SDE_CFG), ("pad", dict(PAD_CFG, enable_imnet_encoder=True))):
        torch.manual_seed(1)
        built[base] = build_port_model(cfg, n_classes=19)
    return built


OPTIMIZERS = {
    # weight decay 1e-4: wd * p stays well below the gradients, so that no
    # decayed gradient comes near 0
    "adam_sde": ("sde", SDE_CFG, dict(TRAINING, optimizer=dict(TRAINING["optimizer"], lr=1e-4,
                                                        weight_decay=1e-4))),
    "adam_pad_masked_clip": (
        "pad", dict(PAD_CFG, enable_imnet_encoder=True, freeze_depth=True),
        {"optimizer": {"name": "adam", "lr": 1e-4, "segmentation_lr": 3e-4, "betas": [0.8, 0.99],
                       "eps": 1e-6}, "clip_grad_norm": 1.0, "disable_depth_grad_clip": True}),
    "sgd_sde": ("sde", dict(SDE_CFG, freeze_backbone=False, freeze_pose=True),
                {"optimizer": {"name": "sgd", "lr": 1e-2, "momentum": 0.9, "depth_lr": 1e-3,
                               "weight_decay": 1e-4},
                 "lr_schedule": {"name": "step_lr", "step_size": 2, "gamma": 0.5}}),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_the_optax_chain_on_equal_gradients(models, name):
    base, model_cfg, training = OPTIMIZERS[name]
    port = copy.deepcopy(models[base])
    opt = build_optimizer(training, model_cfg, port)
    # copies: the converter's arrays share memory with the port's tensors
    jparams = jax.tree_util.tree_map(lambda x: jnp.array(np.array(x)),
                                     convert_full_model(port.state_dict(), model_cfg)[0])
    tx = jax_build_optimizer(training, model_cfg, jparams)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(2)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    for _ in range(3):
        # gradients of every parameter (JAX gets the frozen ones' too), of
        # 5e-4 to 1.5e-3 in size: away from 0, where Adam divides a rounding
        # error by itself
        grads = {k: torch.from_numpy(np.float32(1e-3) * rng.uniform(0.5, 1.5, v.shape).astype(
            np.float32) * np.sign(rng.uniform(-1, 1, v.shape)).astype(np.float32))
            if v.is_floating_point() else v for k, v in port.state_dict().items()}
        for k, p in port.named_parameters():
            p.grad = grads[k].clone() if p.requires_grad else None
        opt.step()
        jgrads, _ = convert_full_model(grads, model_cfg)
        updates, opt_state = update(jax.tree_util.tree_map(jnp.asarray, jgrads), opt_state,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               convert_full_model(port.state_dict(), model_cfg)[1], model_cfg)
    labels = param_labels(port, model_cfg)
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=2.4e-7,
                                   atol=1e-7, err_msg=k)
        assert torch.equal(p, start[k]) == (labels[k] == FROZEN), k


FLAGS = [None, "freeze_backbone", "freeze_depth", "freeze_pose", "freeze_segmentation"]


@pytest.mark.parametrize("base", ["sde", "pad"])
@pytest.mark.parametrize("flag", FLAGS, ids=[str(f) for f in FLAGS])
def test_param_labels_match_build_param_labels(models, base, flag):
    cfg = dict(SDE_CFG if base == "sde" else dict(PAD_CFG, enable_imnet_encoder=True),
               freeze_backbone=False, freeze_segmentation=False)
    if flag:
        cfg[flag] = True
    port = models[base]
    params, _ = convert_full_model(port.state_dict(), cfg)
    jax_labels = build_param_labels(params, cfg)

    def where(top, second):
        return (top, second if top == "mtl_decoder" else None)

    want = collections.defaultdict(collections.Counter)
    for path, label in jax.tree_util.tree_flatten_with_path(jax_labels)[0]:
        keys = [p.key for p in path]
        want[where(keys[0], keys[1])][label] += 1
    got = collections.defaultdict(collections.Counter)
    for name, label in param_labels(port, cfg).items():
        parts = name.split(".")
        got[where(parts[1], parts[2])][label] += 1
    assert got == want
    assert sum(c[FROZEN] for c in got.values()) > 0  # the ImageNet encoder at least

    opt = build_optimizer({"optimizer": {"name": "adam", "lr": 1e-3, "depth_lr": 1e-4}},
                          cfg, port)
    labels = param_labels(port, cfg)
    in_groups = {id(p): g["label"] for g in opt.groups for p in g["params"]}
    for name, p in port.named_parameters():
        assert p.requires_grad == (labels[name] != FROZEN), name
        assert in_groups.get(id(p), FROZEN) == labels[name], name
        p.requires_grad_(True)
    assert {g["label"]: g["lr"] for g in opt.groups}.get("depth", 1e-4) == 1e-4


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


AMP_CFG = dict(SDE_CFG, freeze_backbone=False)
# the smooth scalar whose gradient (f) compares: random projections of the
# disparities and poses plus the feature distance
FEAT_DIST = 0.01


def _outputs_loss(outputs, projections, lib):
    """sum_k mean(out_k * R_k) + FEAT_DIST * ||enc - imnet||_2, in f32; `lib`
    is torch or jnp, the disparities NCHW (torch) or NHWC (JAX)."""
    f32 = (lambda t: t.float()) if lib is torch else (lambda t: t.astype(jnp.float32))
    total = 0.0
    for k, r in projections.items():
        if lib is not torch and k.startswith("disp_"):
            r = r.transpose(0, 2, 3, 1)
        total = total + lib.mean(f32(outputs[k]) * (torch.from_numpy(r) if lib is torch else r))
    d = f32(outputs["encoder_features"]) - f32(outputs["imnet_features"])
    return total + FEAT_DIST * lib.sqrt(lib.sum(d * d))


@pytest.fixture(scope="module")
def amp_reference():
    """The JAX model built with `dtype=jnp.bfloat16`, in train mode, from the
    conditioned weights: its outputs, its updated running statistics, and its
    parameter gradients of `_outputs_loss`, from one jitted program. Returns
    (port model, batch, projections, outputs, statistics, gradients), the last
    two in the port's layout."""
    batch = make_synthetic_batch(N, H, W, frame_ids=(0, -1, 1), num_scales=4, seed=50)
    port, variables = sde_weights(AMP_CFG, batch, seed=50)
    with torch.no_grad():
        shapes = {k: tuple(v.shape) for k, v in port(to_device_batch(batch, "cpu")).items()}
    rng = np.random.default_rng(51)
    projections = {k: rng.standard_normal(shapes[k]).astype(np.float32) for k in sorted(shapes)
                   if k.startswith(("disp_", "axisangle_", "translation_"))}
    model = build_model(AMP_CFG, n_classes=19, dtype=jnp.bfloat16)

    def loss(params, batch):
        out, mutated = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   batch, train=True, mutable=["batch_stats"])
        return _outputs_loss(out, projections, jnp), (out, mutated)

    with fnn.intercept_methods(no_flax_dropout):
        (_, (ref, mutated)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    stats = state_dict_from_jax(variables["params"], jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"]), AMP_CFG)
    grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                                variables["batch_stats"], AMP_CFG)
    return port, batch, projections, ref, stats, grads


def test_amp_forward_matches_jax_bfloat16(amp_reference):
    port, batch, _, ref, jax_stats, _ = amp_reference
    # the port in bf16 (amp) and in f32, train mode, from the same start
    runs = {}
    for amp in (True, False):
        model_copy = copy.deepcopy(port)
        model_copy.amp = amp
        model_copy.train()
        with torch.no_grad():
            runs[amp] = (model_copy(to_device_batch(batch, "cpu")), model_copy.state_dict())
    (got, stats), (f32, f32_stats) = runs[True], runs[False]

    keys = [k for k in ref if k.startswith(("disp_", "axisangle_", "translation_"))]
    keys.append("encoder_features")
    assert len(keys) == 4 + 2 + 2 + 1
    for k in keys:
        want_dtype = torch.bfloat16 if k == "encoder_features" else torch.float32
        assert got[k].dtype == want_dtype and str(ref[k].dtype) == str(want_dtype)[6:], k

        def arr(t):
            return _nhwc(t) if k.startswith(("disp_", "encoder_")) else t.float().numpy()

        exact = arr(f32[k])
        port_err = np.abs(arr(got[k]) - exact).max()
        jax_err = np.abs(np.asarray(ref[k], np.float32) - exact).max()
        print(f"{k}: max |bf16 - f32| port {port_err:.3e}, JAX {jax_err:.3e}, "
              f"of max |f32| {np.abs(exact).max():.3e}")
        assert 0 < port_err <= 2 * jax_err, k
    assert got["cam_T_cam_0_1"].dtype == torch.float32
    for k, v in stats.items():
        if "running" in k:
            assert v.dtype == torch.float32, k
            port_err = float((v - f32_stats[k]).abs().max())
            jax_err = float((jax_stats[k] - f32_stats[k]).abs().max())
            assert port_err <= 2 * jax_err + 1e-6, (k, port_err, jax_err)


def test_amp_backward_matches_jax_bfloat16(amp_reference):
    """The parameter gradients of a smooth function of the train-mode
    outputs (no photometric min, whose near-ties flip under bf16 rounding),
    the port under amp against the JAX bf16 model, per submodule."""
    port, batch, projections, _, _, jax_grads = amp_reference
    grads = {}
    for amp in (True, False):
        model_copy = copy.deepcopy(port)
        model_copy.amp = amp
        model_copy.train()
        _outputs_loss(model_copy(to_device_batch(batch, "cpu")), projections, torch).backward()
        grads[amp] = {k: p.grad.double() for k, p in model_copy.named_parameters()
                      if p.grad is not None}
    assert set(grads[True]) == set(grads[False])
    assert not any(k.startswith("models.imnet_encoder.") for k in grads[True])
    for top in ("encoder", "depth", "pose_encoder", "pose"):
        keys = [k for k in grads[True] if k.split(".")[1] == top]

        def flat(g):
            return torch.cat([g[k].double().flatten() for k in keys])  # noqa: B023

        bf16, f32, ref = flat(grads[True]), flat(grads[False]), flat(jax_grads)
        noise = float((ref - f32).norm())  # JAX's bf16 gradient from the f32 one
        port_off, apart = float((bf16 - f32).norm()), float((bf16 - ref).norm())
        print(f"{top}: |bf16 - f32| / |f32| port {port_off / float(f32.norm()):.3e}, JAX "
              f"{noise / float(f32.norm()):.3e}; |port - JAX| {apart / float(f32.norm()):.3e}")
        assert 0 < port_off <= 1.5 * noise and apart <= 2 * noise, top


def test_bf16_ssim_with_a_zero_denominator_stays_finite():
    """A 3x3 window of a bf16 photometric chain (taken from a small amp step
    on the CPU) where two variance sums round to exactly -C2: the map
    takes the clip's bound there, with finite values and gradients, and the
    rest of the map is the plain formula's."""
    x = [[0.333984375] * 3, [0.333984375, 0.333984375, 0.37890625], [0.333984375] * 3]
    y = [[0.07470703125] * 3, [0.05517578125] * 3, [0.05517578125] * 3]
    xt = torch.tensor([[x]], dtype=torch.bfloat16, requires_grad=True)
    yt = torch.tensor([[y]], dtype=torch.bfloat16)
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import image

    out = image.ssim_nchw(xt, yt)
    out.float().sum().backward()
    assert float(out[0, 0, 1, 1]) == 0.0 == float(out[0, 0, 1, 2])  # positive numerators
    assert torch.isfinite(out.float()).all() and torch.isfinite(xt.grad.float()).all()
    # elsewhere the map is the formula itself, in bf16
    pad = lambda t: torch.nn.functional.pad(t.detach(), (1, 1, 1, 1), mode="reflect")  # noqa: E731
    pool = lambda t: torch.nn.functional.avg_pool2d(t, 3, stride=1)  # noqa: E731
    xp, yp = pad(xt), pad(yt)
    mx, my = pool(xp), pool(yp)
    sx, sy, sxy = pool(xp * xp) - mx * mx, pool(yp * yp) - my * my, pool(xp * yp) - mx * my
    n = (2 * mx * my + image.SSIM_C1) * (2 * sxy + image.SSIM_C2)
    d = (mx * mx + my * my + image.SSIM_C1) * (sx + sy + image.SSIM_C2)
    assert int((d == 0).sum()) == 2 and float(d[0, 0, 1, 1]) == 0.0 == float(d[0, 0, 1, 2])
    plain = ((1.0 - n / d) * 0.5).clamp(0.0, 1.0)
    assert torch.equal(out.detach()[d != 0], plain[d != 0])
