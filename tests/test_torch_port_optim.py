"""The port's lr schedules, optimizers and resume from the JAX package's
full-state `.msgpack`, against the JAX package on the CPU, on equal
gradients (the gradients are injected, not computed: ROADMAP Queue 1's
recipe).

(a) Every schedule's factor against JAX `build_lr_factor_fn` at steps
    0-12, with and without warmup (linear and constant): rtol 1e-6 (both f32).
(b) Each optimizer the port took in (adamax, adadelta, adagrad with an
    initial accumulator, rmsprop, SGD with nesterov, asgd with and without
    weight decay, asgd over two groups with a schedule) against the optax
    chain of JAX `build_optimizer` on a small parameter tree (four groups of
    two tensors) for 5 steps: parameters rtol 1e-5, and the frozen group
    unmoved; and the optax state tree that a resume expects for each is
    the one JAX builds.
(c) The global clip with a frozen group: the norm the port clips with
    (read back from an SGD update from 0) equals `optax.global_norm` over every
    gradient, the frozen group's included; the frozen parameters keep their
    gradients (`requires_grad`) and do not move.
(d) A JAX `save_resume` file (SGD with momentum and weight decay, and Adam
    with a frozen group under the global clip; each with an EMA tree and an
    lr_scale of 0.5) loads into the port's run of the same model and takes
    one more step on equal gradients: parameters rtol 1e-5, the step, the
    best_iou, the EMA teacher and the BatchNorm statistics as written. A
    tree of another optimizer raises, naming the first path that differs.
(e) `load_model_only`, from the port's `.pth` and from the JAX `.msgpack`,
    loads the model and leaves the optimizer (its buffers and step) as they
    were.
(f) What raised `not_ported` before (adamax, a frozen group under the
    global clip, a `resume` path ending in `.msgpack` where no file is)
    builds its run and takes a step.
No JAX train step: optax's update runs op by op on the small tree, jitted on the
joint model's (d, e).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn
from flax import serialization

from improving_segmentation_with_selfsupervised_depth_tpu.engine.checkpoints import (
    save_resume as jax_save_resume,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.full_model_interop import (
    convert_full_model,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.optim import (
    build_lr_factor_fn as jax_factor_fn,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.optim import (
    build_optimizer as jax_build_optimizer,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.state import TrainState
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import checkpoints
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.interop import (
    state_dict_from_jax,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.optim import (
    build_lr_factor_fn,
    build_optimizer,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.state import make_teacher
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.trainer import build_run
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    build_model as build_port_model,
)

from tests.test_torch_port_exp210 import few_torch_threads  # noqa: F401  (fixture)
from tests.test_torch_port_step import _tiny_train_cfg

SCHEDULES = [
    {"name": "constant_lr"},
    {"name": "poly_lr", "max_iter": 13, "power": 0.9},
    {"name": "poly_lr_2", "max_iter": 13, "power": 0.9},
    {"name": "poly_lr_2", "max_iter": 20, "gamma": 0.5},
    {"name": "step_lr", "step_size": 4, "gamma": 0.5},
    {"name": "multi_step", "milestones": [9, 3], "gamma": 0.3},
    {"name": "cosine_annealing", "T_max": 10, "eta_min": 0.1},
    {"name": "exp_lr", "gamma": 0.8},
    {"name": "reduce_lr_on_plateau"},
]
WARMUPS = [{}, {"warmup_iters": 5}, {"warmup_iters": 4, "warmup_mode": "constant",
                                     "warmup_factor": 0.5}]


@pytest.mark.parametrize("warmup", WARMUPS, ids=["none", "linear", "constant"])
@pytest.mark.parametrize("sched", SCHEDULES,
                         ids=[f"{s['name']}{i}" for i, s in enumerate(SCHEDULES)])
def test_schedule_factors_match_jax(sched, warmup):
    cfg = dict(sched, **warmup)
    port, ref = build_lr_factor_fn(cfg), jax_factor_fn(cfg)
    got = np.array([port(s) for s in range(13)])
    want = np.array([float(ref(s)) for s in range(13)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if warmup:  # the warmup scales the first steps by its factor, and no later one
        cold = build_lr_factor_fn(sched)
        n = warmup["warmup_iters"]
        assert got[0] == pytest.approx(warmup.get("warmup_factor", 0.2) * cold(0), rel=1e-6)
        assert list(got[n:]) == [cold(s) for s in range(n, 13)]


class Tiny(nn.Module):
    """A parameter tree of four groups, two tensors each, in the joint
    model's `models.<group>` layout."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.models = nn.ModuleDict()
        for i, group in enumerate(("encoder", "depth", "segmentation", "pose")):
            m = nn.Module()
            m.w = nn.Parameter(torch.randn((3, 4), generator=gen) + i)
            m.b = nn.Parameter(torch.randn((5,), generator=gen))
            self.models[group] = m


def _jax_tree(named):
    """{group: {leaf: array}} of `models.<group>.<leaf>` tensors, copied (a
    JAX array may share a CPU tensor's memory, which the port updates in
    place)."""
    tree = {}
    for name, v in named:
        _, group, leaf = name.split(".")
        tree.setdefault(group, {})[leaf] = jnp.array(v.detach().numpy().copy())
    return tree


OPTIMIZERS = {
    "adamax": ({"optimizer": {"name": "adamax", "lr": 1e-2, "backbone_lr": 3e-3,
                              "betas": [0.8, 0.99], "weight_decay": 1e-3},
                "lr_schedule": {"name": "poly_lr_2", "max_iter": 8}}, {}),
    "adadelta": ({"optimizer": {"name": "adadelta", "lr": 0.5, "rho": 0.8},
                  "clip_grad_norm": 2.0}, {"freeze_pose": True}),
    "adagrad": ({"optimizer": {"name": "adagrad", "lr": 1e-1,
                               "initial_accumulator_value": 0.1},
                 "lr_schedule": {"name": "exp_lr", "gamma": 0.9}}, {}),
    "rmsprop": ({"optimizer": {"name": "rmsprop", "lr": 1e-2, "alpha": 0.9,
                               "segmentation_lr": 2e-2},
                 "clip_grad_norm": 1.0, "disable_depth_grad_clip": True},
                {"freeze_depth": True}),
    "sgd_nesterov": ({"optimizer": {"name": "sgd", "lr": 1e-1, "momentum": 0.9,
                                    "nesterov": True, "weight_decay": 5e-4},
                      "lr_schedule": {"name": "cosine_annealing", "T_max": 6}}, {}),
    "asgd": ({"optimizer": {"name": "asgd", "lr": 1e-1, "lambd": 1e-2}}, {}),
    "asgd_wd": ({"optimizer": {"name": "asgd", "lr": 1e-1, "weight_decay": 1e-2,
                               "alpha": 0.5}}, {}),
    "asgd_groups_schedule": ({"optimizer": {"name": "asgd", "lr": 1e-1, "backbone_lr": 3e-2,
                                            "pose_lr": 1e-3, "lambd": 0.1},
                              "lr_schedule": {"name": "step_lr", "step_size": 2,
                                              "gamma": 0.5},
                              "clip_grad_norm": 3.0}, {}),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_the_optax_chain_on_equal_gradients(name):
    training, model_cfg = OPTIMIZERS[name]
    port = Tiny()
    start = {k: v.detach().clone() for k, v in port.named_parameters()}
    opt = build_optimizer(training, model_cfg, port)
    jparams = _jax_tree(port.named_parameters())
    tx = jax_build_optimizer(training, model_cfg, jparams)
    state = tx.init(jparams)
    rng = np.random.default_rng(1)
    for _ in range(5):
        grads = {k: torch.from_numpy((rng.uniform(0.2, 1.0, v.shape) * np.sign(
            rng.uniform(-1, 1, v.shape))).astype(np.float32)) for k, v in start.items()}
        for k, p in port.named_parameters():
            p.grad = grads[k].clone() if p.requires_grad else None
        opt.step()
        updates, state = tx.update(_jax_tree(grads.items()), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    frozen = {g for g in ("depth", "pose") if model_cfg.get(f"freeze_{g}")}
    for k, p in port.named_parameters():
        _, group, leaf = k.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[group][leaf]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
        assert torch.equal(p.detach(), start[k]) == (group in frozen), k


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_the_optax_tree_the_resume_expects_is_jaxs(name):
    """The tree `load_resume` holds a JAX file's `opt_state` against is the
    one JAX `build_optimizer` makes, for every optimizer (the resume itself
    is held below for SGD and Adam)."""
    training, model_cfg = OPTIMIZERS[name]
    port = Tiny()
    opt = build_optimizer(training, model_cfg, port)
    jparams = _jax_tree(port.named_parameters())
    want = serialization.to_state_dict(
        jax_build_optimizer(training, model_cfg, jparams).init(jparams))
    params = jax.tree_util.tree_map(np.asarray, jparams)
    got = checkpoints._opt_template(opt, params, checkpoints._jax_labels(params, model_cfg))
    assert got == _shapes(want)


def test_global_clip_counts_the_frozen_groups_gradients():
    training = {"optimizer": {"name": "sgd", "lr": 0.1}, "clip_grad_norm": 1.0}
    model_cfg = {"freeze_backbone": True, "freeze_pose": True}
    port = Tiny()
    with torch.no_grad():  # from 0, an update reads back without cancellation
        for p in port.parameters():
            p.zero_()
    start = {k: v.detach().clone() for k, v in port.named_parameters()}
    opt = build_optimizer(training, model_cfg, port)
    # the frozen groups keep their gradients for the norm, and only then
    assert all(p.requires_grad for p in port.parameters())
    masked = Tiny()
    build_optimizer(dict(training, disable_depth_grad_clip=True), model_cfg, masked)
    assert not any(p.requires_grad for p in masked.models["encoder"].parameters())
    rng = np.random.default_rng(2)
    # the frozen groups' gradients large: most of the norm is theirs
    grads = {k: torch.from_numpy(rng.normal(0, 5.0 if k.split(".")[1] in ("encoder", "pose")
                                            else 0.1, v.shape).astype(np.float32))
             for k, v in start.items()}
    for k, p in port.named_parameters():
        p.grad = grads[k].clone()
    opt.step()
    want = float(optax.global_norm(_jax_tree(grads.items())))
    k = "models.depth.w"
    delta = port.models["depth"].w.detach().norm()
    got = 0.1 * 1.0 * float(grads[k].norm()) / float(delta)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k, p in port.named_parameters():
        assert torch.equal(p.detach(), start[k]) == (k.split(".")[1] in ("encoder", "pose")), k
    opt.zero_grad()
    assert all(p.grad is None for p in port.parameters())

    jparams = _jax_tree(start.items())
    tx = jax_build_optimizer(training, model_cfg, jparams)
    updates, _ = tx.update(_jax_tree(grads.items()), tx.init(jparams), jparams)
    jparams = optax.apply_updates(jparams, updates)
    for k, p in port.named_parameters():
        _, group, leaf = k.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[group][leaf]),
                                   rtol=1e-5, err_msg=k)


# a small joint model: ResNet-18 with a narrow depth decoder and a layer-9 head
RESUME_CFG = {
    "backbone_name": "resnet18",
    "segmentation_name": "joint_seg_depth_dec",
    "segmentation_args": {"layers": [9], "head_dropout": 0.0},
    "depth_args": {"num_ch_dec": [4, 4, 8, 8, 16]},
    "disable_pose": True,
    "frame_ids": [0],
    "num_scales": 1,
}
RESUME = {
    "sgd": ({"optimizer": {"name": "sgd", "lr": 1e-2, "backbone_lr": 1e-3, "momentum": 0.9,
                           "weight_decay": 5e-4},
             "lr_schedule": {"name": "step_lr", "step_size": 1, "gamma": 0.5},
             "clip_grad_norm": 10.0}, RESUME_CFG),
    "adam_frozen_clip": ({"optimizer": {"name": "adam", "lr": 1e-4, "segmentation_lr": 3e-4},
                          "lr_schedule": {"name": "poly_lr_2", "max_iter": 10},
                          "clip_grad_norm": 5.0},
                         dict(RESUME_CFG, freeze_depth=True)),
}


def _grads(model, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.uniform(0.5, 1.5, v.shape) * np.sign(
        rng.uniform(-1, 1, v.shape)) * 1e-2).astype(np.float32))
        for k, v in model.state_dict().items() if v.is_floating_point()}


def _apply(params, updates, scale=1.0):
    """optax.apply_updates in numpy (f32), the update scaled by `scale`."""
    return jax.tree_util.tree_map(
        lambda p, u: np.asarray(p) + np.asarray(u) * np.float32(scale), params, updates)


@pytest.fixture(scope="module")
def joint_models():
    """One port model of each resume config's model, from seed 1; tests
    take copies (building a ResNet-18 takes seconds)."""
    built = {}
    for name, (_, model_cfg) in RESUME.items():
        torch.manual_seed(1)
        built[name] = build_port_model(model_cfg, n_classes=19)
    return built


@pytest.fixture(scope="module")
def jax_files(joint_models, tmp_path_factory):
    """{resume config: `_jax_file`'s result}, made at the first use (each
    jits its optimizer's update once)."""
    made = {}

    def get(name):
        if name not in made:
            training, model_cfg = RESUME[name]
            made[name] = _jax_file(tmp_path_factory.mktemp(name), joint_models[name],
                                   training, model_cfg)
        return made[name]

    return get


def _jax_file(tmp_path, src, training, model_cfg):
    """A JAX `save_resume` file after one step from `src`'s weights: (path,
    JAX state after the step, the jitted `tx.update`). The tree arithmetic
    outside the update is numpy's: JAX op by op compiles for each leaf's
    shape."""
    params, stats = jax.tree_util.tree_map(lambda x: jnp.array(np.array(x)),
                                           convert_full_model(src.state_dict(), model_cfg))
    tx = jax_build_optimizer(training, model_cfg, params)
    jgrads, _ = convert_full_model(_grads(src, 3), model_cfg)
    # one compiled update serves both steps: op by op, each leaf's shape compiles
    update = jax.jit(tx.update)
    updates, opt_state = update(jax.tree_util.tree_map(jnp.asarray, jgrads),
                                tx.init(params), params)
    new = _apply(params, updates)
    ema = jax.tree_util.tree_map(lambda a, b: np.float32(0.5) * (np.asarray(a) + b),
                                 params, new)
    stats = jax.tree_util.tree_map(lambda s: np.asarray(s) + np.float32(0.25), stats)
    state = TrainState(step=jnp.asarray(1, jnp.int32), params=new, batch_stats=stats,
                       opt_state=opt_state, ema_params=ema,
                       lr_scale=jnp.asarray(0.5, jnp.float32))
    path = jax_save_resume(str(tmp_path), state, best_iou=0.375, basename="last_model")
    return path, state, update


def _port_run(base, training, model_cfg, shift=0.0):
    """A copy of `base` (its parameters shifted by `shift`), its teacher and
    its optimizer."""
    model = copy.deepcopy(base)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(shift)
    teacher = make_teacher(model)
    return model, teacher, build_optimizer(training, model_cfg, model)


@pytest.mark.parametrize("name", list(RESUME))
def test_jax_full_state_resumes_and_steps_like_jax(jax_files, joint_models, name):
    training, model_cfg = RESUME[name]
    path, state, update = jax_files(name)
    model, teacher, opt = _port_run(joint_models[name], training, model_cfg, shift=1.0)
    step, best_iou = checkpoints.load_resume(path, model, teacher, opt, model_cfg)
    assert (step, best_iou, opt.step_count, opt.lr_scale) == (1, 0.375, 1, 0.5)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want_model = state_dict_from_jax(np_tree(state.params), np_tree(state.batch_stats),
                                     model_cfg)
    want_teacher = state_dict_from_jax(np_tree(state.ema_params), np_tree(state.batch_stats),
                                       model_cfg)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want_model[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(teacher.state_dict()[k], want_teacher[k], rtol=0, atol=0,
                                   msg=k)

    grads = _grads(model, 4)
    for k, p in model.named_parameters():
        p.grad = grads[k].clone() if p.requires_grad else None
    opt.step()
    jgrads, _ = convert_full_model(grads, model_cfg)
    updates, _ = update(jax.tree_util.tree_map(jnp.asarray, jgrads), state.opt_state,
                        state.params)
    want = state_dict_from_jax(_apply(state.params, updates, state.lr_scale),
                               np_tree(state.batch_stats), model_cfg)
    moved = 0
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
        moved += not torch.equal(p.detach(), want_model[k])
    assert moved > 0

    # the other optimizer's tree names the first path that differs
    other = RESUME["adam_frozen_clip" if name == "sgd" else "sgd"][0]
    model, teacher, opt = _port_run(joint_models[name], other, model_cfg)
    with pytest.raises(ValueError, match="opt_state/"):
        checkpoints.load_resume(path, model, teacher, opt, model_cfg)


def test_load_model_only_leaves_the_optimizer(tmp_path, jax_files, joint_models):
    training, model_cfg = RESUME["sgd"]
    base = joint_models["sgd"]
    path, state, _ = jax_files("sgd")
    model, teacher, opt = _port_run(base, training, model_cfg, shift=1.0)
    for k, p in model.named_parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    before = copy.deepcopy(opt.state_dict())
    teacher_before = copy.deepcopy(teacher.state_dict())

    def unchanged():
        after = opt.state_dict()
        assert (after["step_count"], after["lr_scale"]) == (1, 1.0)
        assert set(after["state"]) == set(before["state"])
        for k, bufs in before["state"].items():
            assert torch.equal(after["state"][k]["momentum"], bufs["momentum"]), k
        for k, v in teacher.state_dict().items():
            assert torch.equal(v, teacher_before[k]), k

    step, best_iou = checkpoints.load_resume(path, model, teacher, opt, model_cfg,
                                             load_model_only=True)
    assert (step, best_iou) == (1, 0.375)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                               jax.tree_util.tree_map(np.asarray, state.batch_stats),
                               model_cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    unchanged()

    # the port's own file: a run at step 0 saved, loaded model-only
    src, src_teacher, src_opt = _port_run(base, training, model_cfg, shift=2.0)
    pth = checkpoints.ResumeWriter().save_resume(str(tmp_path / "port"), src, src_teacher,
                                                 src_opt, 0.5)[0]
    assert checkpoints.load_resume(pth, model, teacher, opt, model_cfg,
                                   load_model_only=True) == (0, 0.5)
    for k, v in model.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    unchanged()


@pytest.mark.parametrize("section,key,value", [
    ("training", "optimizer", {"name": "adamax", "lr": 1e-3}),
    ("model", "freeze_pose", True),  # with the config's clip_grad_norm
    ("training", "resume", "best_model.msgpack"),  # a path where no file is
])
def test_what_raised_before_the_schedules_and_optimizers_runs(section, key, value, tmp_path):
    """The packaged SDE config (shrunk) with what raised `not_ported` before
    the schedules, the optimizers and the JAX resume were ported: its run
    builds and takes a step."""
    cfg = _tiny_train_cfg(log_path=tmp_path)
    cfg[section][key] = value
    run = build_run(cfg, device="cpu")
    try:
        losses = run.step(*run.device_batches())
    finally:
        run.close()
    assert run.optimizer.step_count == 1
    assert all(np.isfinite(float(v)) for v in losses.values())
