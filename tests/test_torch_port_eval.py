"""The port's validation path against the JAX package's.

The metrics (confusion matrix, scores, meters), the depth metrics and the
pose-free depth prediction on inputs made from numpy seeds, the validation
interval, then the eval step against a jitted `make_eval_step` on two small
models (resnet18, 64x128, batch 4; weights as in
tests/test_torch_port_exp210.py):
- the sde model with its pose network: the photometric loss through the
  plain versions of K1 and K2 (`fused_pred=True`). On the CPU the JAX
  package's fused error is its f32 XLA chain (ops/photometric.py:57-60 takes
  the Pallas kernel on a TPU only), and its warp is set to the f32 XLA warp
  (the Pallas one rounds pixels through bf16). The JAX step draws its
  tie-break noise from its key; the port gets the same draw.
- the PAD model without a pose network: the pose-free depth forward
  (`predict_test_disp`) and the depth-test prediction, with a depth teacher
  (the pseudo-depth loss).
Last, `train_main` with `training.val_interval` on the CPU.

Tolerances: the confusion matrices are equal (JAX counts in f32, exact
below 2^24; the port in int64); losses and depth metrics rtol 1e-4 and
`disp_0` atol 1e-4 (f32 on the CPU, op-order rounding through the model);
the pure functions rtol 1e-6.
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
from improving_segmentation_with_selfsupervised_depth_tpu.engine import trainer as jtrainer
from improving_segmentation_with_selfsupervised_depth_tpu.engine.state import TrainState
from improving_segmentation_with_selfsupervised_depth_tpu.engine.train_steps import (
    StepConfig as JaxStepConfig,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.train_steps import (
    make_eval_step,
)
from improving_segmentation_with_selfsupervised_depth_tpu.engine.trainer_depth_eval import (
    eval_depth_metrics as jax_eval_depth_metrics,
)
from improving_segmentation_with_selfsupervised_depth_tpu.models import build_model
from improving_segmentation_with_selfsupervised_depth_tpu.ops import metrics as jmetrics
from improving_segmentation_with_selfsupervised_depth_tpu.ops import photometric as jphotometric
from improving_segmentation_with_selfsupervised_depth_tpu.ops import resample as jax_resample
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic import (
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import trainer
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.train_steps import (
    StepConfig,
    eval_step,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.trainer_depth_eval import (
    eval_depth_metrics,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import metrics, photometric
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import reprojection, warp

from tests.test_torch_port_exp210 import port_and_jax_weights
from tests.test_torch_port_models import TINY_CFG, no_flax_dropout
from tests.test_torch_port_semi import PAD_CFG
from tests.test_torch_port_step import _tiny_train_cfg

N, H, W = 4, 64, 128
SCALES = (0, 1, 2, 3)
DEPTH_RANGE = dict(test_min_depth=0.1, test_max_depth=80.0)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for the port's CPU ops: the test processes share
    the machine's cores, and more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def test_confusion_matrix_and_scores_match_jax():
    rng = np.random.default_rng(0)
    c = 19
    truth = rng.integers(0, c, (3, 40, 56)).astype(np.int32)
    truth[:, :5] = 250                        # ignored
    truth[0, 5:8] = -1                        # outside [0, C): ignored
    truth[truth == 7] = 8                     # a class neither true nor predicted
    pred = rng.integers(-2, c + 3, (3, 40, 56)).astype(np.int32)  # clipped
    pred[pred == 7] = 6
    pred[truth == 3] = 3                      # some agreement
    ref = np.asarray(jmetrics.confusion_matrix(jnp.asarray(truth), jnp.asarray(pred), c))
    got = metrics.confusion_matrix(torch.from_numpy(truth), torch.from_numpy(pred), c)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), ref)
    assert ref.sum() == ((truth >= 0) & (truth < c)).sum()

    ref_scores, ref_iou = jmetrics.scores_from_confusion(ref)
    got_scores, got_iou = metrics.scores_from_confusion(got.numpy())
    assert got_scores.keys() == ref_scores.keys()
    np.testing.assert_allclose(list(got_scores.values()), list(ref_scores.values()), rtol=1e-12)
    np.testing.assert_allclose(list(got_iou.values()), list(ref_iou.values()), rtol=1e-12)
    assert np.isnan(got_iou[7])

    running, ref_running = metrics.RunningScore(c), jmetrics.RunningScore(c)
    for i in range(3):
        running.update(torch.from_numpy(truth[i]), torch.from_numpy(pred[i]))
        ref_running.update(truth[i], pred[i])
    running.update_matrix(got)
    ref_running.update_matrix(ref)
    assert np.array_equal(running.mat, ref_running.mat)
    assert running.get_scores()[0] == ref_running.get_scores()[0]

    meter, ref_meter = metrics.AverageMeterDict(), jmetrics.AverageMeterDict()
    one, ref_one = metrics.AverageMeter(), jmetrics.AverageMeter()
    for i, v in enumerate((0.5, 2.0, torch.tensor(3.25))):
        meter.update({"a": v, "b": i}, n=i + 1)
        ref_meter.update({"a": float(v), "b": i}, n=i + 1)
        one.update(v, n=2)
        ref_one.update(float(v), n=2)
    assert meter.avgs == ref_meter.avgs and one.avg == ref_one.avg and one.val == ref_one.val


def _depths(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 60.0, shape).astype(np.float32)


def test_depth_metrics_match_jax():
    pred, gt = _depths(1, (2, 24, 40, 1)), _depths(2, (2, 24, 40, 1))
    gt[:, :6] = pred[:, :6] * 1.1                 # some pixels within 1.25
    mask = (np.random.default_rng(3).uniform(0, 1, gt.shape) > 0.2).astype(np.float32)
    ref = jphotometric.depth_metrics(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    got = photometric.depth_metrics(_nchw(pred), _nchw(gt), _nchw(mask))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, err_msg=k)
    assert 0 < float(ref["a1"]) < float(ref["a3"]) < 1


def test_generate_depth_test_pred_and_eval_depth_metrics_match_jax():
    rng = np.random.default_rng(4)
    disps = {f"disp_{s}": rng.uniform(0.01, 1, (2, 32 // 2**s, 48 // 2**s, 1))
             .astype(np.float32) for s in SCALES}
    ref = jphotometric.generate_depth_test_pred(
        {k: jnp.asarray(v) for k, v in disps.items()}, scales=SCALES, **DEPTH_RANGE)
    got = photometric.generate_depth_test_pred(
        {k: _nchw(v) for k, v in disps.items()}, scales=SCALES, **DEPTH_RANGE)
    for s in SCALES:
        k = f"depth_0_{s}"
        assert got[k].shape == (2, 1, 32, 48)
        np.testing.assert_allclose(got[k].numpy().transpose(0, 2, 3, 1), np.asarray(ref[k]),
                                   rtol=1e-6, err_msg=k)

    jcfg, cfg = JaxStepConfig(**DEPTH_RANGE), StepConfig(**DEPTH_RANGE)
    depth_gt = _depths(5, (2, 32, 48, 1)) * 2.0     # above test_max_depth somewhere
    depth_gt[:, :4] = 0.0                           # no ground truth there
    pseudo = rng.uniform(0, 1, (2, 32, 48, 1)).astype(np.float32)
    for batch in ({"depth_gt": depth_gt, "pseudo_depth": pseudo}, {"pseudo_depth": pseudo}, {}):
        ref = jax_eval_depth_metrics(jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                     {"disp_0": jnp.asarray(disps["disp_0"])})
        got = eval_depth_metrics(cfg, {k: _nchw(v) for k, v in batch.items()},
                                 {"disp_0": _nchw(disps["disp_0"])})
        assert got.keys() == ref.keys() and (len(got) == 7) == bool(batch)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("interval", [3, {"0": 5, "10": 2, "40": 20}])
def test_current_val_interval_matches_jax(interval):
    cfg = {"training": {"val_interval": interval}}
    for step in (1, 3, 10, 11, 40, 41, 100):
        assert trainer.current_val_interval(cfg, step) == jtrainer.current_val_interval(cfg,
                                                                                       step)


# the sde model with pose; the PAD model without pose, with a depth teacher
EVAL_CASES = {
    "sde_pose": (TINY_CFG, dict(monodepth_lambda=1.0), 40, 0.0),
    "pad_pose_free": (dict(PAD_CFG, disable_pose=True),
                      dict(disable_pose=True, has_depth_teacher=True,
                           pseudo_depth_loss_log=True), 50, 0.5),
}


@pytest.fixture(scope="module")
def jax_eval():
    """Per case: (port model, batch, tie-break noise, JAX metrics, conf, aux)."""
    saved = dict(jax_resample._WARP_CONFIG)
    jax_resample.configure_warp("xla")  # the full-f32 warp
    out = {}
    try:
        for name, (model_cfg, fields, seed, gate_scale) in EVAL_CASES.items():
            batch = make_synthetic_batch(N, H, W, frame_ids=(0, -1, 1), num_scales=4,
                                         seed=seed)
            port, variables = port_and_jax_weights(model_cfg, batch, seed, gate_scale)
            model = build_model(model_cfg, n_classes=19)
            state = TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"], opt_state=())
            rng = jax.random.PRNGKey(0)  # the JAX trainer's validation key
            cfg = JaxStepConfig(**fields, **DEPTH_RANGE)
            with fnn.intercept_methods(no_flax_dropout):
                m, conf, aux = jax.jit(make_eval_step(model, cfg))(
                    state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
            # compute_losses' draw (photometric.py:200-202)
            noise = jax.random.normal(jax.random.split(rng)[1], (N, H, W, 2))
            out[name] = (port, batch, _nchw(noise), {k: float(v) for k, v in m.items()},
                         np.asarray(conf), jax.tree_util.tree_map(np.asarray, aux))
    finally:
        jax_resample._WARP_CONFIG.update(saved)
    return out


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_step_matches_jax(jax_eval, case):
    port, batch, noise, ref, ref_conf, ref_aux = jax_eval[case]
    model_cfg, fields, _, _ = EVAL_CASES[case]
    counts = (warp.warp_bilinear_nchw.launches, reprojection.reprojection_error.launches)
    got, conf, aux = eval_step(port, to_device_batch(batch, "cpu"),
                               StepConfig(**fields, **DEPTH_RANGE), tie_break_noise=noise)
    assert (warp.warp_bilinear_nchw.launches,
            reprojection.reprojection_error.launches) == counts  # CPU: plain versions
    assert not port.training

    assert conf.dtype == torch.int64 and np.array_equal(conf.numpy(), ref_conf)
    assert conf.sum() == (batch["lbl"] != 250).sum()
    assert np.array_equal(aux["pred"].numpy(), ref_aux["pred"])
    assert got.keys() == ref.keys() and len([k for k in ref if k.startswith("depth/")]) == 7
    for k in ref:
        np.testing.assert_allclose(float(got[k]), ref[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(aux["disp_0"].numpy().transpose(0, 2, 3, 1), ref_aux["disp_0"],
                               atol=1e-4)
    if case == "sde_pose":
        assert ref["monodepth_loss"] > 0 and ref["pseudo_depth_loss"] == 0
    else:  # the pose-free path: no photometric loss, the depth teacher's loss
        assert ref["monodepth_loss"] == 0 and ref["pseudo_depth_loss"] > 0
        assert not port.use_pose_net


def test_train_main_validates_at_the_interval_and_the_last_step(tmp_path):
    """The JAX trainer's schedule: train_iters 3 and val_interval 2 run 2
    steps and validate after steps 1 ((1 + 1) % 2 == 0) and 2 (the last)."""
    cfg = _tiny_train_cfg(log_path=tmp_path)
    cfg["training"].update(train_iters=3, val_interval=2, val_batch_size=2)
    cfg["data"]["n_samples"] = 3
    records = trainer.train_main(cfg, device="cpu")
    validated = [i + 1 for i, r in enumerate(records) if "val/Mean IoU" in r]
    assert validated == [1, 2]
    best = -100.0
    for r in records:
        assert all(np.isfinite(v) for v in r.values())
        if "val/Mean IoU" in r:
            assert 0 <= r["val/Mean IoU"] <= 1 and 0 <= r["val/fwAcc"] <= 1
            best = max(best, r["val/Mean IoU"])
            assert r["val/best_iou"] == best
            assert r["val/monodepth_loss"] > 0 and r["val/depth/abs_rel"] > 0
    # the validation set is the same at every validation
    run = trainer.build_run(cfg, device="cpu")
    sets = [[b["lbl"] for b in run.val_batches()] for _ in range(2)]
    run.close()
    assert [len(b) for b in sets[0]] == [2, 1]
    assert all(torch.equal(a, b) for a, b in zip(*sets))
