"""Label selection (exp-211) in the port against the JAX package on the CPU.

(a) The scoring functions on seeded inputs, NCHW in the port and NHWC in
    JAX: the seven depth-error maps, `dilate`, `masked_depth_error`,
    `adaptive_pool` (avg and max, bins that do not divide the input),
    `extract_depth_features` (u3, u4, bn, logdepth, depth),
    `calc_feature_distance` (p 1 and 2, normalized or not, patch-wise or
    not, with and without the score bias) and `pixel_wise_entropy`
    (normalized or not): rtol 1e-5 (both f32), error maps also atol 1e-6
    (a difference of two logs is exact to their f32 units only), distances
    also atol 1e-4 (the p = 2 distance is the same |a|^2 + |b|^2 - 2ab
    expansion on both sides).
(b) `iterative_farthest_point` with and without preselection,
    `choose_samples_from_scores` with one criterion and with several, and
    `choose_initial_samples("random")`: the same indices.
(c) `label_selection_main`'s round structure against JAX's, with
    `train_on_subset` recorded and `acquire_scores` stubbed to the same
    scores and distances on both sides: the same subsets, `train_iters`,
    lambdas, `val_interval`, scoring calls and model continued in every
    round, for the packaged exp-211 config and two other schedules; the
    model files removed. No training.
(d) One set of weights (the port's dec9 model, ResNet-18 stand-in
    backbone, layer-8 head at output stride 2, converted by the JAX
    package's `convert_full_model` and loaded back through
    `state_dict_from_jax`): the port's `acquire_scores` on 4 samples, from a
    checkpoint of that model, against JAX's score step (the JAX model's
    eval forward, `pixel_wise_entropy`, `masked_depth_error` for all seven
    error types) on the batches the port scored: depth errors and entropy
    rtol 1e-4; and the model's train- and eval-mode `disp_0` and
    `semantics` against JAX's on those 4 samples as one batch: rtol 1e-4,
    atol 1e-5 of each output's largest magnitude (op-order rounding through
    ~40 layers; elements near 0 have no relative precision). Dropout is off
    on both sides; the JAX side computes BatchNorm's variance in two passes
    (tests/test_torch_port_exp210.py). One jitted JAX function gives both
    modes' outputs.
(e) The whole loop in the port on the CPU on the JAX package's own
    end-to-end config (tests/test_experiments_cli.py, 64x96): the
    `nlabels2`/`nlabels4` subset files, nested subsets, the models removed.
"""

import copy
import json
import os

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
from improving_segmentation_with_selfsupervised_depth_tpu.label_selection import (
    driver as jax_driver,
)
from improving_segmentation_with_selfsupervised_depth_tpu.label_selection import (
    scoring as jax_scoring,
)
from improving_segmentation_with_selfsupervised_depth_tpu.models import build_model
from improving_segmentation_with_selfsupervised_depth_tpu.ops import losses as jax_losses
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import checkpoints
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.optim import (
    build_optimizer,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.label_selection import (
    driver,
    scoring,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.joint import (
    JointSegmentationDepth,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import losses

from tests.test_experiments_cli import _synth_base
from tests.test_torch_port_exp210 import (  # noqa: F401  (fixture)
    few_torch_threads,
    port_and_jax_weights,
    two_pass_batchnorm_variance,
)
from tests.test_torch_port_models import no_flax_dropout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "improving_segmentation_with_selfsupervised_depth_tpu_torch"
ERROR_TYPES = ["abs", "abs_inv_log", "abs_inv", "sq", "abs_rel", "sq_rel", "abs_log"]


def _nhwc(x):
    return jnp.asarray(np.moveaxis(np.asarray(x), 1, -1))


def _disps(seed, shape=(30, 40)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.005, 1.0, shape).astype(np.float32)
    pseudo = rng.uniform(0.005, 1.0, shape).astype(np.float32)
    pseudo[5:9, 10:14] = 0.03  # a moving car
    return pred, pseudo


@pytest.mark.parametrize("error_type", ERROR_TYPES)
def test_depth_error_maps_and_masked_errors_match_jax(error_type):
    pred, pseudo = _disps(1)
    got = scoring.depth_error_map(torch.from_numpy(pred), torch.from_numpy(pseudo), error_type)
    want = jax_scoring.depth_error_map(jnp.asarray(pred), jnp.asarray(pseudo), error_type)
    # atol: a difference of two logs up to 4.4 in size is exact to their f32 units
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    m, e = scoring.masked_depth_error(torch.from_numpy(pred), torch.from_numpy(pseudo),
                                      error_type)
    wm, we = jax_scoring.masked_depth_error(jnp.asarray(pred), jnp.asarray(pseudo), error_type)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(e), float(we), rtol=1e-5)
    assert float(m[int(0.87 * 30):].abs().sum()) == 0 and float(m[5:9, 10:14].abs().sum()) == 0


def test_dilate_matches_jax():
    mask = (np.random.default_rng(2).uniform(0, 1, (2, 3, 17, 23)) > 0.93).astype(np.float32)
    got = scoring.dilate(torch.from_numpy(mask), 7, 3)
    want = jax_scoring.dilate(jnp.asarray(mask), 7, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("mode", ["avg", "max"])
@pytest.mark.parametrize("out_hw", [(4, 8), (3, 5)])
def test_adaptive_pool_matches_jax(mode, out_hw):
    x = np.random.default_rng(3).normal(0, 1, (2, 3, 13, 22)).astype(np.float32)
    got = scoring.adaptive_pool(torch.from_numpy(x), out_hw, mode)
    want = jax_scoring.adaptive_pool(_nhwc(x), out_hw, mode)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("m", ["u3", "u4", "bn", "logdepth", "depth"])
def test_extract_depth_features_matches_jax(m):
    rng = np.random.default_rng(4)
    outputs = {"upconv_3": rng.normal(0, 1, (2, 8, 9, 14)),
               "upconv_4": rng.normal(0, 1, (2, 16, 5, 7)),
               "bottleneck": rng.normal(0, 1, (2, 32, 5, 7))}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    pseudo = rng.uniform(0.005, 1, (2, 1, 18, 28)).astype(np.float32)
    args = {"m": m, "h": 2, "pool": "avg"}
    got = scoring.extract_depth_features({k: torch.from_numpy(v) for k, v in outputs.items()},
                                         torch.from_numpy(pseudo), args)
    want = jax_scoring.extract_depth_features({k: _nhwc(v) for k, v in outputs.items()},
                                              _nhwc(pseudo), args)
    assert got.shape[2:] == (2, 4)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("patch_wise", [False, True])
@pytest.mark.parametrize("bias_weight", [0, 1000])
def test_feature_distance_matches_jax(p, normalize, patch_wise, bias_weight):
    rng = np.random.default_rng(5)
    feats = (rng.normal(0, 1, (6, 3, 2, 4)) + np.arange(3)[None, :, None, None]).astype(
        np.float32)
    bias = (rng.uniform(0, 0.05, 6) * bias_weight).astype(np.float32)
    args = dict(p=p, normalize_features=normalize, patch_wise=patch_wise)
    got = scoring.calc_feature_distance(torch.from_numpy(feats), bias, bias_weight, **args)
    want = jax_scoring.calc_feature_distance(np.moveaxis(feats, 1, -1), bias, bias_weight,
                                             **args)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert np.all(np.diag(got) == 0) and got.max() > 1


@pytest.mark.parametrize("patch_wise", [False, True])
def test_a_constant_feature_channel_adds_nothing_where_jax_gives_nan(patch_wise):
    """A channel constant over every sample and position (an ELU saturated
    at -1 in a random depth teacher, as the synthetic exp-211 smoke trial's)
    has std 0: JAX's normalization divides 0 by 0 and every distance is
    NaN, so its IFP chooses nothing; the port leaves the channel at 0, which
    gives JAX's distances of the other channels."""
    rng = np.random.default_rng(7)
    feats = rng.normal(0, 1, (6, 4, 2, 4)).astype(np.float32)
    feats[:, 2] = -1.0
    args = dict(p=2, normalize_features=True, patch_wise=patch_wise)
    got = scoring.calc_feature_distance(torch.from_numpy(feats), None, 0, **args)
    nan = jax_scoring.calc_feature_distance(np.moveaxis(feats, 1, -1), None, 0, **args)
    want = jax_scoring.calc_feature_distance(np.moveaxis(feats[:, [0, 1, 3]], 1, -1), None, 0,
                                             **args)
    assert np.isnan(np.asarray(nan)).sum() >= 30  # every off-diagonal distance
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert np.all(np.isfinite(got)) and got.max() > 1


@pytest.mark.parametrize("normalize", [False, True])
def test_pixel_wise_entropy_matches_jax(normalize):
    logits = np.random.default_rng(6).normal(0, 3, (2, 19, 6, 7)).astype(np.float32)
    got = losses.pixel_wise_entropy(torch.from_numpy(logits), normalize=normalize)
    want = jax_losses.pixel_wise_entropy(_nhwc(logits), normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def _distances(n=12, seed=7):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, (n, 3))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    order = rng.permutation(100)[:n].tolist()  # image indices of the rows
    return {"distances": d, "dist_i_to_img_idx": dict(enumerate(order)),
            "img_idx_to_dist_i": {v: i for i, v in enumerate(order)}}, order


@pytest.mark.parametrize("preselected", [False, True])
def test_iterative_farthest_point_matches_jax(preselected):
    dists, order = _distances()
    pres = order[2:9] if preselected else None
    got = scoring.iterative_farthest_point(order[:2], dists, 4, pres)
    want = jax_scoring.iterative_farthest_point(order[:2], dists, 4, pres)
    assert got == want and len(got[0]) == 4
    if preselected:
        assert set(got[0]) <= set(pres)


@pytest.mark.parametrize("n_criteria", [1, 3])
def test_choose_samples_from_scores_matches_jax(n_criteria):
    rng = np.random.default_rng(8)
    scores = [{"idx": int(i), "label_criterion": rng.uniform(0, 1, n_criteria).tolist()}
              for i in rng.permutation(40)[:15]]
    got = driver.choose_samples_from_scores(copy.deepcopy(scores), 6)
    want = jax_driver.choose_samples_from_scores(copy.deepcopy(scores), 6)
    assert got == want and len(set(got[0])) == 6


def test_choose_initial_samples_random_matches_jax():
    cfg = {"seed": 43, "data": {"dataset": "cityscapes"}}
    got = driver.choose_initial_samples(cfg, 25, "random", device="cpu")
    assert got == jax_driver.choose_initial_samples(cfg, 25, "random")
    assert len(set(got)) == 25 and max(got) < 2975


def _packaged_exp211():
    with open(os.path.join(ROOT, PKG, "configs", "exp211_label_selection_synthetic.yml")) as f:
        return yaml.safe_load(f)


def _schedule(variant):
    cfg = _packaged_exp211()
    ls = cfg["label_selection"]
    if variant == "score_continued":
        ls.update(choice="score", entropy_lambda=0.5, train_from_scratch=False,
                  last_from_scratch=False, selection_tasks="seg", label_steps=[4, 8, 12],
                  train_iters=[2, 3, 4], initial_samples="random", bias_weight=0)
    elif variant == "random":
        ls.update(choice="random", depth_lambda=0, entropy_lambda=0, initial_samples="random",
                  bias_weight=0, label_steps=[4, 8], train_iters=[2, 5])
    return cfg


def _recorders(log):
    """Stubs of acquire_scores and train_on_subset that record their calls in
    `log` and answer alike on both sides."""
    rng = np.random.default_rng(9)
    pts = rng.normal(0, 1, (24, 4))
    full = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    crit = rng.uniform(0, 1, 24)

    def acquire_scores(cfg, samples_to_score, all_samples, model_file, depth_ifp_w=0,
                       verbose=False, **_):
        log.append(("acquire", list(samples_to_score), list(all_samples),
                    model_file and os.path.basename(os.path.dirname(model_file)),
                    depth_ifp_w))
        scored = all_samples if depth_ifp_w > 0 else samples_to_score
        scores = [{"idx": int(i), "label_criterion": [float(crit[i])],
                   "depth_error": [float(crit[i])], "entropy_mean": 0.0} for i in scored]
        dists = {"distances": depth_ifp_w * full[np.ix_(all_samples, all_samples)],
                 "dist_i_to_img_idx": dict(enumerate(all_samples)),
                 "img_idx_to_dist_i": {v: i for i, v in enumerate(all_samples)}}
        return scores, dists

    def train_on_subset(cfg, labeled_samples, train_iters, model_file=None, **_):
        t = cfg["training"]
        log.append(("train", list(labeled_samples), int(train_iters),
                    t.get("segmentation_lambda"), t.get("pseudo_depth_lambda"),
                    t.get("monodepth_lambda"), t.get("val_interval"),
                    model_file and os.path.basename(os.path.dirname(model_file))))
        path = os.path.join(cfg["training"]["log_path"], f"nlabels{len(labeled_samples)}",
                            "best_model")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "w").close()
        return path

    return acquire_scores, train_on_subset


@pytest.mark.parametrize("variant", ["exp211", "score_continued", "random"])
def test_round_structure_matches_jax(variant, tmp_path, monkeypatch):
    logs, roots = {}, {}
    for side, mod, main in (("jax", jax_driver, jax_driver.label_selection_main),
                            ("port", driver, lambda c: driver.label_selection_main(c, "cpu"))):
        cfg = _schedule(variant)
        roots[side] = tmp_path / side
        cfg["training"]["log_path"] = str(roots[side])
        logs[side] = []
        acquire, train = _recorders(logs[side])
        monkeypatch.setattr(mod, "acquire_scores", acquire)
        monkeypatch.setattr(mod, "train_on_subset", train)
        main(cfg)
    assert logs["port"] == logs["jax"]
    rounds = [r for r in logs["port"] if r[0] == "train"]
    assert len(rounds) == {"exp211": 2, "score_continued": 3, "random": 1}[variant]
    for a, b in zip(rounds, rounds[1:]):
        assert set(a[1]) < set(b[1])
    leftover = [f for f in (roots["port"]).rglob("best_model")]
    assert not leftover, leftover  # remove_models


# the exp-211 model at test size: dec9 on a dilated ResNet-18, layer-8 head
# at output stride 2 with head_inter, no pose network
DEC9_CFG = {
    "backbone_name": "resnet18",
    "replace_stride_with_dilation": [False, False, True],
    "segmentation_name": "joint_seg_depth_dec",
    "segmentation_args": {"layers": [8], "head_inter": True, "output_stride": 2,
                          "head_dropout": 0.0, "layer_dropout": 0},
    "depth_args": {"intermediate_aspp": True, "aspp_rates": [6, 12, 18],
                   "num_ch_dec": [64, 64, 128, 128, 256], "batch_norm": True,
                   "max_scale_size": [64, 128]},
    "disable_pose": True,
    "disable_monodepth": False,
    "frame_ids": [0],
    "num_scales": 4,
    "backbone_pretraining": "none",
    "depth_pretraining": "none",
}
SCORED = [5, 2, 7, 1]


def _scoring_cfg(log_path):
    cfg = _packaged_exp211()
    cfg["model"] = copy.deepcopy(DEC9_CFG)
    cfg["monodepth_options"] = {"frame_ids": [0], "num_scales": 4, "height": 64, "width": 128}
    cfg["data"].update(n_samples=8, n_workers=1)
    cfg["training"]["log_path"] = str(log_path)
    cfg["label_selection"].update(depth_lambda=1, entropy_lambda=0.5, bias_weight=0,
                                  depth_error_types=ERROR_TYPES)
    return cfg


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """The port's acquire_scores on 4 samples from a checkpoint of the dec9
    model, the batches it scored, and JAX's eval- and train-mode outputs of
    the same weights on those 4 batches as one."""
    tmp = tmp_path_factory.mktemp("scoring")
    calib = make_synthetic_batch(4, 64, 128, frame_ids=(0,), num_scales=4, seed=11)
    port, variables = port_and_jax_weights(DEC9_CFG, calib, seed=11)
    assert any(k.endswith("block.1.running_var") for k in port.state_dict())  # dec9's BN
    opt = build_optimizer({"optimizer": {"name": "adam", "lr": 1e-4}}, DEC9_CFG, port)
    model_file = checkpoints.ResumeWriter().save_resume(str(tmp), port, None, opt, 0.0)[0]

    batches = []
    forward = JointSegmentationDepth.forward

    def spy(self, inputs, use_pose=True):
        batches.append({k: v.clone() for k, v in inputs.items()})
        return forward(self, inputs, use_pose)

    cfg = _scoring_cfg(tmp)
    JointSegmentationDepth.forward = spy
    try:
        scores, _ = driver.acquire_scores(cfg, SCORED, list(range(8)), model_file,
                                          device="cpu")
    finally:
        JointSegmentationDepth.forward = forward
    batch = {k: torch.cat([b[k] for b in batches]) for k in ("color_aug_0_0", "pseudo_depth")}

    model = build_model(DEC9_CFG, n_classes=19)

    def both_modes(variables, image):
        inputs = {"color_aug_0_0": image}
        eval_out = model.apply(variables, inputs, train=False)
        train_out, _ = model.apply(variables, inputs, train=True, mutable=["batch_stats"])
        return eval_out, train_out

    with fnn.intercept_methods(no_flax_dropout), two_pass_batchnorm_variance():
        eval_out, train_out = jax.jit(both_modes)(
            jax.tree_util.tree_map(jnp.asarray, variables), _nhwc(batch["color_aug_0_0"]))
    return port, scores, batch, eval_out, train_out


def test_acquire_scores_matches_the_jax_score_step(scored):
    _, scores, batch, eval_out, _ = scored
    assert [s["idx"] for s in scores] == sorted(SCORED)  # the subset in file order
    ent = jax_losses.pixel_wise_entropy(eval_out["semantics"])
    for i, s in enumerate(scores):
        pseudo = jnp.asarray(batch["pseudo_depth"][i, 0].numpy())
        errs = [float(jax_scoring.masked_depth_error(eval_out["disp_0"][i, :, :, 0], pseudo,
                                                     et)[1]) for et in ERROR_TYPES]
        entropy = float(jnp.mean(ent[i]))
        np.testing.assert_allclose(s["depth_error"], errs, rtol=1e-4)
        np.testing.assert_allclose(s["entropy_mean"], entropy, rtol=1e-4)
        np.testing.assert_allclose(s["label_criterion"], [e + 0.5 * entropy for e in errs],
                                   rtol=1e-4)
        assert 0 < entropy < 1


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dec9_model_matches_jax(scored, train):
    port, _, batch, eval_out, train_out = scored
    model = copy.deepcopy(port).train(train)
    with torch.no_grad():
        got = model({"color_aug_0_0": batch["color_aug_0_0"]})
    want = train_out if train else eval_out
    assert got["semantics"].shape == (4, 19, 64, 128)
    for key in ("disp_0", "semantics"):
        w = np.moveaxis(np.asarray(want[key]), -1, 1)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)


def test_whole_loop_on_the_jax_synthetic_config(tmp_path):
    cfg = _synth_base(tmp_path)
    driver.label_selection_main(cfg, device="cpu")
    base = cfg["training"]["log_path"]  # <log_path>/<name>
    with open(os.path.join(base, "nlabels2_subset.json")) as f:
        first = json.load(f)
    with open(os.path.join(base, "nlabels4_subset.json")) as f:
        second = json.load(f)
    assert len(set(first)) == 2 and len(set(second)) == 4 and set(first) < set(second)
    assert max(second) < 8
    models = [f for _, _, files in os.walk(base) for f in files if f.startswith("best_model.")
              and f.endswith(".pth")]
    assert not models, models
