"""Data-parallel training and validation of the port at world size 2 against
one process on the whole batch (against the JAX package's step on a
2-device data mesh: tests/test_torch_port_parallel_jax.py).

Two ranks run on the CPU over gloo (`parallel/launch.py::launch`, two
intra-op threads each; the entry points are `parallel/compare.py`'s). One
launch runs every world-size-2 case (module fixture `dp`); the one-process
references run in this process, except validation's, which rank 0 also runs
alone (`dist.local_only`) so that both see the same synthetic items.

Cases:
- the loader: each rank's rows of each global batch, put together, are the
  single-process batch, and a ragged validation batch is padded as the JAX
  trainer pads it (`_pad_val_batch`);
- the launcher: JAX's rule for the GPU count, a launch asking for more GPUs
  than are visible or with a failing rank raises, and under torchrun's
  environment `train_main` joins its group;
- cross-replica BatchNorm: output, input gradient, parameter gradients and
  running statistics of two train-mode passes within 1e-5; on channels
  whose mean is a thousand times their spread (as the ASPP pooling
  branch's), the variance within 1e-6 relative, the output within 2e-4
  (the f32 resolution of x - mean there) and the input gradient within
  2e-6;
- the steps at resnet18, 64x64, global batch 4 (+ 4), two SGD steps of the
  exp-212 optimizer at a thousandth of its rates (`TRAINING_DP`), dropout on:
  segmentation alone, sde, s212 (PAD, EMA teacher, online DepthMix, fused
  K2/K3 error), s212 with `model.remat`, and s210 (offline DepthMix). The
  losses within 1e-5 relative, parameters and BatchNorm buffers within 1e-5
  (and 1e-5 relative), EMA parameters within 1e-5, both ranks' states equal,
  and the last step's gradients (DDP's average of the ranks' backward of the
  global loss) within 1e-2 of one process's in norm: the steps' discrete
  decisions flip near ties under op-order rounding (measured 3e-4 to 2e-3;
  a gradient of W times or 1/W of the global loss's is off by 50% or more).
  Every case's gradient norm exceeds the clip (10), so the global clip
  acts, and it acts on DDP's averaged gradients (`engine/optim.py`
  unchanged);
- `Run.validate` on a ragged validation set (7 items in batches of 4): the
  same confusion matrix, mIoU and loss means (rtol 1e-5);
- a checkpoint written by two ranks has the single-process keys, and one
  process resumes it bit for bit;
- cross-replica BatchNorm on an f64 input keeps f64: output, gradients and
  running statistics within 1e-12 of one process's;
- label selection's loop (`label_selection_loop`) on the JAX package's
  synthetic config of `tests/test_torch_port_label_selection.py` (64x96,
  resnet18, rounds of 2 and 4 samples, one SGD step each at `TRAINING_DP`'s
  rates, IFP on the pseudo-depth features biased by the student's depth
  errors, as exp-211's bias weight 1000), its rounds trained over the two
  ranks, against rank 0 alone (`dist.local_only`, the same synthetic
  items), every run in f64 (`compare._float64_runs`: the f32 initial
  weights and the batches cast): the same selections, the second round's
  scores (depth errors of a student one step from the seed) within
  `LS_SCORE_RTOL`, and each round's SGD momentum (its gradient) read back
  from its checkpoint within `LS_MOMENT_RTOL` in norm; with a fault planted
  (every rank training on rank 0's rows) the first round's momentum lies
  beyond it; no kernel launched; rank 0 wrote the subset files and removed
  the models. The synthetic items are seeded from string hashes, and each
  launch draws its ranks' PYTHONHASHSEED anew, so every run checks other
  items (a failure names its hash seed). In f32 a ReLU input within the
  rounding of the two sides' BatchNorm statistics (~1e-6) takes the other
  branch on one side: on 2 of 30 hash seeds one such element carried enough
  gradient to move round 2's moments by 2.3-2.6e-2; in f64 that rounding is
  1e-16;
- `label_selection_main` launches the loop on one rank per GPU where JAX's
  rule gives more than one.
"""

import copy
import os

import numpy as np
import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu.engine.trainer import (
    _pad_val_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.loader import DataLoader
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.trainer import build_run
from improving_segmentation_with_selfsupervised_depth_tpu_torch.parallel import compare
from improving_segmentation_with_selfsupervised_depth_tpu_torch.parallel import launch as launch_mod
from improving_segmentation_with_selfsupervised_depth_tpu_torch.parallel.launch import launch

from tests.test_experiments_cli import _synth_base
from tests.test_torch_port_exp210 import S210, SEG_CFG
from tests.test_torch_port_models import TINY_CFG
from tests.test_torch_port_step import _tiny_train_cfg
from tests.test_torch_port_semi import PAD_CFG
from tests.test_torch_port_step212 import S212, TRAINING_212

WORLD = 2
SDE = dict(monodepth_lambda=1.0, segmentation_lambda=1.0, frame_ids=(0, -1, 1),
           scales=(0, 1, 2, 3), photometric_dtype=None)
# the exp-212 optimizer at a thousandth of its rates: the steps take
# discrete decisions (the photometric minimum, the teacher's argmax and its
# 0.968 confidence count, max-pooling ties of the blocky synthetic frames)
# that op-order rounding flips near ties on random weights; at the full rates
# such a flip in the first step moved the second step's losses by up to 3e-4
TRAINING_DP = {**TRAINING_212, "optimizer": {
    k: v * 1e-3 if k.endswith("lr") else v for k, v in TRAINING_212["optimizer"].items()}}
STEP_CASES = {
    "seg": (TINY_CFG, dict(SDE, monodepth_lambda=0.0), False),
    "sde": (TINY_CFG, SDE, False),
    "s212": (PAD_CFG, dict(S212, fused_pred_loss=True), True),
    "s212_remat": (dict(PAD_CFG, remat=True), dict(S212, fused_pred_loss=True), True),
    "s210": (SEG_CFG, S210, True),
}
# label selection's scores at world size 2 against one process. The round
# trains one SGD step at TRAINING_DP's rates, the steps' above, which hold
# parameters within 1e-5 of one process; a score, the mean log-depth error
# of a student one such step from the seed, is held at ten times that
# (measured in f32: at most 1.1e-6 over three item seeds; in f64 equal). At
# the config's own rates a discrete flip (a max-pooling tie of the blocky
# synthetic frames) moved the gradient by up to 1e-2 (the steps' bound) and
# the scores by 2.9e-3 under SGD at lr 1e-2; Adam's first step, lr *
# sign(g), turns such flips into full steps
LS_SCORE_RTOL = 1e-4
# each round's momentum (one step: its gradient plus the weight decay) at
# world size 2 against one process, in norm: the steps' gradient bound
# (measured in f64 below 1e-13 on every hash seed tried; in f32 1e-5 to
# 8e-5 where no ReLU flips, 2.6e-2 where one did; every rank training on
# rank 0's rows: 1.6-3.1). Unlike the scores it does not shrink with the
# rates
LS_MOMENT_RTOL = 1e-2


def _ls_cfg(tmp):
    cfg = _synth_base(tmp / "ls")
    cfg["name"] = "ls"
    cfg["data"]["n_workers"] = 1
    cfg["training"]["optimizer"] = dict(TRAINING_DP["optimizer"])
    cfg["label_selection"]["bias_weight"] = 1000
    return cfg


def _step_spec(model_cfg, step, semi):
    batches = [(dict(batch_size=4, h=64, w=64, seed=10 + i),
                dict(batch_size=4, h=64, w=64, seed=20 + i, with_unlabeled_extras=True)
                if semi else None) for i in range(2)]
    return {"model_cfg": model_cfg, "training": TRAINING_DP, "step": step, "seed": 3,
            "batches": batches}


def _val_cfg(tmp, name):
    """The packaged exp-212 config shrunk: 7 synthetic items, validated in
    batches of 4 (the last one ragged: 3 rows, padded to 4 over 2 ranks)."""
    cfg = _tiny_train_cfg("exp212_pad_online_synthetic.yml", log_path=os.path.join(tmp, name))
    cfg["monodepth_options"].update(height=64, width=64)
    cfg["data"].update(n_samples=7, n_workers=1)
    cfg["training"].update(batch_size=4, val_batch_size=4, n_tensorboard_imgs=6)
    return cfg


def _train_cfg(tmp, name):
    cfg = _val_cfg(tmp, name)
    cfg["training"].update(val_interval=2, save_model=True, async_checkpoints=False)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every world-size-2 case in one launch: {case: rank 0's result} and
    the ranks' step results for the cross-rank checks."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    g = torch.Generator().manual_seed(0)
    # channels with a mean near its spread, and ones with a mean a thousand
    # times their spread (the ASPP pooling branch's: one value per sample)
    x = torch.randn((4, 6, 5, 7), generator=g) * 3 + 2
    x[:, 3:] = torch.randn((4, 3, 1, 1), generator=g) * 0.01 + 10
    bn_args = (x, torch.randn((4, 6, 5, 7), generator=g), torch.rand(6, generator=g) + 0.5,
               torch.randn(6, generator=g))
    calls = [("batchnorm", bn_args), ("batchnorm", tuple(a.double() for a in bn_args)),
             ("validate", (_val_cfg(tmp, "val"),)), ("train", (_train_cfg(tmp, "w2"),))]
    calls += [("run_steps", (_step_spec(*case),)) for case in STEP_CASES.values()]
    calls.append(("label_selection", (_ls_cfg(tmp_path_factory.mktemp("ls")), "float64")))
    ranks = launch(compare.run_all, (calls,), world=WORLD, devices=["cpu"] * WORLD, threads=2)
    names = ["batchnorm", "batchnorm64", "validate", "train", *STEP_CASES, "label_selection"]
    return {"tmp": tmp, "bn_args": bn_args,
            "results": [dict(zip(names, r)) for r in ranks]}


def test_loader_rows_are_the_single_process_batch():
    class Items:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return {"idx": np.array(i), "lbl": np.full((2, 3), i)}

    for shuffle, drop_last in ((True, True), (False, False)):
        one = list(DataLoader(Items(), 4, shuffle=shuffle, drop_last=drop_last, num_workers=1,
                              shard=(0, 1)))
        ranks = [list(DataLoader(Items(), 4, shuffle=shuffle, drop_last=drop_last,
                                 num_workers=1, shard=(r, WORLD))) for r in range(WORLD)]
        assert len(one) == len(ranks[0]) == len(ranks[1]) == (1 if drop_last else 2)
        for b, whole in enumerate(one):
            n = len(whole["idx"])
            want = whole if n % WORLD == 0 else _pad_val_batch(whole, n + WORLD - n % WORLD)
            for k in ("idx", "lbl"):
                got = np.concatenate([r[b][k] for r in ranks])
                assert np.array_equal(got, want[k]), (shuffle, b, k)
            assert all(r[b].get("n_real") == (None if n % WORLD == 0 else n) for r in ranks)
    assert [int(i) for i in one[1]["idx"]] == [4, 5, 6]  # the ragged batch


def test_the_jax_rule_picks_the_gpus(monkeypatch):
    """One process per GPU exactly where the JAX trainer builds its mesh:
    more than one device, and the batch divides over them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, batch, want in ((4, 8, 4), (4, 6, 1), (1, 8, 1), (2, 4, 2), (8, 4, 1)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert launch_mod.gpus_for(batch, "cuda:0") == want, (count, batch)
        assert launch_mod.gpus_for(batch, "cpu") == 1


def test_launch_raises_for_missing_gpus_and_failing_ranks():
    with pytest.raises(RuntimeError, match="2 GPUs asked for"):
        launch(compare.run_all, ([],), world=2)
    with pytest.raises(Exception, match="no_such_check"):
        launch(compare.run_all, ([("no_such_check", ())],), world=WORLD,
               devices=["cpu"] * WORLD, threads=1)


def test_train_main_joins_torchruns_group(monkeypatch):
    """Under torchrun (its environment set) the CLIs' `train_main` joins the
    group as its rank (here a group of one), runs the trainer on the rank's
    device and leaves the group."""
    import socket

    from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import trainer
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.parallel import dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    seen = []

    def rank_main(cfg, device, run_id):
        seen.append((torch.distributed.is_initialized(), dist.world(), device, run_id))
        return ["records"]

    monkeypatch.setattr(trainer, "train_main", rank_main)
    assert launch_mod.train_main({"training": {"batch_size": 4}}, device="cpu",
                                 run_id="r") == ["records"]
    assert seen == [(True, 1, "cpu", "r")]
    assert not torch.distributed.is_initialized()


def test_batchnorm_cross_replica_matches_one_process(dp):
    got = dp["results"][0]["batchnorm"]
    want = compare.batchnorm("cpu", *dp["bn_args"])
    near, far = slice(0, 3), slice(3, 6)
    for k, v in want.items():
        if k in ("y", "x_grad"):
            np.testing.assert_allclose(got[k][:, near].numpy(), v[:, near].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)
    assert float(want["x_grad"].abs().max()) > 1e-3
    # channels whose mean is a thousand times their spread: the variance
    # itself (a combination of f32 means loses it to rounding), and the
    # output at the f32 resolution of x - mean there (1 ulp of 10 over 0.01)
    np.testing.assert_allclose(got["running_var"][far].numpy(),
                               want["running_var"][far].numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["y"][:, far].numpy(), want["y"][:, far].numpy(), atol=2e-4)
    np.testing.assert_allclose(got["x_grad"][:, far].numpy(), want["x_grad"][:, far].numpy(),
                               atol=2e-6)
    assert float(want["y"][:, far].abs().max()) > 0.5


def test_batchnorm_cross_replica_keeps_float64(dp):
    """An f64 input's statistics, output and gradients stay in f64 over the
    ranks: within 1e-12 of one process's, where f32 would leave 1e-7."""
    got = dp["results"][0]["batchnorm64"]
    want = compare.batchnorm("cpu", *(a.double() for a in dp["bn_args"]))
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float64, k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-12, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_at_world_2_match_one_process(dp, case):
    want = compare.run_steps("cpu", _step_spec(*STEP_CASES[case]))
    ranks = [r[case] for r in dp["results"]]
    got = ranks[0]
    for step, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    assert want["losses"][-1]["total_loss"] > 0
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
        assert torch.equal(ranks[1]["state"][k], got["state"][k]), k  # the ranks agree
    for k, v in want.get("teacher", {}).items():
        np.testing.assert_allclose(got["teacher"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    # the last step's gradients: DDP's average of the ranks' backward of the
    # global loss against one process's gradient of it
    # (the parameters the step leaves unused take zero gradients under DDP)
    assert set(want["grads"]) <= set(got["grads"])
    assert all(not got["grads"][k].any() for k in set(got["grads"]) - set(want["grads"]))
    names = sorted(want["grads"])
    g1 = torch.cat([want["grads"][k].flatten() for k in names]).double()
    g2 = torch.cat([got["grads"][k].flatten() for k in names]).double()
    assert float((g2 - g1).norm() / g1.norm()) <= 1e-2
    assert abs(float(g2.norm() / g1.norm()) - 1) <= 1e-2
    # the global clip acted on the step, after DDP's all-reduce: on the
    # averaged gradient, equal on every rank (else the states above differ)
    assert float(g1.norm()) > TRAINING_DP["clip_grad_norm"]


def test_validate_at_world_2_matches_one_process(dp):
    res = dp["results"][0]["validate"]
    (got, got_conf), (want, want_conf) = res["world"], res["one"]
    assert np.array_equal(got_conf, want_conf) and want_conf.sum() > 0
    keys = [k for k in want if k != "eval_seconds_per_batch"]
    assert {"Mean IoU", "segmentation_loss", "monodepth_loss"} <= set(keys)
    assert set(keys) == {k for k in got if k != "eval_seconds_per_batch"}
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert want["monodepth_loss"] > 0


def test_checkpoint_from_two_ranks_resumes_in_one_process(dp, tmp_path):
    """The two ranks' run saved its best and last checkpoints after steps 1
    and 2 (rank 0 writing); one process resumes the last one: the same keys
    as its own state (no DDP `module.` prefix), every tensor bit for bit."""
    path = os.path.join(dp["tmp"], "w2", "last_model.pth")
    saved = torch.load(path, weights_only=False)
    assert saved["step"] == 2 and len(dp["results"][0]["train"]) == 2
    assert os.path.isfile(os.path.join(dp["tmp"], "w2", "best_model.pth"))
    cfg = _train_cfg(str(tmp_path), "resumed")
    cfg["training"]["resume"] = path
    run = build_run(cfg, "cpu")
    try:
        assert run.start_iter == 2 and run.optimizer.step_count == 2
        for part, module in (("model", run.model), ("teacher", run.teacher)):
            own = module.state_dict()
            assert list(saved[part]) == list(own)
            assert all(torch.equal(v, saved[part][k]) for k, v in own.items()), part
        fresh = copy.deepcopy(run.optimizer)
        fresh.load_state_dict(saved["optimizer"])
        assert all(torch.equal(a, b) for a, b in zip(run.optimizer.momentum_buffers,
                                                      fresh.momentum_buffers))
        assert any(b.any() for b in run.optimizer.momentum_buffers)
    finally:
        run.close()


def test_label_selection_at_world_2_matches_one_process(dp):
    res = [r["label_selection"] for r in dp["results"]]
    one, world = res[0]["one"], res[0]["world"]
    assert [r["subset"] for r in world] == [r["subset"] for r in one] == [
        r["subset"] for r in res[1]["world"]]
    assert [len(r["subset"]) for r in one] == [2, 4] and set(one[0]["subset"]) < set(
        one[1]["subset"])
    assert one[0]["scores"] is None and res[1]["world"][1]["scores"] == world[1]["scores"]
    (idx, crit), (idx_one, crit_one) = zip(*world[1]["scores"]), zip(*one[1]["scores"])
    assert idx == idx_one and len(idx) == 6  # the unlabeled samples, scored
    seed = f"PYTHONHASHSEED={res[0]['hash_seed']}"
    np.testing.assert_allclose(np.array(crit), np.array(crit_one), rtol=LS_SCORE_RTOL,
                               err_msg=seed)
    assert np.min(crit_one) > 0
    # both rounds' trained models: the momentum of the one step, read back
    assert len(res[0]["moments"]) == 2 and max(res[0]["moments"]) <= LS_MOMENT_RTOL, (
        seed, res[0]["moments"])
    # the planted fault (rank 1 trained on rank 0's rows) is seen
    assert len(res[0]["faulty_moments"]) == 1
    assert res[0]["faulty_moments"][0] > 10 * LS_MOMENT_RTOL, (seed, res[0]["faulty_moments"])
    assert not any(any(v.values()) for v in (res[0]["launches"], res[1]["launches"]))
    base = os.path.dirname(world[0]["model_file"])
    assert sorted(f for f in os.listdir(os.path.dirname(base)) if f.endswith(".json")) == [
        "nlabels2_subset.json", "nlabels4_subset.json"]
    for r in world:  # rank 0 saved each round's model and removed it after
        assert not os.path.exists(r["model_file"]), r["model_file"]


def test_label_selection_main_launches_one_rank_per_gpu(monkeypatch):
    """Where JAX's rule gives W GPUs, `label_selection_main` launches the
    loop (`_loop_rank`) on W ranks and returns rank 0's round records."""
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.label_selection import (
        driver,
    )

    calls = []

    def fake_launch(fn, args, *, world):
        calls.append((fn, args, world))
        return [["rank 0's records"], ["rank 1's records"]]

    monkeypatch.setattr(driver, "gpus_for", lambda batch_size, device: 2)
    monkeypatch.setattr(driver, "launch", fake_launch)
    cfg = {"training": {"batch_size": 4}}
    assert driver.label_selection_main(cfg, device="cuda:0") == ["rank 0's records"]
    assert calls == [(driver._loop_rank, (cfg,), 2)]
