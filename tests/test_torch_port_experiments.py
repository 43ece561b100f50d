"""The port's experiment configs and runners against the JAX package's.

- The stored label selections (`data/preselected_tables/*.json`, byte
  copies of the JAX package's): `preselected_labels` equals the JAX
  function for every stored (dataset, method, seed) at n 25 and 372 (100
  for CamVid).
- `expand_grid` on a nested grid, `generate_experiment_cfgs` for ids 210,
  211 and 212 on `configs/cityscapes_joint.yml` (5 + 3 + 2 trials, dict for
  dict), `load_config` and the `MachineConfig.X` paths under the same
  environment, and the trial YAMLs of `run_experiments(..., dry=True)`
  without the dated `name`: equal to the JAX package's.
- `test_experiments_cli.main` on the CPU: exp-210 trial 1
  (`scratch_classmix`: ClassMix with the mix debug images) and exp-212
  trial 0 (PAD, online DepthMix) run to their end on synthetic data and
  write `class_mix_debug/*.jpg`.

Everything here is numpy and YAML apart from the two smoke runs (the port
alone, resnet18 at 64x96); torch runs on two threads.
"""

import json
import os

import pytest
import torch
import yaml

from improving_segmentation_with_selfsupervised_depth_tpu.cli import (
    run_experiments_cli as jax_runner,
)
from improving_segmentation_with_selfsupervised_depth_tpu.config import (
    MachineConfig,
)
from improving_segmentation_with_selfsupervised_depth_tpu.config import (
    experiments as jax_experiments,
)
from improving_segmentation_with_selfsupervised_depth_tpu.config import grid as jax_grid
from improving_segmentation_with_selfsupervised_depth_tpu.config import loader as jax_loader
from improving_segmentation_with_selfsupervised_depth_tpu.data import (
    preselected as jax_preselected,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.cli import (
    run_experiments_cli,
    test_experiments_cli,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.config import (
    experiments,
    grid,
    load_config,
    machine_paths,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data import preselected

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(ROOT, "configs", "cityscapes_joint.yml")
TABLES = os.path.join(os.path.dirname(preselected.__file__), "preselected_tables")
STORED = [(dataset, method, int(seed))
          for dataset in ("cityscapes", "camvid")
          for method, seeds in json.load(open(os.path.join(TABLES, f"{dataset}.json"))).items()
          for seed in seeds]
N_TRIALS = {210: 5, 211: 3, 212: 2}
MACHINE_ENV = ("SDT_DATA_DIR", "SDT_OUT_DIR", "CITYSCAPES_DIR", "CAMVID_DIR", "MAPILLARY_DIR",
               "SDT_LOG_DIR", "SDT_GEN_DEPTH_DIR", "SDT_MODEL_DIR")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for the port's CPU ops: the test processes share
    the machine's cores, and more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base_cfg():
    with open(CFG_PATH) as fp:
        return yaml.safe_load(fp)


@pytest.fixture
def machine_config_restored():
    """JAX's `MachineConfig` keeps its paths in class attributes: put them
    back after the test."""
    saved = {k: v for k, v in vars(MachineConfig).items() if k.isupper()}
    yield
    for k, v in saved.items():
        setattr(MachineConfig, k, v)


def test_the_stored_tables_are_the_jax_packages():
    for dataset in ("cityscapes", "camvid"):
        jax_path = os.path.join(os.path.dirname(jax_preselected.__file__),
                                "preselected_tables", f"{dataset}.json")
        with open(jax_path, "rb") as a, open(os.path.join(TABLES, f"{dataset}.json"), "rb") as b:
            assert a.read() == b.read(), dataset
    assert len(STORED) == 15  # seeds 42-44: 4 methods for Cityscapes, ds_us for CamVid


@pytest.mark.parametrize("dataset,method,seed", STORED)
def test_preselected_labels_match_jax(dataset, method, seed):
    for n in (25, 372) if dataset == "cityscapes" else (25, 100):
        got = preselected.preselected_labels(seed, n, dataset, method)
        assert got == jax_preselected.preselected_labels(seed, n, dataset, method)
        assert len(got) == n == len(set(got))


def test_expand_grid_matches_jax():
    def nested(g):
        return {"a": g.grid_search([1, 2]), "b": {"c": g.grid_search(["x", "y", "z"]),
                                                  "d": {"e": g.grid_search([None, {"f": 1}])}},
                "g": [1, 2], "h": {"grid_search": [3]}}

    got, want = grid.expand_grid(nested(grid)), jax_grid.expand_grid(nested(jax_grid))
    assert got == want and len(got) == 2 * 3 * 2 * 1
    assert grid.expand_grid({"k": 1}) == jax_grid.expand_grid({"k": 1}) == [{"k": 1}]


@pytest.mark.parametrize("exp_id", [210, 211, 212])
def test_generate_experiment_cfgs_match_jax(base_cfg, exp_id):
    got = experiments.generate_experiment_cfgs(base_cfg, exp_id)
    want = jax_experiments.generate_experiment_cfgs(base_cfg, exp_id)
    assert len(got) == len(want) == N_TRIALS[exp_id]
    for g, w in zip(got, want):
        assert g == w
    if exp_id != 211:
        # the preselected variant holds the stored ds_us selection of table
        # seed 44 (the generator maps its seed 42 to it)
        sel = [c for c in got if c["data"]["restrict_to_subset"]["mode"] == "fixed"]
        assert len(sel) == 1 and sel[0]["data"]["restrict_to_subset"]["subset"] == \
            preselected.preselected_labels(44, 372, "cityscapes", "ds_us")


@pytest.mark.parametrize("env", ["defaults", "set"])
def test_load_config_and_machine_paths_match_jax(env, monkeypatch, tmp_path,
                                                 machine_config_restored):
    for k in MACHINE_ENV:
        monkeypatch.delenv(k, raising=False)
    if env == "set":
        monkeypatch.setenv("SDT_DATA_DIR", str(tmp_path / "data"))
        monkeypatch.setenv("SDT_OUT_DIR", str(tmp_path / "out"))
        monkeypatch.setenv("CAMVID_DIR", str(tmp_path / "camvid"))
        monkeypatch.setenv("SDT_MODEL_DIR", str(tmp_path / "models"))
    got, want = load_config(CFG_PATH), jax_loader.load_config(CFG_PATH)
    assert got == want
    assert got["data"]["path"] == machine_paths()["CITYSCAPES_DIR"]
    MachineConfig("ws")
    for k, v in machine_paths("ws").items():
        assert getattr(MachineConfig, k) == v, k
    with pytest.raises(NotImplementedError):
        machine_paths("cluster")


@pytest.mark.parametrize("exp_id", [210, 211, 212])
def test_run_experiments_dry_writes_the_jax_trial_yamls(base_cfg, exp_id, monkeypatch,
                                                        tmp_path, machine_config_restored):
    out = {}
    for side, run in (("jax", jax_runner.run_experiments),
                      ("port", run_experiments_cli.run_experiments)):
        monkeypatch.setenv("SDT_DISPATCH_DIR", str(tmp_path / side))
        run(base_cfg, exp_id, runs="all", dry=True, config_name="cityscapes_joint")
        (run_dir,) = os.listdir(tmp_path / side)
        assert run_dir.startswith(f"cityscapes_joint_{exp_id}_")
        trials = sorted(os.listdir(tmp_path / side / run_dir))
        out[side] = {}
        for name in trials:
            with open(tmp_path / side / run_dir / name) as fp:
                cfg = yaml.safe_load(fp)
            assert cfg.pop("name").endswith(cfg["general"]["tag"])
            out[side][name] = cfg
    assert out["port"] == out["jax"]
    assert sorted(out["port"]) == [f"trial_{i}.yaml" for i in range(N_TRIALS[exp_id])]
    for cfg in out["port"].values():
        assert cfg["training"]["log_path"] == f"MachineConfig.LOG_DIR/cityscapes_joint_{exp_id}"


def test_parse_runs_matches_jax():
    for arg in ("all", "2", "0,3", "1-4"):
        assert run_experiments_cli.parse_runs(arg) == jax_runner.parse_runs(arg)


@pytest.mark.parametrize("exp_id,trial,variant", [
    (210, 1, "scratch_classmix"), (212, 0, "pad_transfer_dcompgt0030")])
def test_smoke_runner_runs_a_generated_trial_on_the_cpu(exp_id, trial, variant, monkeypatch,
                                                        tmp_path):
    """The JAX smoke budgets at resnet18 and 64x96: train_iters 2 (one step),
    validation after it, print_interval 1, so the step's mix debug images
    are drawn."""
    monkeypatch.setenv("SDT_OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("SDT_DISPATCH_DIR", str(tmp_path / "dispatch"))
    test_experiments_cli.main(["--config", CFG_PATH, "--synthetic", "--strict", "--exps",
                               str(exp_id), "--runs", str(trial), "--device", "cpu"])
    (run_dir,) = os.listdir(tmp_path / "dispatch")
    assert os.listdir(tmp_path / "dispatch" / run_dir) == [f"trial_{trial}.yaml"]
    with open(tmp_path / "dispatch" / run_dir / f"trial_{trial}.yaml") as fp:
        cfg = yaml.safe_load(fp)
    assert cfg["model"]["variant"] == variant
    assert cfg["training"]["unlabeled_segmentation"]["debug_image"] is True
    log_path = tmp_path / "out" / "logs" / f"smoke_{exp_id}"
    with open(log_path / "metrics.jsonl") as fp:
        tags = [json.loads(line)["tag"] for line in fp]
    assert "training/unlabeled_loss" in tags and "val_metrics/Mean IoU :" in tags
    assert sorted(os.listdir(log_path / "class_mix_debug")) == ["1_0_img.jpg", "1_1_img.jpg"]

