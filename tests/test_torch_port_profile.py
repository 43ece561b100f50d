"""The run loop's profiler capture (`training.profile_dir`, `engine/trainer.py::
StepCapture`), the JAX trainer's `jax.profiler` window (JAX
`engine/trainer.py:300-317`) on `torch.profiler`.

A tiny synthetic `train_main` run on the CPU (the packaged SDE config at
resnet18, 64x64, batch 2, `train_iters` 5: steps 1 to 4):
- with `profile_start` 2 and `profile_steps` 2 it writes one Chrome trace,
  `trace_rank0_steps2-3.json`, whose JSON holds exactly the step spans
  `step 2` and `step 3`, each holding the step's phase spans
  (`utils/spans.py`), and its losses equal the run without a capture;
- without `profile_dir` no profiler is made, and the run's log path holds
  the files it held before the capture existed;
- a window that the run ends inside (`profile_start` 3, `profile_steps` 5)
  still writes its trace, of steps 3 and 4.
"""

import json
import os
import re

import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.trainer import train_main

from tests.test_torch_port_step import _tiny_train_cfg

LOSSES = ("total_loss", "segmentation_loss", "mono_loss")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(log_path, **capture):
    cfg = _tiny_train_cfg(log_path=log_path)
    cfg["monodepth_options"].update(height=64, width=64)
    cfg["training"].update(train_iters=5, **capture)
    return train_main(cfg, device="cpu")


def _files(path):
    """The file names under `path`, each run of digits (a log's time, an
    events file's time and counter) masked."""
    return sorted(re.sub(r"[0-9]+", "#", f) for f in os.listdir(path))


def _step_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith("step ")]


def _phases_in_steps(path):
    """{step span: the names of the annotations inside it}."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    return {s["name"]: {e["name"] for e in events if e is not s
                        and s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]}
            for s in events if s["name"].startswith("step ")}


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """A run without `profile_dir`, in which making a profiler raises."""
    log_path = tmp_path_factory.mktemp("plain")

    def no_profiler(*args, **kwargs):
        raise AssertionError("a profiler was made without training.profile_dir")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "profile", no_profiler)
        records = _run(log_path)
    return log_path, records


def test_profile_dir_traces_exactly_the_window(plain, tmp_path):
    plain_path, plain_records = plain
    profile_dir = tmp_path / "traces"  # made by the capture
    records = _run(tmp_path / "run", profile_dir=str(profile_dir), profile_start=2,
                   profile_steps=2)
    assert os.listdir(profile_dir) == ["trace_rank0_steps2-3.json"]
    assert _step_spans(profile_dir / "trace_rank0_steps2-3.json") == ["step 2", "step 3"]
    phases = _phases_in_steps(profile_dir / "trace_rank0_steps2-3.json")
    assert sorted(phases) == ["step 2", "step 3"]
    assert all({"train_step", "forward", "backward"} <= names for names in phases.values())
    assert len(records) == len(plain_records) == 4
    for got, want in zip(records, plain_records):
        assert {k: got[k] for k in LOSSES} == {k: want[k] for k in LOSSES}
    # the capture writes nothing into the run's own log path
    assert _files(tmp_path / "run") == _files(plain_path)


def test_no_profile_dir_adds_no_file(plain):
    log_path, records = plain
    assert len(records) == 4 and all(r["total_loss"] > 0 for r in records)
    files = _files(log_path)
    assert "cfg.yml" in files and "metrics.jsonl" in files
    assert not any("trace" in f or f.endswith(".json") for f in files), files


def test_a_window_the_run_ends_inside_writes_its_trace(tmp_path):
    profile_dir = tmp_path / "traces"
    records = _run(tmp_path / "run", profile_dir=str(profile_dir), profile_start=3,
                   profile_steps=5)
    assert len(records) == 4
    assert os.listdir(profile_dir) == ["trace_rank0_steps3-4.json"]
    assert _step_spans(profile_dir / "trace_rank0_steps3-4.json") == ["step 3", "step 4"]
