"""A run with the timed path broken underneath comes out not correct: the
harness's run (`harness/cell.py::run_cell`) driven on the CPU at a tiny
size, past its look for a card, once sound and once for each fault a
training cell can have: a step that returns its state unchanged, and half
of the batch left out (the means taken over the rest). One chip: no
exchange between chips to leave out."""

import time

import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import (
    train_steps,
    trainer,
)
from port_bench.harness.cell import run_cell
from port_bench.tests._tiny import tiny_cell

CELLS = ["exp212_pad_online.b4", "sde_dec6_crop_amp.b4"]


def _run(name, seed=7):
    torch.set_num_threads(4)
    return run_cell(tiny_cell(name), seed, 0.5, False, "cpu", time.time(), log=lambda s: None)


def _break(monkeypatch, broken):
    real = train_steps.train_step

    def step(*args, **kwargs):
        return broken(real, *args, **kwargs)

    monkeypatch.setattr(train_steps, "train_step", step)
    monkeypatch.setattr(trainer, "train_step", step)


def _failed(result):
    return {k for k, c in result["checks"].items() if c["value"] is None or c["value"] > c["limit"]}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"samples_per_s", "setup_s"} | (
        {"step_ms_p90"} if result["attempted"] >= 2 else set())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(name, monkeypatch):
    def unchanged(real, model, optimizer, *args, **kwargs):
        student = getattr(model, "module", model)
        teacher = kwargs.get("teacher")
        saved = [p.detach().clone() for p in student.parameters()]
        saved_t = [p.detach().clone() for p in teacher.parameters()] if teacher else []
        buffers = {k: dict(v) for k, v in optimizer.buffers.items()}
        count = optimizer.step_count
        record = real(model, optimizer, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(student.parameters(), saved):
                p.copy_(s)
            for p, s in zip(teacher.parameters() if teacher else [], saved_t):
                p.copy_(s)
        optimizer.buffers = buffers
        optimizer.step_count = count
        return record

    _break(monkeypatch, unchanged)
    result = _run(name)
    assert not result["correct"]
    assert "change_gap_median" in _failed(result)


def _half(batch):
    return None if batch is None else {k: v[: v.shape[0] // 2] for k, v in batch.items()}


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_batch_left_out_is_not_correct(name, monkeypatch):
    import dataclasses

    def half(real, model, optimizer, batch, cfg, generator=None, tie_break_noise=None, *,
             unlabeled_batch=None, teacher=None, draws=train_steps.StepDraws()):
        if tie_break_noise is not None:
            tie_break_noise = tie_break_noise[: tie_break_noise.shape[0] // 2]
        cut = {f.name: getattr(draws, f.name)[: getattr(draws, f.name).shape[0] // 2]
               for f in dataclasses.fields(draws)
               if isinstance(getattr(draws, f.name), torch.Tensor)
               and getattr(draws, f.name).dim() > 0}
        return real(model, optimizer, _half(batch), cfg, generator, tie_break_noise,
                    unlabeled_batch=_half(unlabeled_batch), teacher=teacher,
                    draws=dataclasses.replace(draws, **cut))

    _break(monkeypatch, half)
    result = _run(name)
    assert not result["correct"]
    assert {"loss_gap"} <= _failed(result)
