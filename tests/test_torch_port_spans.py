"""The phase spans of the port's train step (`utils/spans.py`,
`engine/train_steps.py::train_step`), on the tiny configurations of
`tests/test_torch_port_step.py::_tiny_train_cfg` (resnet18, 32x64, batch 2):
- with nothing collecting, `span()` is one shared no-op, and the collectors
  leave no warning filter, `showwarning` or `gc.callbacks` entry behind;
- a collection inside `gc_spans()` is a `gc` span;
- the SDE step's and the exp-212 step's spans come in the step's order,
  all inside one `train_step` span and well nested, and a step taken under
  a collector computes bit for bit what its twin computes without one.
"""

import copy
import gc
import warnings

import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import train_steps
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.trainer import build_run
from improving_segmentation_with_selfsupervised_depth_tpu_torch.utils import spans

from tests.test_torch_port_step import _tiny_train_cfg

SDE = ["train_step", "forward", "photometric", "backward", "optimizer"]
EXP212 = ["train_step", "teacher", "forward", "photometric", "forward", "photometric", "mix",
          "forward", "backward", "optimizer", "ema"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_span_is_the_shared_no_op_and_the_collectors_restore_what_they_change(monkeypatch):
    """On a stand-in CUDA device whose sync debug mode is a variable: each
    sync warning inside `collect(syncs=True)` is counted and not shown,
    another warning is shown, and the mode is set back."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters, shown, callbacks = list(warnings.filters), warnings.showwarning, list(gc.callbacks)
    assert spans.span("forward") is spans.span("backward")
    with warnings.catch_warnings(record=True) as heard:
        with spans.collect(syncs=True) as c, spans.gc_spans(), spans.annotated():
            with spans.span("outer"):
                with spans.span("inner"):
                    for _ in range(2):
                        warnings.warn(spans.SYNC_WARNING + " (Triggered internally)")
            warnings.warn("another warning")
            assert spans.span("a") is not spans.span("a")
    assert [name for name, _, _ in c.spans] == ["inner", "outer"]
    (_, a, b), = [s for s in c.spans if s[0] == "inner"]
    assert len(c.syncs) == 2 and all(a <= t <= b for t, _ in c.syncs)
    assert all(site.startswith(__file__) for _, site in c.syncs)
    assert [str(w.message) for w in heard] == ["another warning"] and modes == [0, "warn", 0]
    assert spans.span("forward") is spans.span("backward")
    assert warnings.filters == filters and warnings.showwarning is shown
    assert gc.callbacks == callbacks


def test_a_collection_inside_gc_spans_is_a_gc_span():
    with spans.gc_spans() as found:
        gc.collect()
    assert len(found) >= 1 and all(name == "gc" and 0 < a <= b for name, a, b in found)


def _step(run, model, optimizer, teacher, batch, unlabeled):
    torch.manual_seed(5)  # the ASPP's dropout draws from the default generator
    return train_steps.train_step(model, optimizer, batch, run.step_cfg,
                                  generator=torch.Generator().manual_seed(3),
                                  unlabeled_batch=unlabeled, teacher=teacher)


@pytest.mark.parametrize("config,expect,twin", [
    ("sde_supervised_synthetic.yml", SDE, False),
    ("exp212_pad_online_synthetic.yml", EXP212, True),
])
def test_the_steps_spans_in_order_nested_and_free(config, expect, twin, tmp_path):
    run = build_run(_tiny_train_cfg(config, log_path=tmp_path), "cpu")
    try:
        batch, unlabeled = run.device_batches()
        if twin:
            model, optimizer, teacher = copy.deepcopy((run.model, run.optimizer, run.teacher))
            plain = _step(run, model, optimizer, teacher, batch, unlabeled)
        with spans.collect() as c:
            got = _step(run, run.model, run.optimizer, run.teacher, batch, unlabeled)
    finally:
        run.close()
    found = sorted(c.spans, key=lambda s: (s[1], -s[2]))
    assert [name for name, _, _ in found] == expect
    (_, lo, hi), inner = found[0], found[1:]
    assert all(lo <= a <= b <= hi for _, a, b in inner)
    # the phases are siblings: each ends before the next starts
    assert all(b1 <= a2 for (_, _, b1), (_, a2, _) in zip(inner, inner[1:]))
    if twin:
        assert got.keys() == plain.keys()
        assert all(torch.equal(got[k], plain[k]) for k in got)
        assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                     run.model.parameters()))
