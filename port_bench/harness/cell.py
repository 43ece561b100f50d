"""One run of one training cell, from set-up to the result's line.

1. Set-up. The port's trainer builds the run from the cell's configuration
   (`engine/trainer.py::build_run`; its loaders are built over a few
   synthetic items, closed, and never read). The weights are made on the
   device from the seed (`weights.py`) and loaded into the student and the
   EMA teacher; the ring of host batches is made (`traffic.py`). The run
   then takes the checked steps: the trainer's step function
   (`engine/train_steps.py::train_step`, which `Run.step` calls) on the
   run's model, optimizer and teacher, fed from the ring through
   `Run.to_device`, with the step's draws injected, the default generator
   seeded (the ASPP dropout draws from it) and the readings of
   `compare.py` taken after the first and the last. One `Run.step` more
   warms the window's own path. The same run object goes on into the
   window.
2. The window: `Run.step` on the ring's batches, each copied by
   `Run.to_device` from pinned host memory, for `--seconds` seconds of host
   time, with nothing synchronised per step; a CUDA event after each step;
   the losses read back at the configuration's `print_interval`, as the
   trainer does. The window runs from the first step's feed to the
   synchronise after the last step.
3. With `--trace 1`, a few steps more under `torch.profiler` (CUDA activity
   only; `trace.py`).
4. The program's state is freed, the peak memory having been read; the
   plain reference (`reference/steps.py`) follows the checked steps from the
   same weights, batches and draws, and `compare.py` decides `correct`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..reference.steps import STATED, build_reference_model, run_reference
from . import compare, trace as tracing
from .flops import step_flops
from .manifest import Cell, load_reader
from .traffic import make_ring, step_draws, step_kind
from .weights import load_weights, make_weights, parameter_spec

FORBIDDEN = ("jax", "jaxlib", "flax", "improving_segmentation_with_selfsupervised_depth_tpu")
PROFILED_STEPS = 3
# the published dense peaks of one H100 SXM (operations/s; bytes/s)
H100_PEAKS = {"tf32": 495e12, "bf16": 989e12, "fp32": 67e12, "hbm_bytes_per_s": 3.35e12}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Window:
    steps: int
    seconds: float               # wall time, first feed to the synchronise after the last step
    intervals_ms: List[float]    # between consecutive step ends (device clock on a card)
    dispatch_s: List[float]      # host time of each Run.step call
    batch: int                   # training rows a step
    losses: List[float]


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    cell: Cell
    window: Window
    setup_s: float
    window_peak_bytes: int
    trace: Optional[tracing.Trace]
    peaks: Optional[Dict[str, float]]
    _flops: Optional[int] = None

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell.config["config"]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic

    @property
    def precision(self) -> str:
        return self.cell.config["precision"]

    def step_flops(self) -> int:
        if self._flops is None:
            self._flops = step_flops(self.config, self.traffic)
        return self._flops


def _port():
    """The port's trainer and step: imported here, so that a checkout without
    the port fails at the run and not at import."""
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import (
        train_steps,
        trainer,
    )

    return trainer, train_steps


def card_power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30).stdout.split("\n")[0]
        return float(out)
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


class _Clock:
    """Step ends on the device clock (CUDA events) on a card, on the host
    clock (after the step, which the CPU runs synchronously) otherwise."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: List[Any] = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _losses(record: Dict[str, Any]) -> Dict[str, Any]:
    """The step's record without its debug tensors (the trainer reads those
    only where it draws them)."""
    return {k: v for k, v in record.items() if not k.startswith("debug/")}


def _read_back(pending: List[Dict[str, Any]]) -> None:
    """The trainer's print interval: every pending loss to the host."""
    for record in pending:
        for k, v in record.items():
            if isinstance(v, torch.Tensor):
                record[k] = float(v)


def _checked_steps(run, train_steps, ring, draws, weights, device) -> compare.Readings:
    losses, grads, first = [], {}, {}
    for k, d in enumerate(draws):
        torch.manual_seed(d["default_seed"])
        generator = torch.Generator(device=device).manual_seed(d["generator_seed"])
        batch = run.to_device(ring[k]["labeled"])
        unlabeled = (run.to_device(ring[k]["unlabeled"])
                     if ring[k]["unlabeled"] is not None else None)
        model = run.ddp if run.ddp is not None else run.model
        record = train_steps.train_step(
            model, run.optimizer, batch, run.step_cfg, generator=generator,
            tie_break_noise=d["tie_break_noise"], unlabeled_batch=unlabeled,
            teacher=run.teacher, draws=train_steps.StepDraws(**d["draws"]))
        losses.append(record["total_loss"])
        if k == 0:
            grads = compare.first_gradients(run.optimizer, weights)
            first = compare.components(record)
    changes = compare.change_norms(run.optimizer, weights)
    return compare.Readings([float(x) for x in losses], first, grads, compare.norms(grads),
                            changes)


@contextlib.contextmanager
def scratch_dir():
    """A temporary directory for the run's log path, with the port's data,
    model and output directories pointed into it; removed at the end."""
    scratch = tempfile.mkdtemp(prefix="port_bench_")
    saved = {var: os.environ.get(var) for var in _PORT_DIRS}
    for var in _PORT_DIRS:
        os.environ[var] = os.path.join(scratch, var.lower())
    try:
        yield scratch
    finally:
        for var, value in saved.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value
        shutil.rmtree(scratch, ignore_errors=True)


_PORT_DIRS = ("SDT_OUT_DIR", "SDT_DATA_DIR", "SDT_MODEL_DIR")


def run_config(cell: Cell, seed: int) -> Dict[str, Any]:
    """The cell's configuration with the run's seed."""
    raw = copy.deepcopy(cell.config["config"])
    raw["seed"] = seed % 2**31
    return raw


@dataclasses.dataclass
class Program:
    """The port's run after the checked steps, and what the reference needs
    to follow them."""

    run: Any
    ring: List[Dict[str, Any]]
    draws: List[Dict[str, Any]]
    spec: List[Any]
    readings: compare.Readings


def set_up(cell: Cell, seed: int, device: str, scratch: str,
           log: Callable[[str], None] = lambda s: None) -> Program:
    """Build the port's run, load the seed's weights, make the ring and take
    the checked steps (the module docstring, 1); `log` hears each part's
    host time."""
    t0 = time.perf_counter()

    def done(part: str) -> None:
        nonlocal t0
        _sync(device)
        log(f"set-up: {part} {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()

    trainer, train_steps = _port()
    done("the port's import")
    raw = run_config(cell, seed)
    cfg = copy.deepcopy(raw)
    cfg["training"]["log_path"] = os.path.join(scratch, "log")
    run = trainer.build_run(cfg, device)
    run.close()  # the loaders are never read: the ring feeds the step
    done("build_run")
    spec = parameter_spec(build_reference_model(raw, "meta"))
    done("parameter list")
    weights = make_weights(seed, spec, cell.config["weights"], device)
    done("weights made")
    load_weights(run.model, weights)
    if run.teacher is not None:
        load_weights(run.teacher, weights)
    done("weights loaded")
    ring = make_ring(seed, cell.traffic, raw, device, pin=torch.device(device).type == "cuda")
    kind = step_kind(raw)
    draws = [step_draws(seed, k, kind, cell.traffic, raw, device)
             for k in range(int(cell.workload["checked_steps"]))]
    done("ring and draws")
    readings = _checked_steps(run, train_steps, ring, draws, weights, device)
    done("checked steps")
    return Program(run=run, ring=ring, draws=draws, spec=spec, readings=readings)


def reference_readings(cell: Cell, seed: int, program: Program, device: str,
                       precision: Optional[str] = None, **kw) -> compare.Readings:
    """The plain reference's readings of the program's checked steps, in the
    precision the configuration states unless `precision` says otherwise
    (`reference/steps.py::run_reference` for the keywords)."""
    weights = make_weights(seed, program.spec, cell.config["weights"], device)
    return run_reference(run_config(cell, seed), weights, program.ring, program.draws, device,
                         precision=precision or STATED[cell.config["precision"]], **kw)


def free(device: str) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _window(run, ring, taken: int, seconds: float, print_interval: int, batch: int,
            cuda: bool) -> Window:
    """`Run.step` for `seconds` of host time, after `taken` steps (the ring
    goes on where they left it; the print interval counts them, as the
    trainer counts steps)."""
    clock = _Clock(cuda)
    dispatch, pending, losses = [], [], []
    step = taken
    start = time.perf_counter()
    clock.mark()
    while True:
        slot = ring[(taken + len(dispatch)) % len(ring)]
        labeled = run.to_device(slot["labeled"])
        unlabeled = run.to_device(slot["unlabeled"]) if slot["unlabeled"] is not None else None
        t0 = time.perf_counter()
        record = _losses(run.step(labeled, unlabeled))
        dispatch.append(time.perf_counter() - t0)
        clock.mark()
        step += 1
        pending.append(record)
        losses.append(record)
        if (step + 1) % print_interval == 0:
            _read_back(pending)
            pending = []
        if time.perf_counter() - start >= seconds:
            break
    _sync(run.device)
    wall = time.perf_counter() - start
    _read_back(pending)
    return Window(steps=len(dispatch), seconds=wall, intervals_ms=clock.intervals_ms(),
                  dispatch_s=dispatch, batch=batch,
                  losses=[float(r["total_loss"]) for r in losses])


def _traced_steps(run, ring, first_slot: int, steps: int) -> Optional[tracing.Trace]:
    from torch.profiler import ProfilerActivity, profile

    spans = tracing.HostSpans()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker = time.time_ns()
        torch.cuda._sleep(1000)
        for j in range(steps):
            slot = ring[(first_slot + j) % len(ring)]
            with spans.span("feed"):
                labeled = run.to_device(slot["labeled"])
                unlabeled = (run.to_device(slot["unlabeled"])
                             if slot["unlabeled"] is not None else None)
            with spans.span("dispatch"):
                record = run.step(labeled, unlabeled)
            del record
        with spans.span("sync"):
            torch.cuda.synchronize()
        end = time.time_ns()
    return tracing.build_trace(tracing.device_ops(prof), steps, marker, (marker, end),
                               spans.spans)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             process_start: float, log: Callable[[str], None] = print) -> Dict[str, Any]:
    """One run of `cell`; returns the result's dict (the last line's keys)."""
    cuda = torch.device(device).type == "cuda"
    traffic = cell.traffic
    with scratch_dir() as scratch:
        program = set_up(cell, seed, device, scratch, log)
        run, ring, checked = program.run, program.ring, len(program.draws)
        warm = ring[checked % len(ring)]
        t0 = time.perf_counter()
        run.step(run.to_device(warm["labeled"]), run.to_device(warm["unlabeled"])
                 if warm["unlabeled"] is not None else None)
        _sync(device)
        log(f"set-up: warm-up step {time.perf_counter() - t0:.3f} s")
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - process_start
        window = _window(run, ring, checked + 1, seconds,
                         int(run.cfg["training"].get("print_interval", 100)), traffic["batch"],
                         cuda)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = None
        if trace:
            found = _traced_steps(run, ring, checked + 1 + window.steps, PROFILED_STEPS)
        program.run = run = None
        free(device)
        t0 = time.perf_counter()
        reference = reference_readings(cell, seed, program, device)
        log(f"reference: {time.perf_counter() - t0:.3f} s")
    readings = compare.gaps(program.readings, reference)
    limits = cell.workload["limits"]
    failed = sum(1 for x in window.losses if not math.isfinite(x))
    correct = compare.verdict(readings, limits) and failed == 0
    kind_name = torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu"
    ctx = Context(cell=cell, window=window, setup_s=setup_s, window_peak_bytes=window_peak,
                  trace=found, peaks=H100_PEAKS if "H100" in kind_name else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info: Dict[str, Any] = {"platform": "gpu" if cuda else "cpu", "kind": kind_name,
                                   "count": 1,
                                   "memory_peak_bytes": max(setup_peak, window_peak)}
    result: Dict[str, Any] = {"correct": correct, "attempted": window.steps, "failed": failed,
                              "metrics": metrics, "device": device_info}
    if trace and found is not None:
        device_info["busy_s"] = found.busy_s
        device_info["window_s"] = found.window_s
        result["breakdown"] = breakdown(found)
    power_limit = card_power_limit() if cuda else None
    if power_limit is not None:
        device_info["power_limit_w"] = power_limit
    result["readings"] = {name: value for name, (value, _) in readings.items()
                          if name not in limits}
    checks = {name: {"value": readings[name][0] if name in readings else None,
                     "limit": limit, "at": readings[name][1] if name in readings else ""}
              for name, limit in limits.items()}
    checks["nonfinite_steps"] = {"value": failed, "limit": 0, "at": ""}
    result["checks"] = checks
    log(f"window: {window.steps} steps in {window.seconds:.3f} s, dispatch "
        f"{1e3 * sum(window.dispatch_s) / max(len(window.dispatch_s), 1):.1f} ms a step; "
        f"setup {setup_s:.3f} s")
    for name, value in result["readings"].items():
        log(f"reading {name}: {value!r} (no limit)")
    return result


def breakdown(found: tracing.Trace) -> Dict[str, List[List[Any]]]:
    """The device's largest consumers (5 kernel classes, 5 kernels; seconds
    per profiled step) and its 10 longest idle gaps, each named by the
    benchmark's host span open at the time."""
    classes = sorted(found.by_class().items(), key=lambda kv: -kv[1][0])[:5]
    names = sorted(found.by_name().items(), key=lambda kv: -kv[1])[:5]
    ops = [[f"class: {c}", s] for c, (s, _) in classes] + [
        [f"kernel: {n[:160]}", s] for n, s in names]
    return {"device_ops": ops, "idle_gaps": [[n, s] for n, s in found.idle_gaps()[:10]]}
