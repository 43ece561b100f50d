"""Phase spans of the host's work, and the collectors that read them.

`span(name)` marks a phase (the train step's are listed in
`engine/train_steps.py::train_step`). With nothing collecting it returns one
shared no-op context. Inside `collect()` each span appends `(name,
start_ns, end_ns)` on `time.time_ns()`, the wall clock in ns, which is the
clock `torch.profiler` stamps its host events with. While a `torch.profiler`
capture runs `annotated()` (`engine/trainer.py::StepCapture`), each span
also enters `torch.profiler.record_function(name)`, so the capture's Chrome
trace shows the phases.

`collect(syncs=True)` on a CUDA device also counts host-device
synchronisations, through `torch.cuda.set_sync_debug_mode("warn")`: each
warning it raises inside is taken off the warning stream and kept in
`Collector.syncs` with its time and the Python line that called the
synchronising operation. `gc_spans()` records each collection of the
interpreter's garbage as a `("gc", start_ns, end_ns)` span. Each of the
three restores what it changed on exit.
"""

from __future__ import annotations

import contextlib
import gc
import time
import warnings
from typing import Iterator, List, Optional, Tuple

import torch

Span = Tuple[str, int, int]  # name, start and end on time.time_ns()
Sync = Tuple[int, str]  # time.time_ns(), "file:line" of the synchronising call

SYNC_WARNING = "called a synchronizing CUDA operation"


class Collector:
    """What `collect` gathered: `spans` in the order they closed (an inner
    span before its outer one) and `syncs`, each host-device
    synchronisation."""

    def __init__(self):
        self.spans: List[Span] = []
        self.syncs: List[Sync] = []


_OFF = contextlib.nullcontext()
_collector: Optional[Collector] = None
_annotate = False  # a torch.profiler capture runs: spans enter record_function
_on = False  # _collector is not None or _annotate


def _refresh() -> None:
    global _on
    _on = _collector is not None or _annotate


class _Span:
    __slots__ = ("name", "start", "into", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.into = _collector
        self.annotation = torch.profiler.record_function(self.name) if _annotate else None
        if self.annotation is not None:
            self.annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if self.into is not None:
            self.into.spans.append((self.name, self.start, end))
        return False


def span(name: str):
    """A context around one phase: the shared no-op when nothing collects."""
    if not _on:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def collect(syncs: bool = False) -> Iterator[Collector]:
    """Record every span inside into the yielded `Collector` (an enclosing
    collector hears none of them); with `syncs` on a CUDA device, also the
    host-device synchronisations."""
    global _collector
    collector, saved = Collector(), _collector
    _collector = collector
    _refresh()
    try:
        with contextlib.ExitStack() as stack:
            if syncs and torch.cuda.is_available():
                stack.enter_context(_counting_syncs(collector))
            yield collector
    finally:
        _collector = saved
        _refresh()


@contextlib.contextmanager
def _counting_syncs(collector: Collector) -> Iterator[None]:
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():  # restores the filters and showwarning
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                collector.syncs.append((time.time_ns(), f"{filename}:{lineno}"))
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def annotated() -> Iterator[None]:
    """Each span inside also enters `torch.profiler.record_function`."""
    global _annotate
    saved = _annotate
    _annotate = True
    _refresh()
    try:
        yield
    finally:
        _annotate = saved
        _refresh()


@contextlib.contextmanager
def gc_spans() -> Iterator[List[Span]]:
    """Each collection of the interpreter's garbage inside, as a `gc` span
    in the yielded list."""
    found: List[Span] = []
    started = [0]

    def callback(phase, info):
        if phase == "start":
            started[0] = time.time_ns()
        else:
            found.append(("gc", started[0], time.time_ns()))

    gc.callbacks.append(callback)
    try:
        yield found
    finally:
        gc.callbacks.remove(callback)
