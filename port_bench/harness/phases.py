"""The program's phase spans on the device trace: which phase of the step
launched each device operation, in which phase the device idles, how much
host time each phase takes, and the step's host-device synchronisations.

The port records its phases (`utils/spans.py`: `to_device`, `train_step`
and, inside it, `teacher`, `forward`, `photometric`, `mix`, `backward`,
`optimizer`, `ema`) on `time.time_ns()` while a collector is installed.
`torch.profiler` with CUDA activity only records, beside the device
operations, the host's CUDA API calls (`cuda*`, `cu*`), each sharing a
correlation id with what it launched. So an operation belongs to the
innermost program span that holds its launching call: by time, not by
thread, so the backward's launches from autograd's device thread fall in
`backward`. Host times are compared on the host's clock (`launch_ns`,
`program_spans`, `syncs`); `host_shift_ns` moves one onto the trace's: the
least of a few probes' trace time of a CUDA runtime call that launches
nothing (a stream query) less the host's time just before it. (The
harness's own shift, from the marker's start on the device, holds the
marker's launch, `harness_shift_ns`.)

`traced_steps` takes the profiled steps as `cell.py::_traced_steps` does,
inside `spans.collect(syncs=True)` and `spans.gc_spans()`, and returns a
`PhaseTrace`: the harness's `Trace` (every existing reader reads it as
before) with those fields added.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from ..metrics.kernels_per_step import NOT_KERNELS
from . import trace as tracing
from .cell import breakdown as harness_breakdown

Span = Tuple[str, int, int]
Sync = Tuple[int, str]  # host time, the Python line that synchronised
UNATTRIBUTED = "unattributed"
# the train step's phases (`engine/train_steps.py::train_step`)
PHASES = ("teacher", "forward", "photometric", "mix", "backward", "optimizer", "ema")
LAUNCH_CALLS = ("cuda", "cu")  # name prefixes of the CUDA API's launching calls
PROBE_CALL = "cudaStreamQuery"
PROBES = 8


@dataclasses.dataclass
class PhaseTrace(tracing.Trace):
    launch_ns: List[Optional[int]] = dataclasses.field(default_factory=list)  # per op, host
    program_spans: List[Span] = dataclasses.field(default_factory=list)  # gc spans included
    syncs: List[Sync] = dataclasses.field(default_factory=list)
    host_shift_ns: int = 0
    harness_shift_ns: int = 0  # `build_trace`'s, from the marker's start on the device

    def innermost(self) -> "Innermost":
        return Innermost(self.program_spans)

    def by_span(self) -> Dict[str, Tuple[float, float]]:
        """{innermost program span of the launch, or `unattributed`: (device
        seconds per step, kernels per step)}, copies and fills of memory
        timed but not counted as kernels."""
        find = self.innermost()
        out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for op, at in zip(self.ops, self.launch_ns):
            entry = out[(find(at) if at is not None else None) or UNATTRIBUTED]
            entry[0] += (op.end_ns - op.start_ns) / 1e9
            entry[1] += 0 if op.name.lower().startswith(NOT_KERNELS) else 1
        return {k: (v[0] / self.steps, v[1] / self.steps) for k, v in out.items()}

    def phase_gaps(self) -> List[Tuple[str, float]]:
        """Every idle gap inside the window, longest first, named by the
        harness span open at its middle ("loop" where none is) and, after a
        slash, the innermost program span open there, where one is."""
        find = self.innermost()
        lo, hi = self.window_ns
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        gaps = []
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                mid = (s + e) // 2
                name = next((n for n, a, b in self.spans if a <= mid < b), "loop")
                inner = find(mid - self.host_shift_ns)
                gaps.append((f"{name}/{inner}" if inner else name, (e - s) / 1e9))
        return sorted(gaps, key=lambda g: -g[1])

    def host_ms(self, names: Sequence[str]) -> Optional[float]:
        """Host ms per step inside the program spans named `names` (None
        where there is none)."""
        found = [b - a for n, a, b in self.program_spans if n in names]
        return sum(found) / 1e6 / self.steps if found else None

    def syncs_per_step(self) -> Optional[float]:
        """Synchronisations inside the `train_step` spans, per step."""
        steps = [(a, b) for n, a, b in self.program_spans if n == "train_step"]
        if not steps:
            return None
        return sum(1 for t, _ in self.syncs if any(a <= t <= b for a, b in steps)) / self.steps


class Innermost:
    """The innermost of well-nested spans that holds a time (None where none
    does), by bisection over the spans' edges."""

    def __init__(self, spans: Sequence[Span]):
        self.edges = sorted({t for _, a, b in spans for t in (a, b)})
        # each piece between two edges: the shortest span that covers it
        self.names: List[Optional[str]] = []
        for a, b in zip(self.edges, self.edges[1:]):
            holding = [(e - s, n) for n, s, e in spans if s <= a and b <= e]
            self.names.append(min(holding)[1] if holding else None)

    def __call__(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.edges, t) - 1
        return self.names[i] if 0 <= i < len(self.names) else None


def device_launches(prof) -> Tuple[Dict[Tuple[str, int], int], List[int]]:
    """{(name, start) of a device operation: the trace's time of its
    launching call}, for the operations of `trace.py::device_ops`, and the
    trace's times of the probes' calls, in order."""
    import torch

    calls, probes, device = {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(e)
        elif e.name() == PROBE_CALL:
            probes.append(int(e.start_ns()))
        elif e.correlation_id() and e.name().startswith(LAUNCH_CALLS):
            calls.setdefault(e.correlation_id(), int(e.start_ns()))
    launches = {(e.name(), int(e.start_ns())): calls[e.correlation_id()] for e in device
                if e.correlation_id() in calls}
    return launches, sorted(probes)


def host_shift(probes_host: Sequence[int], probes_trace: Sequence[int]) -> Optional[int]:
    """The trace's clock less the host's: the least gap between a probe's
    host time and its call's time in the trace (None without probes)."""
    if not probes_host or len(probes_trace) < len(probes_host):
        return None
    return min(t - h for h, t in zip(probes_host, probes_trace))


def build(ops: List[tracing.Op], launches: Dict[Tuple[str, int], int], shift: Optional[int],
          steps: int, marker_host_ns: int, window_host_ns: Tuple[int, int], spans: List[Span],
          program_spans: Sequence[Span], syncs: Sequence[Sync]) -> Optional[PhaseTrace]:
    """`trace.py::build_trace` of `ops` (the marker first) and the harness's
    `spans`, with the program's spans and syncs (host clock) and each
    operation's launching call moved onto the host's clock by `shift`
    (None where there is no shift or no operation)."""
    base = tracing.build_trace(ops, steps, marker_host_ns, window_host_ns, spans)
    if base is None or shift is None:
        return None
    launch_ns = [None if (op.name, op.start_ns) not in launches
                 else launches[(op.name, op.start_ns)] - shift for op in base.ops]
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(tracing.Trace)}
    return PhaseTrace(**fields, launch_ns=launch_ns, program_spans=list(program_spans),
                      syncs=list(syncs), host_shift_ns=shift,
                      harness_shift_ns=base.window_ns[0] - window_host_ns[0])


def traced_steps(run, ring, first_slot: int, steps: int) -> Optional[PhaseTrace]:
    """`cell.py::_traced_steps` inside the program's collectors, the marker
    kernel launched once before the profiler starts (its first launch loads
    its module and starts late)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from improving_segmentation_with_selfsupervised_depth_tpu_torch.utils import spans

    harness = tracing.HostSpans()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    stream, probes = torch.cuda.current_stream(), []
    with spans.collect(syncs=True) as collector, spans.gc_spans() as collections:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker = time.time_ns()
            torch.cuda._sleep(1000)
            for _ in range(PROBES):
                probes.append(time.time_ns())
                stream.query()
            for j in range(steps):
                slot = ring[(first_slot + j) % len(ring)]
                with harness.span("feed"):
                    labeled = run.to_device(slot["labeled"])
                    unlabeled = (run.to_device(slot["unlabeled"])
                                 if slot["unlabeled"] is not None else None)
                with harness.span("dispatch"):
                    record = run.step(labeled, unlabeled)
                del record
            with harness.span("sync"):
                torch.cuda.synchronize()
            end = time.time_ns()
    ops = tracing.device_ops(prof)
    launches, probe_calls = device_launches(prof)
    marker_call = launches.get((ops[0].name, ops[0].start_ns)) if ops else None
    if marker_call is not None:  # the probes' calls follow the marker's
        probe_calls = [t for t in probe_calls if t >= marker_call]
    shift = host_shift(probes, probe_calls[:PROBES])
    if shift is None and marker_call is not None:
        shift = marker_call - marker
    return build(ops, launches, shift, steps, marker, (marker, end), harness.spans,
                 collector.spans + collections, collector.syncs)


def breakdown(found: PhaseTrace) -> Dict[str, List[List]]:
    """The harness's breakdown (`cell.py::breakdown`) with `span: <name>`
    entries, device seconds per step of the operations each innermost
    program span launched, and `unattributed` for the rest; the idle gaps
    named by program span too."""
    out = harness_breakdown(found)
    by = sorted(found.by_span().items(), key=lambda kv: -kv[1][0])
    out["device_ops"] += [[k if k == UNATTRIBUTED else f"span: {k}", s] for k, (s, _) in by]
    out["idle_gaps"] = [[n, s] for n, s in found.phase_gaps()[:10]]
    return out


def gc_ms(collections: Sequence[Span], steps: int) -> Optional[float]:
    """Host ms per step that the interpreter's collections took."""
    return sum(b - a for _, a, b in collections) / 1e6 / steps if steps else None
