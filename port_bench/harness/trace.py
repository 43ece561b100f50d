"""The traced run's device trace: a few steps after the timed window under
`torch.profiler`, recording CUDA activity only (no CPU ops, so the host runs
at its unprofiled pace), with the benchmark's own host spans (feed,
dispatch, record, sync) kept on the host clock beside it.

`Trace` holds the device operations (kernels, copies, fills) inside the
window, the window's length and the host spans moved onto the trace's clock
by the first device operation, a marker launched right after a synchronise
(when the device is idle, so it starts as the host launches it).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# kernel classes, first match wins: (class, substrings of the kernel name);
# a copy of the port's `cli/profile_cli.py::CLASSES`
CLASSES = (
    ("K1 warp", ("warp_bilinear", "interleave_rgb")),
    ("K3 reprojection grad", ("reprojection_error_grad",)),
    ("K2 reprojection", ("reprojection_error_kernel",)),
    ("cuDNN NCHW <-> NHWC transposes", ("nchwToNhwc", "nhwcToNchw", "nchw_to_nhwc",
                                       "nhwc_to_nchw")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("convolutions / GEMMs", ("xmma", "gemm", "cutlass", "implicit", "wgrad", "dgrad",
                              "fprop", "sm90_", "sm80_", "cudnn", "conv2d", "convolve")),
    ("reflection pads + avg-pools", ("reflection_pad", "avg_pool", "AvgPool")),
    ("pooling / resample / gather / cat", ("upsample", "grid_sampler", "gather", "index",
                                           "CatArray", "max_pool", "scatter")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "vectorized", "unrolled", "copy", "Memcpy",
                                "Memset", "fill")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


@dataclasses.dataclass
class Op:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Trace:
    ops: List[Op]                         # device operations, by start, the marker left out
    steps: int                            # profiled steps
    window_ns: Tuple[int, int]            # the traced window on the trace's clock
    spans: List[Tuple[str, int, int]]     # host spans on the trace's clock

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the operations' intervals, clipped to the window."""
        lo, hi = self.window_ns
        merged: List[List[int]] = []
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            s, e = max(op.start_ns, lo), min(op.end_ns, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def matching(self, patterns) -> List[Op]:
        low = [p.lower() for p in patterns]
        return [op for op in self.ops if any(p in op.name.lower() for p in low)]

    def seconds_per_step(self, ops: List[Op]) -> float:
        return sum(op.end_ns - op.start_ns for op in ops) / 1e9 / self.steps

    def by_class(self) -> Dict[str, Tuple[float, int]]:
        """{class: (device seconds per step, operations per step)}."""
        out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for op in self.ops:
            entry = out[classify(op.name)]
            entry[0] += (op.end_ns - op.start_ns) / 1e9
            entry[1] += 1
        return {k: (v[0] / self.steps, v[1] / self.steps) for k, v in out.items()}

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            out[op.name] += (op.end_ns - op.start_ns) / 1e9 / self.steps
        return dict(out)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Every idle gap inside the window, named by the host span open at its
        middle ("loop" where none is), longest first."""
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
                gaps.append((name, (e - s) / 1e9))
        return sorted(gaps, key=lambda g: -g[1])


class HostSpans:
    """The benchmark's host spans, on the clock the profiler stamps its
    events with (the wall clock, in ns)."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: HostSpans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.owner.spans.append((self.name, self.start, time.time_ns()))
        return False


def device_ops(prof) -> List[Op]:
    """The device operations of a finished `torch.profiler.profile`."""
    import torch

    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = int(e.start_ns())
        ops.append(Op(e.name(), start, start + int(e.duration_ns())))
    return sorted(ops, key=lambda o: o.start_ns)


def build_trace(ops: List[Op], steps: int, marker_host_ns: int, window_host_ns: Tuple[int, int],
                spans: List[Tuple[str, int, int]]) -> Optional[Trace]:
    """The trace of the profiled window, or None where the device recorded
    nothing. The first operation is the marker: the host clock is moved onto
    the trace's by its start less the host's time of its launch."""
    if len(ops) < 2:
        return None
    marker, rest = ops[0], ops[1:]
    shift = marker.start_ns - marker_host_ns
    window = (window_host_ns[0] + shift, window_host_ns[1] + shift)
    rest = [op for op in rest if op.end_ns > window[0] and op.start_ns < window[1]]
    return Trace(ops=rest, steps=steps, window_ns=window,
                 spans=[(n, a + shift, b + shift) for n, a, b in spans])
