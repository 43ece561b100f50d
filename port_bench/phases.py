"""The step's phases in one cell: per-span device and host time, the idle
gaps named by program span, syncs and collections, and what collecting costs.

    python3 port_bench/phases.py --workload <cell> --seed <n> [--seconds 45] [--pairs 10]

One run on the card: the cell's set-up (`harness/cell.py::set_up`) and its
warm-up step, the window of `--seconds` (`cell.py::_window`) inside
`spans.gc_spans()` only, then the profiled steps inside the program's
collectors (`harness/phases.py::traced_steps`), then `--pairs` pairs of
steps with the collectors on and off in turns, under the profiler as the
traced steps run and without it, each step's host time of `Run.step`. No
comparison with the reference. The last line of standard output is the
result (JSON); `--out` also writes it to a file.
"""

import argparse
import contextlib
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _step_seconds(run, ring, slot: int, collecting: bool, profiled: bool) -> float:
    """Host time of one `Run.step` on ring slot `slot`, after a synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from improving_segmentation_with_selfsupervised_depth_tpu_torch.utils import spans

    batch = ring[slot % len(ring)]
    labeled = run.to_device(batch["labeled"])
    unlabeled = run.to_device(batch["unlabeled"]) if batch["unlabeled"] is not None else None
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        if profiled:
            stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
        if collecting:
            stack.enter_context(spans.collect(syncs=True))
            stack.enter_context(spans.gc_spans())
        t0 = time.perf_counter()
        run.step(labeled, unlabeled)
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
    return seconds


def _no_op_ns(n: int = 200_000) -> float:
    """ns per `with span(...)` with nothing collecting, less an empty loop's."""
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.utils.spans import span

    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("forward"):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(n):
        pass
    return ((t1 - t0) - (time.perf_counter_ns() - t1)) / n


def _span_classes(found, find) -> dict:
    """{span: {kernel class: device ms per step}}, the kernel classes of
    `harness/trace.py`."""
    from port_bench.harness import trace

    out: dict = {}
    for op, at in zip(found.ops, found.launch_ns):
        per = out.setdefault(str(find(at) if at is not None else None), Counter())
        per[trace.classify(op.name)] += (op.end_ns - op.start_ns) / 1e6 / found.steps
    return {k: dict(v.most_common()) for k, v in out.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=45.0)
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from port_bench.harness import cell as cells
    from port_bench.harness import phases
    from port_bench.harness.manifest import load_cell
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.utils import spans

    if not torch.cuda.is_available():
        print("port_bench/phases.py: no CUDA card; nothing measured", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    log = lambda s: print(s, file=sys.stderr)  # noqa: E731
    with cells.scratch_dir() as scratch:
        program = cells.set_up(cell, args.seed, "cuda:0", scratch, log)
        run, ring, taken = program.run, program.ring, len(program.draws)
        warm = ring[taken % len(ring)]
        run.step(run.to_device(warm["labeled"]), run.to_device(warm["unlabeled"])
                 if warm["unlabeled"] is not None else None)
        torch.cuda.synchronize()
        taken += 1
        with spans.gc_spans() as collections:
            window = cells._window(run, ring, taken, args.seconds,
                                   int(run.cfg["training"].get("print_interval", 100)),
                                   cell.traffic["batch"], True)
        taken += window.steps
        found = phases.traced_steps(run, ring, taken, cells.PROFILED_STEPS)
        taken += cells.PROFILED_STEPS
        cost = {"profiled": {"on": [], "off": []}, "plain": {"on": [], "off": []}}
        for profiled in (True, False):
            for k in range(2 * args.pairs):
                on = k % 2 == 0
                cost["profiled" if profiled else "plain"]["on" if on else "off"].append(
                    _step_seconds(run, ring, taken, on, profiled))
                taken += 1
    if found is None:
        print("port_bench/phases.py: the trace holds no launching call", file=sys.stderr)
        return 1
    by, find = found.by_span(), found.innermost()
    device_total = sum(op.end_ns - op.start_ns for op in found.ops) / 1e9 / found.steps
    kernels = sum(1 for op in found.ops
                  if not op.name.lower().startswith(phases.NOT_KERNELS)) / found.steps
    dispatch = sum(b - a for n, a, b in found.spans if n == "dispatch") / 1e6 / found.steps
    phase_host = found.host_ms(phases.PHASES) or 0.0
    result = {
        "workload": args.workload, "seed": args.seed,
        "device": {"kind": torch.cuda.get_device_name(0),
                   "power_limit_w": cells.card_power_limit()},
        "metrics": {
            "photometric_device_ms": 1e3 * by["photometric"][0] if "photometric" in by else None,
            "optimizer_host_ms": found.host_ms(("optimizer", "ema")),
            "mix_host_ms": found.host_ms(("mix",)),
            "host_syncs_per_step": found.syncs_per_step(),
            "gc_ms": phases.gc_ms(collections, window.steps),
        },
        "window": {"steps": window.steps, "seconds": window.seconds,
                   "dispatch_ms": 1e3 * statistics.fmean(window.dispatch_s),
                   "collections": len(collections),
                   "longest_gc_ms": max((b - a for _, a, b in collections), default=0) / 1e6},
        "spans": {k: {"device_ms": 1e3 * s, "kernels": n} for k, (s, n) in by.items()},
        "span_classes": _span_classes(found, find),
        "host_ms": {name: found.host_ms((name,)) for name in
                    ("to_device", "train_step") + phases.PHASES},
        "checks": {
            "device_ms": 1e3 * device_total,
            "span_sum_ms": 1e3 * sum(s for s, _ in by.values()),
            "unattributed_share": by.get(phases.UNATTRIBUTED, (0.0, 0))[0] / device_total,
            "kernels_per_step": kernels,
            "span_kernels": sum(n for _, n in by.values()),
            "dispatch_ms_traced": dispatch,
            "phase_host_share": phase_host / dispatch,
            "ops_without_call": sum(1 for t in found.launch_ns if t is None),
            "host_shift_ns": found.host_shift_ns,
            "harness_shift_ns": found.harness_shift_ns,
        },
        "syncs": {"by_span": dict(Counter(find(t) for t, _ in found.syncs).most_common()),
                  "by_site": dict(Counter(site for _, site in found.syncs).most_common())},
        "breakdown": phases.breakdown(found),
        "cost_ms": {side: {k: [1e3 * x for x in v] for k, v in d.items()}
                    for side, d in cost.items()},
        "span_no_op_ns": _no_op_ns(),
    }
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
