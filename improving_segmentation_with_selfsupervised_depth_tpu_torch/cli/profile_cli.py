"""Where a training step's device time goes, on one NVIDIA GPU.

    python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.profile_cli \
        --config <yaml> [--set training.fused_reprojection=false] [--out result.json]

Builds the config's run with `engine/trainer.py::build_run`, takes two
labeled (and unlabeled) batches from its loaders to the device up front and
alternates them, so that no host batch making falls inside a step. It runs one warm-up step,
STEPS timed steps (host clock from the step's start to its losses on the
host, which waits for the device) and PROFILED steps under
`torch.profiler`. It prints the card and its power limit, the step times,
the peak memory allocated, the device kernel time per step by class and the
device's idle share, and writes the same as JSON to `--out`.

Idle share: 1 - (device kernel time per step) / (median unprofiled step
time); the profiled window's own share, which includes the profiler's
overhead, is printed beside it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch
import yaml

from ..engine.trainer import build_run

# kernel classes, first match wins: (class, substrings of the kernel name)
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
TOP_KERNELS = 25
STEPS = 10     # timed steps after the warm-up
PROFILED = 3   # steps under torch.profiler


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def _set(cfg, assignment):
    """key.path=value, the value parsed as YAML."""
    path, value = assignment.split("=", 1)
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = yaml.safe_load(value)


def _step(run, batch, unlabeled):
    t0 = time.perf_counter()
    metrics = run.step(batch, unlabeled)
    # waits for the device
    losses = {k: float(v) for k, v in metrics.items() if not k.startswith("debug/")}
    return time.perf_counter() - t0, losses


def measure(run, batches, steps: int = STEPS, profiled: int = PROFILED):
    """Time `run`'s step on `batches` (a list of (labeled, unlabeled or
    None) device batches, taken in turn): one warm-up step, `steps` timed
    steps (peak memory over them) and `profiled` steps under
    `torch.profiler`. Returns the times, the peak memory, the device kernel
    time per step with its split by class and by kernel name
    ({key: [ms per step, launches over the profiled steps]}), the idle share
    of an unprofiled step and the last step's losses."""
    first, losses = _step(run, *batches[0])
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        secs, losses = _step(run, *batches[i % len(batches)])
        times.append(secs)
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(times)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(profiled):
            _step(run, *batches[i % len(batches)])
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    by_class = defaultdict(lambda: [0.0, 0])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.device_time_total / 1e3 / profiled  # us -> ms per step
        for table, key in ((by_class, classify(e.name)), (by_name, e.name)):
            table[key][0] += ms
            table[key][1] += 1
    device_ms = sum(v[0] for v in by_class.values())
    if device_ms <= 0:
        raise SystemExit("profile_cli: the profiler recorded no device time")
    return {"first_s": first, "step_s": times, "median_s": median, "peak_bytes": peak,
            "device_ms": device_ms, "window_s": window, "idle": 1 - device_ms / (median * 1e3),
            "by_class": by_class, "by_name": by_name, "losses": losses}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_cli: no CUDA device")
    with open(args.config) as fp:
        cfg = yaml.safe_load(fp)
    for a in args.set:
        _set(cfg, a)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)

    run = build_run(cfg, "cuda:0")
    batches = [run.device_batches() for _ in range(2)]
    run.close()  # the loaders' threads are not needed after the two batches
    m = measure(run, batches)
    first, times, median, peak = m["first_s"], m["step_s"], m["median_s"], m["peak_bytes"]
    device_ms, window, losses = m["device_ms"], m["window_s"], m["losses"]
    by_class, by_name = m["by_class"], m["by_name"]

    print(f"config {args.config} {' '.join(args.set)}; batch {run.batch_size} at "
          f"{run.height}x{run.width}")
    print(f"first step {first:.4f} s; steps 2-{STEPS + 1}: median {median:.4f} s, "
          f"mean {statistics.mean(times):.4f} s, min {min(times):.4f} s, "
          f"max {max(times):.4f} s; peak memory allocated {peak / 2**30:.3f} GiB")
    print("step times (s): " + " ".join(f"{t:.4f}" for t in times))
    print(f"device kernel time {device_ms:.2f} ms/step; idle share "
          f"{1 - device_ms / (median * 1e3):.4f} of an unprofiled step, "
          f"{1 - device_ms * PROFILED / (window * 1e3):.4f} of the profiled window")
    print("| Class | ms/step | share | kernels/step |")
    print("| --- | ---: | ---: | ---: |")
    rows = sorted(by_class.items(), key=lambda kv: -kv[1][0])
    for cls, (ms, count) in rows:
        print(f"| {cls} | {ms:.2f} | {100 * ms / device_ms:.1f}% | "
              f"{count / PROFILED:,.0f} |")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    print(f"top {TOP_KERNELS} kernels: ms/step, launches/step, class, name")
    for name, (ms, count) in top:
        print(f"  {ms:8.3f} {count / PROFILED:7.0f}  {classify(name)}  {name[:160]}")
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": card, "config": args.config, "set": args.set,
                       "first_step_s": first, "step_s": times, "median_step_s": median,
                       "peak_bytes": peak, "device_ms_per_step": device_ms,
                       "classes": {c: {"ms_per_step": ms, "kernels_per_step":
                                       n / PROFILED} for c, (ms, n) in rows},
                       "top_kernels": [[name, ms, n / PROFILED]
                                       for name, (ms, n) in top],
                       "losses_last_step": losses}, fp, indent=1)


if __name__ == "__main__":
    main()
