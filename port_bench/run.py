"""The benchmark of the PyTorch port: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in BENCHMARK.json, sets it up, measures for `--seconds`
seconds, checks what the timed path produced against the plain reference,
and prints the result as the last line of standard output (one JSON
object), the numbers compared beside their limits as the last lines of
standard error. `--trace 0` reports the cell's end-to-end metrics,
`--trace 1` its per-layer metrics. A run needs as many CUDA cards as the
cell asks for; without them it prints no result and exits with 2.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its kernels into build/torch_kernels/ there by itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "port_bench" / sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))

    import torch

    from port_bench.harness.cell import forbidden_modules, run_cell
    from port_bench.harness.manifest import load_cell

    cell = load_cell(args.workload, ROOT)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s), found {found}; "
              f"no measurement without them", file=sys.stderr)
        return 2
    if not (ROOT / "improving_segmentation_with_selfsupervised_depth_tpu_torch").is_dir():
        print("port_bench: the port's package is not in this checkout", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", PROCESS_START,
                      log=lambda s: print(s, file=sys.stderr))
    leaked = forbidden_modules()
    if leaked:
        print(f"port_bench: JAX or the JAX package was loaded: {leaked}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}"
              + (f" ({check['at']})" if check.get("at") else ""), file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
