"""The readings that a cell's limits are set from, on the card (not run by
the benchmark's own runs).

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--control 3] [--fault 3] [--layout 3] [--out cal.jsonl]

For each seed, in one process: the port's run takes the cell's checked
steps at the cell's own size, and the plain reference follows them; then,
for the first `--control` seeds, the control (the reference computed in the
configuration's `control_precision`, the step below its own) and, for the
first `--fault` seeds, the reference with half of every batch left out,
and for the first `--layout` seeds the reference with its tensors in NHWC
memory (other cuDNN algorithms, the same arithmetic: what a sound change of
the program may read).
One JSON line per seed: every number of `harness/compare.py` of each side
against the reference. The lower reading of a number is the largest the
program gives over a dozen seeds or more, the upper the smallest the control
or a fault gives; PERF.md gives the readings each limit was set from.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--fault", type=int, default=0)
    parser.add_argument("--layout", type=int, default=0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from port_bench.harness import cell as harness
    from port_bench.harness.compare import gaps
    from port_bench.harness.manifest import load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    device = "cuda:0"
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        with harness.scratch_dir() as scratch:
            program = harness.set_up(cell, seed, device, scratch)
            program.run = None
            harness.free(device)
            ref = harness.reference_readings(cell, seed, program, device)
            line = {"workload": cell.name, "seed": seed, "card": torch.cuda.get_device_name(0),
                    "program": {k: v for k, (v, _) in gaps(program.readings, ref).items()},
                    "at": {k: a for k, (_, a) in gaps(program.readings, ref).items() if a},
                    "losses": {"program": program.readings.losses, "reference": ref.losses}}
            if i < args.control:
                ctl = harness.reference_readings(cell, seed, program, device,
                                                 precision=cell.config["control_precision"])
                line["control"] = {k: v for k, (v, _) in gaps(ctl, ref).items()}
            if i < args.fault:
                half = harness.reference_readings(cell, seed, program, device, half_batch=True)
                line["half_batch"] = {k: v for k, (v, _) in gaps(half, ref).items()}
            if i < args.layout:
                nhwc = harness.reference_readings(cell, seed, program, device,
                                                  channels_last=True)
                line["channels_last"] = {k: v for k, (v, _) in gaps(nhwc, ref).items()}
            program = None
            harness.free(device)
        line["seconds"] = time.time() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
