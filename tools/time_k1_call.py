"""Time K1 as the photometric loss calls it, in one tree of the PyTorch port.

    python3 tools/time_k1_call.py [--root DIR] [--label NAME]

Imports the port package and `chip_smoke.py` from DIR (default: this
checkout), builds its CUDA kernels there, and times the forward of its
`ops/resample.py::grid_sample_pack_nchw` (the grids' unnormalization, where
the tree does it outside the kernel, and K1) on one GPU: at the main path's
shape (Cityscapes exp-212, batch 2: 4 grids of 512x512 per image) and at the
synthetic exp-212's batch 4, on grids from per-pixel random and from smooth
disparities (`chip_smoke.py::_warp_inputs`). Per case, one JSON line: CUDA
events around 50 calls in a row (`ms`, `chip_smoke.py::_time_ms`), the
device alone from a profiler trace (`device_ms`, the kernels per call and
their names, `chip_smoke.py::_device_ms`) and a checksum of the warped
images. Two trees compare on one card in one process each, in turns:

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 tools/time_k1_call.py --root $t; done
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

CASES = {"main": (2, 4, 512, 512), "exp212_synthetic_batch4": (4, 4, 512, 512)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    smoke = importlib.import_module("chip_smoke")
    resample = importlib.import_module(f"{smoke.PKG}.ops.resample")
    if not Path(resample.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"time_k1_call: imported {resample.__file__}, not from {root}")
    card = smoke.phase_device()
    smoke._build.load_library()
    for case, (n, s, h, w) in CASES.items():
        for kind, smooth in (("random", False), ("smooth", True)):
            img, grids = smoke._warp_inputs(n, s, h, w, seed=n * 1000 + h, smooth=smooth)
            grids = grids.reshape(n, s, h, w, 2)
            with torch.no_grad():
                def call():
                    return resample.grid_sample_pack_nchw(img, grids)

                checksum = float(call().double().sum())
                ms = smoke._time_ms(call)
                device_ms, count, names = smoke._device_ms(call)
            print(json.dumps({"tree": args.label or root.name,
                              "library": smoke._build.library_path().name, "case": case,
                              "shape": [n, 3, h, w], "grids_per_image": s, "grids": kind,
                              "ms": ms, "device_ms": device_ms, "kernels_per_call": count,
                              "kernels": names, "checksum": checksum, "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
