"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card, its power limit, the torch/CUDA versions, TF32 flags;
  2. build: compiles the port's CUDA kernels (csrc/*.cu) with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main-path shapes and at an odd shape, with times of both;
  4. slice: the packaged `sde_supervised` config through `train_main` (the
     trainer entry point) for 3 steps at full width, counting kernel launches;
     and one small train step on the card against the same step on the CPU.
The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Any failure raises, so the exit code is
nonzero and no `ok` line is printed. There is no CPU fallback.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import yaml

from improving_segmentation_with_selfsupervised_depth_tpu_torch.data import synthetic
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import (
    optim,
    train_steps,
    trainer,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models import joint
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import geometry
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import (
    _build,
    reprojection,
    warp,
)

K1_REPLACES = "improving_segmentation_with_selfsupervised_depth_tpu/ops/pallas/warp.py:248"
K2_REPLACES = ("improving_segmentation_with_selfsupervised_depth_tpu/ops/pallas/"
               "reprojection.py:90")
PKG = "improving_segmentation_with_selfsupervised_depth_tpu_torch"
KERNEL_TOL = 1e-5  # both sides f32 with identical corner indices / window sums
STEP_RTOL = 1e-3   # small train step, card vs CPU: op-order rounding only


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script runs on a GPU only")
    # convs may use TF32 (the f32 model's realistic setting); matmuls stay f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    nvcc = _build._find_nvcc()
    print(f"[device] nvcc: {_run([nvcc, '--version']).splitlines()[-1]}; "
          f"triton installed: {importlib.util.find_spec('triton') is not None}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    so = _build.library_path()
    print(f"[build] {so.name} ready in {secs:.2f} s")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas: {line.strip()}")
    return secs


def _time_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of fn() after a warmup."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _warp_inputs(n, s, h, w, seed):
    """Image and S reprojection grids per image from random depth and a small
    pose, with a few rows pushed far out of range (border clamps)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    img = torch.rand((n, 3, h, w), generator=gen, device=dev)
    K = torch.from_numpy(synthetic.camera_matrix(h, w)).to(dev).expand(n, 4, 4)
    inv_K = torch.linalg.inv(K)
    aa = 0.02 * torch.randn((n, 3), generator=gen, device=dev)
    tr = 0.05 * torch.randn((n, 3), generator=gen, device=dev)
    T = geometry.transformation_from_parameters(aa, tr)
    grids = []
    for _ in range(s):
        disp = torch.rand((n, 1, h, w), generator=gen, device=dev)
        _, depth = geometry.disp_to_depth(disp, 0.1, 100.0)
        grids.append(geometry.project_3d(geometry.backproject_depth(depth, inv_K), K, T, h, w))
    grids = torch.stack(grids, 1).reshape(n * s, h, w, 2).clone()
    grids[:, :2, :, 0] += 6 * torch.rand((n * s, 2, w), generator=gen, device=dev) - 3
    grids[:, -2:, :, 1] += 6 * torch.rand((n * s, 2, w), generator=gen, device=dev) - 3
    return img, grids


def phase_kernels():
    records = {}

    # K1 at the main-path shape (batch 8, 512^2, 4 scale grids per image) and odd
    for (n, s, h, w) in ((8, 4, 512, 512), (2, 2, 37, 61)):
        img, grids = _warp_inputs(n, s, h, w, seed=n * 1000 + h)
        ix, iy = warp.unnormalize_grid(grids, h, w)
        ix, iy = ix.contiguous(), iy.contiguous()
        got = warp.warp_bilinear_nchw(img, ix, iy, reps=s)
        ref = warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        print(f"[kernels] K1 warp img {(n, 3, h, w)} S={s}: max|err| out/dfx/dfy = "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}")
        if not all(math.isfinite(e) and e <= KERNEL_TOL for e in errs):
            raise AssertionError(f"K1 disagrees with its plain version: {errs}")
        if h == 512:
            ms = _time_ms(lambda: warp.warp_bilinear_nchw(img, ix, iy, reps=s))
            plain_ms = _time_ms(lambda: warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s))
            print(f"[kernels] K1 warp main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            records["warp"] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}
        else:
            records["warp"]["max_abs_err"] = max(records["warp"]["max_abs_err"], *errs)

    # K2 at the main-path shape (identity losses: batch 8, 512^2) and odd; a flat
    # block makes the variance terms cancel, the case the summation order guards
    for (n, h, w) in ((8, 512, 512), (2, 37, 61)):
        gen = torch.Generator(device="cuda").manual_seed(7 + h)
        pred = torch.rand((n, 3, h, w), generator=gen, device="cuda")
        target = torch.rand((n, 3, h, w), generator=gen, device="cuda")
        pred[:, :, : h // 2, : w // 2] = 0.37
        target[:, :, : h // 2, : w // 3] = 0.61
        got = reprojection.reprojection_error(pred, target)
        ref = reprojection.reprojection_error_plain(pred, target)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        print(f"[kernels] K2 reprojection {(n, 3, h, w)}: max|err| = {err:.3e}")
        if not (math.isfinite(err) and err <= KERNEL_TOL) or got.shape != (n, 1, h, w):
            raise AssertionError(f"K2 disagrees with its plain version: {err}")
        if h == 512:
            ms = _time_ms(lambda: reprojection.reprojection_error(pred, target))
            plain_ms = _time_ms(lambda: reprojection.reprojection_error_plain(pred, target))
            print(f"[kernels] K2 reprojection main shape: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
            records["reprojection"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        else:
            records["reprojection"]["max_abs_err"] = max(
                records["reprojection"]["max_abs_err"], err)
    return records


def _tiny_cfg():
    """The supervised step at a small size (resnet18, 64x128, batch 2)."""
    cfg = _packaged_cfg()
    cfg["model"]["backbone_name"] = "resnet18"
    cfg["model"]["depth_args"] = {"intermediate_aspp": True, "aspp_rates": [1, 2]}
    cfg["monodepth_options"].update(height=64, width=128)
    cfg["training"].update(batch_size=2, train_iters=1, photometric_dtype=None)
    return cfg


def _packaged_cfg():
    path = Path(__file__).resolve().parent / PKG / "configs" / "sde_supervised_synthetic.yml"
    with open(path) as fp:
        return yaml.safe_load(fp)


def phase_small_step():
    """One small train step on the card (kernels) against the same step on the
    CPU (plain versions), from the same weights, batch and tie-break noise."""
    cfg = _tiny_cfg()
    h, w = cfg["monodepth_options"]["height"], cfg["monodepth_options"]["width"]
    torch.manual_seed(0)
    cpu_model = joint.build_model(cfg["model"], 19)
    for m in cpu_model.modules():  # the two devices draw different dropout masks
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    gpu_model = copy.deepcopy(cpu_model).cuda()
    step_cfg = train_steps.step_config_from_cfg(cfg)
    batch = synthetic.make_synthetic_batch(2, h, w, seed=3)
    noise = torch.randn((2, 2, h, w), generator=torch.Generator().manual_seed(5))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 on both sides for this check
    try:
        results = []
        for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
            opt = optim.build_optimizer(cfg["training"], cfg["model"], model)
            m = train_steps.train_step(model, opt, synthetic.to_device_batch(batch, dev), step_cfg,
                                 tie_break_noise=noise.to(dev))
            results.append({k: float(v) for k, v in m.items()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    keys = ("total_loss", "segmentation_loss", "mono_loss")
    for k in keys:
        print(f"[small step] {k}: cpu {results[0][k]:.7f} card {results[1][k]:.7f}")
    for k in keys:
        a, b = results[0][k], results[1][k]
        if not (math.isfinite(b) and abs(a - b) <= STEP_RTOL * abs(a)):
            raise AssertionError(f"small step {k}: card {b} vs cpu {a}")
    diff = max(float((p.detach().cpu() - q.detach()).abs().max())
               for p, q in zip(gpu_model.parameters(), cpu_model.parameters()))
    print(f"[small step] max |param card - param cpu| after the step: {diff:.3e}")
    if not diff <= 1e-4:
        raise AssertionError(f"small step: updated parameters differ by {diff}")


def phase_slice():
    """The packaged sde_supervised config through train_main, 3 train_steps."""
    cfg = _packaged_cfg()
    n_steps = cfg["training"]["train_iters"]
    torch.cuda.reset_peak_memory_stats()
    warp.warp_bilinear_nchw.launches = 0
    reprojection.reprojection_error.launches = 0
    records = trainer.train_main(cfg, device="cuda:0")
    launches = {"warp": warp.warp_bilinear_nchw.launches,
                "reprojection": reprojection.reprojection_error.launches}
    peak = torch.cuda.max_memory_allocated()
    m = cfg["model"]
    print(f"[slice] {m['backbone_name']} dilated {m['replace_stride_with_dilation']}, "
          f"num_ch_dec {m['depth_args']['num_ch_dec']}, batch {cfg['training']['batch_size']} "
          f"at {cfg['monodepth_options']['height']}x{cfg['monodepth_options']['width']}, "
          f"{n_steps} steps")
    for i, r in enumerate(records, start=1):
        print(f"[slice] step {i}: total {r['total_loss']:.6f} seg {r['segmentation_loss']:.6f} "
              f"mono {r['mono_loss']:.6f}  step {r['step_seconds']:.4f} s "
              f"(batch making {r['data_seconds']:.4f} s)")
    later = [r["step_seconds"] for r in records[1:]]
    print(f"[slice] mean time of steps 2-{n_steps}: {statistics.mean(later):.4f} s; "
          f"peak memory allocated {peak / 2**30:.3f} GiB; launches {launches}")
    if len(records) != n_steps:
        raise AssertionError(f"{len(records)} steps ran, {n_steps} asked")
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite loss: {r}")
    if len({r["total_loss"] for r in records}) == 1:
        raise AssertionError("total_loss is constant across the steps")
    # one K1 launch per source frame (all 4 scale grids) and one K2 launch per
    # source frame (identity loss) in every step
    expect = 2 * n_steps
    if launches != {"warp": expect, "reprojection": expect}:
        raise AssertionError(f"kernel launches {launches}, expected {expect} each")
    return launches


def main():
    phase_device()
    phase_build()
    records = phase_kernels()
    phase_small_step()
    launches = phase_slice()
    pkg = Path(PKG)
    kernels = [
        {"name": "warp_bilinear_nchw", "route": "cuda", "source": str(pkg / "csrc/warp.cu"),
         "replaces": K1_REPLACES, "launches": launches["warp"], **records["warp"]},
        {"name": "reprojection_error", "route": "cuda",
         "source": str(pkg / "csrc/reprojection.cu"), "replaces": K2_REPLACES,
         "launches": launches["reprojection"], **records["reprojection"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
