"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card, its power limit, the torch/CUDA versions, TF32 flags;
  2. build: compiles the port's CUDA kernels (csrc/*.cu) with nvcc and
     prints each kernel's registers, spills and SASS instruction counts;
  3. kernels: each kernel (K1 warp, K2 fused SSIM+L1 error, K3 its
     gradient) against its plain PyTorch version on the card, at the
     main-path shapes, at odd shapes and at the edges of K2/K3's tiles, with
     times of both, of one PyTorch reference call where there is one (each
     the median of one-call CUDA-event timings), and the least time the card
     could take (bytes over its memory rate, or operations over its f32 rate);
     K1's and `F.grid_sample`'s device times (profiler) at K1's main shape,
     on per-pixel random and on smooth grids;
  4. small steps: one small train step on the card against the same step on
     the CPU, for the supervised SDE step and for the exp-212 step; a second
     exp-212 step on each device checks the EMA update at alpha 0.5; the
     exp-212 eval step on the card against the CPU;
  5. slices: the packaged configs through `train_main` (the trainer entry
     point) at full width, counting kernel launches from 0 around each run:
     `sde_supervised` (3 steps), `exp212_pad_online` with fused_reprojection
     on (3 steps, the main path of training) and the same with it off,
     `exp210_depthcomp` (3 steps, no kernel), and exp-212 validated after
     steps 2 and 3 over 2 batches of 4 (the eval path: K1 and K2 per
     batch); then the eval step alone at full width, for `sde_supervised`
     and exp-212, with its launches, times and peak memory.
The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Any failure raises, so the exit code is
nonzero and no `ok` line is printed. There is no CPU fallback.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F
import yaml

from improving_segmentation_with_selfsupervised_depth_tpu_torch.data import synthetic
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import (
    optim,
    state,
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

TPU_PKG = "improving_segmentation_with_selfsupervised_depth_tpu"
K1_REPLACES = f"{TPU_PKG}/ops/pallas/warp.py:248"
K2_REPLACES = f"{TPU_PKG}/ops/pallas/reprojection.py:90"
K3_REPLACES = f"{TPU_PKG}/ops/pallas/reprojection.py:225"
PKG = "improving_segmentation_with_selfsupervised_depth_tpu_torch"
KERNEL_TOL = 1e-5  # K1, K2: both sides f32, identical corner indices / window sums
# K3: max |kernel - plain| <= K3_REL_TOL * max |plain|. The same formula in the
# same order without FMA contraction on both sides; flat windows amplify a
# last-bit difference of a variance term by up to 1/C2^2 in the coefficients,
# which is why the bound is relative to the gradient's own scale.
K3_REL_TOL = 1e-5
STEP_RTOL = 1e-3   # small train steps, card vs CPU: op-order rounding only

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the tensor
# cores (the kernels do f32 arithmetic on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per (pixel, channel), counted from the kernels' arithmetic
# (a division counts as one): K1 ~17 per channel plus ~10 per grid pixel for
# the corner weights; K2 3 products and 40 adds for the five 3x3 window sums
# plus ~33 for SSIM, clip and L1; K3 ~90 per center (window sums, statistics,
# clip subgradient, five coefficients) plus ~53 per output (five 3x3 box
# sums, the combination and L1 term)
K1_OPS_PER_CHANNEL, K1_OPS_PER_PIXEL = 17, 10
K2_OPS = 76
K3_OPS = 143


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _bound(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations") on the card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script runs on a GPU only")
    # convs may use TF32 (the f32 model's realistic setting); matmuls stay f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    nvcc = _build._find_nvcc()
    print(f"[device] nvcc: {_run([nvcc, '--version']).splitlines()[-1]}; "
          f"triton installed: {importlib.util.find_spec('triton') is not None}")
    return smi


def sass_summary(so):
    """Per kernel of the library `so`, from `cuobjdump -sass`: its static
    SASS instruction count (NOPs left out), the longest loop (a backward
    branch: the instructions from its target to it) and the IEEE divisions'
    reciprocals (MUFU.RCP) and range checks (FCHK)."""
    cuobjdump = Path(_build._find_nvcc()).with_name("cuobjdump")
    text = _run([str(cuobjdump), "-sass", str(so)])
    summary = {}
    for block in text.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        ops, loop = [], 0
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                             block):
            a, op = int(m.group(1), 16), m.group(2)
            ops.append(op)
            target = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", m.group(0))
            if op.startswith("BRA") and target and int(target.group(1), 16) < a:
                loop = max(loop, (a - int(target.group(1), 16)) // 16 + 1)
        summary[name] = {"instructions": sum(op != "NOP" for op in ops), "longest_loop": loop,
                         "mufu_rcp": sum(op.startswith("MUFU.RCP") for op in ops),
                         "fchk": sum(op.startswith("FCHK") for op in ops)}
    return summary


def phase_build():
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    so = _build.library_path()
    print(f"[build] {so.name} ready in {secs:.2f} s")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] ptxas: {line.strip()}")
    for name, counts in sass_summary(so).items():
        print(f"[build] sass {name}: {json.dumps(counts)}")
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


def _device_ms(fn, reps=20):
    """Device time per call of fn() from a `torch.profiler` trace of `reps`
    calls after a warmup, as `cli/profile_cli.py` takes it: the sum of the
    device times of the kernels launched, over `reps`. Returns (ms per call,
    kernels per call, the kernels' names)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.device_time_total for e in kernels)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total_us / 1e3 / reps, len(kernels) / reps, sorted({e.name[:60] for e in kernels})


def _warp_inputs(n, s, h, w, seed, smooth=False):
    """Image and S reprojection grids per image from random depth and a small
    pose, with a few rows pushed far out of range (border clamps). The
    disparity is random per pixel, or with `smooth` bilinearly upsampled from
    a 1/32-size random map, as a decoder's is (neighbouring pixels then
    sample neighbouring source pixels)."""
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
        if smooth:
            disp = F.interpolate(torch.rand((n, 1, h // 32, w // 32), generator=gen,
                                            device=dev), size=(h, w), mode="bilinear")
        else:
            disp = torch.rand((n, 1, h, w), generator=gen, device=dev)
        _, depth = geometry.disp_to_depth(disp, 0.1, 100.0)
        grids.append(geometry.project_3d(geometry.backproject_depth(depth, inv_K), K, T, h, w))
    grids = torch.stack(grids, 1).reshape(n * s, h, w, 2).clone()
    grids[:, :2, :, 0] += 6 * torch.rand((n * s, 2, w), generator=gen, device=dev) - 3
    grids[:, -2:, :, 1] += 6 * torch.rand((n * s, 2, w), generator=gen, device=dev) - 3
    return img, grids


def _reprojection_inputs(n, reps, h, w, seed):
    """pred (N*reps, 3, H, W), target (N, 3, H, W), g (N*reps, 1, H, W): a flat
    block in both (the variance terms cancel) and a block where pred equals
    target (SSIM exactly 1, |u| = 0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pred = torch.rand((n * reps, 3, h, w), generator=gen, device="cuda")
    target = torch.rand((n, 3, h, w), generator=gen, device="cuda")
    pred[:, :, : h // 2, : w // 2] = 0.37
    target[:, :, : h // 2, : w // 3] = 0.61
    pred[:, :, h // 2:, w // 2:] = target.repeat_interleave(reps, 0)[:, :, h // 2:, w // 2:]
    g = torch.randn((n * reps, 1, h, w), generator=gen, device="cuda")
    return pred, target, g


def phase_kernels():
    """Each kernel against its plain version at every full-width shape the
    sde and exp-212 paths give it (512^2, batch 8 and 4) and at odd shapes;
    times at the exp-212 main-path shape (batch 4, 4 scales per frame)."""
    records = {}
    f32 = 4

    # K1: one launch per source frame warps the frame at its 4 scale grids;
    # exp-212 (batch 4, timed), sde (batch 8) and an odd shape
    for i, (n, s, h, w) in enumerate(((4, 4, 512, 512), (8, 4, 512, 512), (2, 2, 37, 61))):
        img, grids = _warp_inputs(n, s, h, w, seed=n * 1000 + h)
        ix, iy = warp.unnormalize_grid(grids, h, w)
        ix, iy = ix.contiguous(), iy.contiguous()
        got = warp.warp_bilinear_nchw(img, ix, iy, reps=s)
        ref = warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        print(f"[kernels] K1 warp img {(n, 3, h, w)} S={s}: max|err| out/dfx/dfy = "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tolerance {KERNEL_TOL:.0e})")
        if not all(math.isfinite(e) and e <= KERNEL_TOL for e in errs):
            raise AssertionError(f"K1 disagrees with its plain version: {errs}")
        if i > 0:
            records["warp"]["max_abs_err"] = max(records["warp"]["max_abs_err"], *errs)
            continue
        ms = _time_ms(lambda: warp.warp_bilinear_nchw(img, ix, iy, reps=s))
        plain_ms = _time_ms(lambda: warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s))
        # the PyTorch reference computes the `out` plane alone (no dfx/dfy)
        img_rep = img.repeat_interleave(s, 0)
        lib_ms = _time_ms(lambda: F.grid_sample(img_rep, grids, mode="bilinear",
                                                padding_mode="border", align_corners=True))
        m = n * s
        bound_ms, bound_by = _bound(
            f32 * (n * 3 * h * w + 2 * m * h * w + 3 * m * 3 * h * w),
            m * h * w * (K1_OPS_PER_PIXEL + 3 * K1_OPS_PER_CHANNEL))
        print(f"[kernels] K1 warp main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.grid_sample (out plane only, partial) {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        records["warp"] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                           "library_call": "F.grid_sample bilinear border, out plane only"}
        # the device alone (no host work), K1 and F.grid_sample by the same
        # profiler method, on these grids and on smooth ones
        for suffix, smooth in (("", False), ("_smooth", True)):
            img_d, grids_d = (img, grids) if not smooth else _warp_inputs(n, s, h, w, 5, True)
            ix_d, iy_d = (t.contiguous() for t in warp.unnormalize_grid(grids_d, h, w))
            img_d_rep = img_d.repeat_interleave(s, 0)
            dev = _device_ms(lambda: warp.warp_bilinear_nchw(img_d, ix_d, iy_d, reps=s))
            lib_dev = _device_ms(lambda: F.grid_sample(
                img_d_rep, grids_d, mode="bilinear", padding_mode="border", align_corners=True))
            for what, (d_ms, count, names) in (("K1", dev), ("F.grid_sample", lib_dev)):
                print(f"[kernels] {what} device time per call, "
                      f"{'smooth' if smooth else 'per-pixel random'} disparity: {d_ms:.4f} ms "
                      f"({count:g} kernels per call: {names})")
            records["warp"].update({"device_ms" + suffix: dev[0],
                                    "library_device_ms" + suffix: lib_dev[0]})

    # K2 and K3: the per-scale pred error of one exp-212 source frame, its 4
    # scales against one target (reps 4, timed); the identity errors of sde
    # (batch 8) and exp-212 (batch 4, K2 timed) with reps 1; odd shapes with
    # reps 1 and 2; the strips' edges (H not a multiple of the row tile, W
    # odd and not a multiple of the strip, H and W of 2 and 3, where the
    # folds of rows 0 and H+1 meet); more than 65,535 planes (21,846 x 3)
    for i, (n, reps, h, w) in enumerate(((4, 4, 512, 512), (8, 1, 512, 512), (4, 1, 512, 512),
                                         (2, 1, 37, 61), (2, 2, 37, 61), (1, 4, 50, 97),
                                         (2, 1, 2, 3), (2, 1, 3, 2), (1, 2, 3, 3),
                                         (21846, 1, 2, 2))):
        pred, target, g = _reprojection_inputs(n, reps, h, w, seed=7 + h + reps)
        got = reprojection.reprojection_error(pred, target, reps)
        ref = reprojection.reprojection_error_plain(pred, target, reps)
        dgot = reprojection.reprojection_error_grad(pred, target, g, reps)
        dref = reprojection.reprojection_error_grad_plain(pred, target, g, reps)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        derr = float((dgot - dref).abs().max())
        dscale = float(dref.abs().max())
        shape = (n * reps, 3, h, w)
        print(f"[kernels] K2 reprojection pred {shape} reps {reps}: max|err| = {err:.3e} "
              f"(tolerance {KERNEL_TOL:.0e})")
        print(f"[kernels] K3 reprojection grad pred {shape} reps {reps}: max|err| = "
              f"{derr:.3e}, max|plain| = {dscale:.3e}, relative {derr / dscale:.3e} "
              f"(tolerance {K3_REL_TOL:.0e} relative)")
        if not (math.isfinite(err) and err <= KERNEL_TOL) or got.shape != (n * reps, 1, h, w):
            raise AssertionError(f"K2 disagrees with its plain version: {err}")
        if not (math.isfinite(derr) and derr <= K3_REL_TOL * dscale) or dgot.shape != shape:
            raise AssertionError(f"K3 disagrees with its plain version: {derr} of {dscale}")
        if i > 0:
            records["reprojection"]["max_abs_err"] = max(
                records["reprojection"]["max_abs_err"], err)
            records["reprojection_grad"]["max_abs_err"] = max(
                records["reprojection_grad"]["max_abs_err"], derr)
            if (n, reps, h, w) == (4, 1, 512, 512):  # the exp-212 identity error
                ms = _time_ms(lambda: reprojection.reprojection_error(pred, target, reps))
                plain_ms = _time_ms(
                    lambda: reprojection.reprojection_error_plain(pred, target, reps))
                bound_ms, bound_by = _bound(f32 * (2 * n * 3 * h * w + n * h * w),
                                            n * 3 * h * w * K2_OPS)
                print(f"[kernels] K2 reprojection identity shape {shape}: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
                records["reprojection"].update(ms_identity=ms, plain_ms_identity=plain_ms,
                                               bound_ms_identity=bound_ms)
            continue
        m, px = n * reps, h * w
        ms = _time_ms(lambda: reprojection.reprojection_error(pred, target, reps))
        plain_ms = _time_ms(lambda: reprojection.reprojection_error_plain(pred, target, reps))
        bound_ms, bound_by = _bound(f32 * (m * 3 * px + n * 3 * px + m * px), m * 3 * px * K2_OPS)
        print(f"[kernels] K2 reprojection main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by})")
        records["reprojection"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bound_ms, "bound_by": bound_by,
                                   "library_ms": None}
        dms = _time_ms(lambda: reprojection.reprojection_error_grad(pred, target, g, reps))
        dplain_ms = _time_ms(
            lambda: reprojection.reprojection_error_grad_plain(pred, target, g, reps))
        # the PyTorch reference: autograd's backward of the f32 plain chain
        leaf = pred.clone().requires_grad_()
        chain = reprojection.reprojection_error_plain(leaf, target, reps)
        lib_ms = _time_ms(lambda: torch.autograd.grad(chain, leaf, g, retain_graph=True))
        del chain, leaf
        dbound_ms, dbound_by = _bound(f32 * (2 * m * 3 * px + n * 3 * px + m * px),
                                      m * 3 * px * K3_OPS)
        print(f"[kernels] K3 reprojection grad main shape: kernel {dms:.4f} ms, plain "
              f"{dplain_ms:.4f} ms, autograd of the plain chain {lib_ms:.4f} ms, "
              f"bound {dbound_ms:.4f} ms ({dbound_by})")
        records["reprojection_grad"] = {
            "max_abs_err": derr, "max_abs_plain": dscale, "ms": dms, "plain_ms": dplain_ms,
            "bound_ms": dbound_ms, "bound_by": dbound_by, "library_ms": lib_ms,
            "library_call": "torch.autograd backward of the f32 plain SSIM+L1 chain"}
    return records


def _packaged_cfg(name):
    path = Path(__file__).resolve().parent / PKG / "configs" / name
    with open(path) as fp:
        return yaml.safe_load(fp)


def _no_dropout(model):
    for m in model.modules():  # the two devices draw different dropout masks
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return model


def _params(module):
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def _small_step(label, cfg_name, n):
    """A small train step (resnet18, 64x128, batch n) on the card (kernels)
    against the same step on the CPU (plain versions): same weights, batches
    and draws, f32 convolutions on both sides. Checks the losses, the
    parameters and, for the semi-supervised step, the EMA teacher's
    parameters after the step.

    The semi-supervised step then runs a second time on each device, and
    the teacher must be exactly 0.5 teacher + 0.5 student in the EMA's
    submodules and unchanged elsewhere (the first update copies the
    student). The second step is not compared card vs CPU: its pseudo-label
    threshold and depthcomp mask turn the first step's rounding differences
    into discrete flips."""
    cfg = _packaged_cfg(cfg_name)
    cfg["model"]["backbone_name"] = "resnet18"
    cfg["model"]["depth_args"] = {"intermediate_aspp": True, "aspp_rates": [1, 2]}
    cfg["training"]["photometric_dtype"] = None
    h, w = 64, 128
    step_cfg = train_steps.step_config_from_cfg(cfg)
    devices = ("cpu", "cuda")
    torch.manual_seed(0)
    models = [_no_dropout(joint.build_model(cfg["model"], 19))]
    models.append(copy.deepcopy(models[0]).to(devices[1]))
    batch = synthetic.make_synthetic_batch(n, h, w, seed=3)
    ubatch = synthetic.make_synthetic_batch(n, h, w, seed=4, with_unlabeled_extras=True)
    gen = torch.Generator().manual_seed(5)
    noise, noise_u = (torch.randn((n, 2, h, w), generator=gen) for _ in range(2))
    results, after = [], []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for model, dev in zip(models, devices):
            kw = {}
            if step_cfg.use_ema:
                kw = dict(unlabeled_batch=synthetic.to_device_batch(ubatch, dev),
                          teacher=state.make_teacher(model),
                          draws=train_steps.StepDraws(
                              tie_break_noise_u=noise_u.to(dev), jitter=(1.1, 0.9, 1.2, 0.05),
                              jitter_apply=0.9, blur_sigma=0.8, blur_apply=0.9))
            opt = optim.build_optimizer(cfg["training"], cfg["model"], model)

            def step():
                m = train_steps.train_step(model, opt, synthetic.to_device_batch(batch, dev),
                                           step_cfg, tie_break_noise=noise.to(dev), **kw)
                return {k: float(v) for k, v in m.items()}

            results.append(step())
            after.append({"params": _params(model)})
            if step_cfg.use_ema:
                after[-1]["EMA params"] = _params(kw["teacher"])
                second = step()
                print(f"[{label}] {dev} second step: total_loss {second['total_loss']:.7f}")
                _check_ema_mix(label, dev, after[-1]["EMA params"], _params(model),
                               _params(kw["teacher"]), step_cfg.ema_names)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for k in results[0]:
        a, b = results[0][k], results[1][k]
        print(f"[{label}] {k}: cpu {a:.7f} card {b:.7f}")
        if not (math.isfinite(b) and abs(a - b) <= STEP_RTOL * abs(a)):
            raise AssertionError(f"{label} {k}: card {b} vs cpu {a}")
    for what in after[0]:
        cpu_p, dev_p = after[0][what], after[1][what]
        diff = max(float((dev_p[k].cpu() - cpu_p[k]).abs().max()) for k in cpu_p)
        print(f"[{label}] max |{what} card - {what} cpu| after the step: {diff:.3e}")
        if not diff <= 1e-4:
            raise AssertionError(f"{label}: {what} differ by {diff}")
    return step_cfg


def _check_ema_mix(label, dev, ema1, student2, ema2, names):
    """ema2 = 0.5 ema1 + 0.5 student2 in `names`' submodules, ema1 elsewhere."""
    mixed = moved = 0
    err = 0.0
    for k, e2 in ema2.items():
        if k.split(".")[1] in names:
            want = ema1[k] * 0.5 + student2[k] * 0.5
            mixed += 1
            moved += int(not torch.equal(e2, ema1[k]))
        else:
            want = ema1[k]
        err = max(err, float((e2 - want).abs().max()))
    print(f"[{label}] {dev} EMA after the second step (alpha 0.5): {mixed} of {len(ema2)} "
          f"tensors mixed, {moved} moved; max |teacher - expected| {err:.3e} (tolerance 1e-7)")
    if not (err <= 1e-7 and moved > 0 and mixed < len(ema2)):
        raise AssertionError(f"{label}: the EMA update on {dev} is not alpha 0.5 over {names}")


def _small_eval(label, cfg_name, n):
    """The eval step (resnet18, 64x128, batch n) on the card (K1, K2) against
    the CPU (plain versions): same weights, with running statistics from one
    train-mode pass (as the parity tests condition them), batch and
    tie-break noise, f32 convolutions. The confusion matrices must be equal,
    the losses and depth metrics within STEP_RTOL."""
    cfg = _packaged_cfg(cfg_name)
    cfg["model"]["backbone_name"] = "resnet18"
    cfg["model"]["depth_args"] = {"intermediate_aspp": True, "aspp_rates": [1, 2]}
    h, w = 64, 128
    step_cfg = train_steps.step_config_from_cfg(cfg)
    torch.manual_seed(0)
    model = _no_dropout(joint.build_model(cfg["model"], 19))
    batch = synthetic.make_synthetic_batch(n, h, w, seed=6)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(synthetic.to_device_batch(batch, "cpu"))
    for m in bns:
        m.momentum = 0.1
        m.running_var.add_(0.5)
    noise = torch.randn((n, 2, h, w), generator=torch.Generator().manual_seed(7))
    results = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            _reset_launches()
            metrics, conf, _ = train_steps.eval_step(
                copy.deepcopy(model).to(dev), synthetic.to_device_batch(batch, dev), step_cfg,
                tie_break_noise=noise.to(dev))
            results.append(({k: float(v) for k, v in metrics.items()}, conf.cpu(),
                            _read_launches()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (cpu_m, cpu_conf, cpu_l), (dev_m, dev_conf, dev_l) = results
    print(f"[{label}] launches cpu {cpu_l}, card {dev_l}; confusion matrix sum "
          f"{int(cpu_conf.sum())}, equal: {torch.equal(cpu_conf, dev_conf)}")
    if any(cpu_l.values()) or dev_l != {"warp": 2, "reprojection": 4, "reprojection_grad": 0}:
        raise AssertionError(f"{label}: launches cpu {cpu_l}, card {dev_l}")
    if not torch.equal(cpu_conf, dev_conf):
        raise AssertionError(f"{label}: confusion matrices differ in "
                             f"{int((cpu_conf != dev_conf).sum())} cells")
    for k, a in cpu_m.items():
        b = dev_m[k]
        print(f"[{label}] {k}: cpu {a:.7f} card {b:.7f}")
        if not (math.isfinite(b) and abs(a - b) <= STEP_RTOL * abs(a)):
            raise AssertionError(f"{label} {k}: card {b} vs cpu {a}")
    if len([k for k in cpu_m if k.startswith("depth/")]) != 7:
        raise AssertionError(f"{label}: depth metrics missing: {sorted(cpu_m)}")


def phase_small_steps():
    _small_step("small sde step", "sde_supervised_synthetic.yml", 2)
    step_cfg = _small_step("small exp212 step", "exp212_pad_online_synthetic.yml", 4)
    if not (step_cfg.fused_pred_loss and step_cfg.use_ema):
        raise AssertionError("the exp212 small step must run K2/K3 and the EMA teacher")
    _small_eval("small exp212 eval step", "exp212_pad_online_synthetic.yml", 4)


def _reset_launches():
    warp.warp_bilinear_nchw.launches = 0
    reprojection.reprojection_error.launches = 0
    reprojection.reprojection_error_grad.launches = 0


def _read_launches():
    return {"warp": warp.warp_bilinear_nchw.launches,
            "reprojection": reprojection.reprojection_error.launches,
            "reprojection_grad": reprojection.reprojection_error_grad.launches}


def _run_slice(label, cfg, per_step, per_val_batch=None, n_validations=0):
    """`cfg` through train_main; checks finite moving losses and the kernel
    launches: `per_step` of each kernel in every step and, with
    `training.val_interval`, `per_val_batch` in every batch of each of the
    `n_validations` validations, whose records it checks too."""
    n_steps = cfg["training"]["train_iters"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    records = trainer.train_main(cfg, device="cuda:0")
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    m = cfg["model"]
    print(f"[{label}] {m['backbone_name']} dilated {m['replace_stride_with_dilation']}, "
          f"{m['segmentation_name']}, num_ch_dec {m['depth_args']['num_ch_dec']}, "
          f"monodepth {not m.get('disable_monodepth', False)}, pose "
          f"{not m.get('disable_pose', False)}, batch {cfg['training']['batch_size']} at "
          f"{cfg['monodepth_options']['height']}x{cfg['monodepth_options']['width']}, "
          f"fused_reprojection {cfg['training'].get('fused_reprojection', False)}, "
          f"{n_steps} steps")
    validations = []
    for i, r in enumerate(records, start=1):
        losses = " ".join(f"{k} {v:.6f}" for k, v in r.items()
                          if k.endswith("loss") and not k.startswith("val/"))
        print(f"[{label}] step {i}: {losses}  step {r['step_seconds']:.4f} s "
              f"(batch making {r['data_seconds']:.4f} s)")
        val = {k[4:]: v for k, v in r.items() if k.startswith("val/")}
        if val:
            validations.append(val)
            print(f"[{label}] validation after step {i}: " + " ".join(
                f"{k} {v:.6f}" for k, v in val.items()))
    later = [r["step_seconds"] for r in records[1:]]
    print(f"[{label}] mean time of steps 2-{n_steps}: {statistics.mean(later):.4f} s; "
          f"peak memory allocated {peak / 2**30:.3f} GiB; launches {launches}")
    if len(records) != n_steps:
        raise AssertionError(f"{label}: {len(records)} steps ran, {n_steps} asked")
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"{label}: non-finite value: {r}")
    if len({r["total_loss"] for r in records}) == 1:
        raise AssertionError(f"{label}: total_loss is constant across the steps")
    if len(validations) != n_validations:
        raise AssertionError(f"{label}: {len(validations)} validations, {n_validations} asked")
    best = -math.inf
    for val in validations:
        best = max(best, val["Mean IoU"])
        if not (0 <= val["Mean IoU"] <= 1 and val["best_iou"] == best
                and len([k for k in val if k.startswith("depth/")]) == 7):
            raise AssertionError(f"{label}: validation record {val}")
    expect = {k: v * n_steps for k, v in per_step.items()}
    if n_validations:
        vcfg = cfg["training"]
        batches = -(-cfg["data"]["n_samples"] // vcfg.get("val_batch_size",
                                                            vcfg["batch_size"]))
        expect = {k: v + per_val_batch[k] * batches * n_validations for k, v in expect.items()}
    if launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expect}")
    return launches


def _eval_step_once(label, cfg_name):
    """One eval step of a packaged config at full width, on its first
    validation batch (`val_batch_size`, default the training batch): K1 2 and
    K2 4 launches, K3 none. Then its host time (the first call's and the
    median of 5 more), its device time per call (profiler) and the peak
    memory of one call."""
    run = trainer.build_run(_packaged_cfg(cfg_name), "cuda:0")
    batch = next(run.val_batches())
    gen = torch.Generator(device="cuda:0").manual_seed(0)

    def step():
        metrics, conf, _ = train_steps.eval_step(run.model, batch, run.step_cfg, generator=gen)
        return {k: float(v) for k, v in metrics.items()}, conf

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    values, conf = step()
    first = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_lbl = int((batch["lbl"] != 250).sum())
    if launches != {"warp": 2, "reprojection": 4, "reprojection_grad": 0}:
        raise AssertionError(f"{label}: launches {launches}")
    if not all(math.isfinite(v) for v in values.values()) or int(conf.sum()) != n_lbl:
        raise AssertionError(f"{label}: {values}, confusion matrix sum {int(conf.sum())}")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    dev_ms, n_kernels, _ = _device_ms(step, reps=3)
    print(f"[{label}] batch {batch['lbl'].shape[0]} at {tuple(batch['lbl'].shape[1:])}: "
          f"launches {launches}; first call {first:.4f} s, then median "
          f"{statistics.median(times):.4f} s; device {dev_ms:.2f} ms per call "
          f"({n_kernels:g} kernels); peak memory allocated {peak / 2**30:.3f} GiB; "
          + " ".join(f"{k} {v:.6f}" for k, v in values.items()))
    return launches


def phase_slices():
    # sde: one K1 launch per source frame (all 4 scale grids) and one K2
    # launch per source frame (identity loss) in every step
    launches = {"sde_supervised": _run_slice(
        "slice sde", _packaged_cfg("sde_supervised_synthetic.yml"),
        {"warp": 2, "reprojection": 2, "reprojection_grad": 0})}
    # exp-212: two photometric passes (labeled, unlabeled) per step, each one
    # K1 launch per source frame, one K2 launch per source frame for the
    # identity error and one for the pred error of all 4 scales, and one K3
    # launch per source frame in the backward
    cfg = _packaged_cfg("exp212_pad_online_synthetic.yml")
    launches["exp212_pad_online"] = _run_slice(
        "slice exp212", cfg, {"warp": 4, "reprojection": 8, "reprojection_grad": 4})
    cfg = _packaged_cfg("exp212_pad_online_synthetic.yml")
    cfg["training"]["fused_reprojection"] = False
    launches["exp212_pad_online_unfused"] = _run_slice(
        "slice exp212 unfused", cfg, {"warp": 4, "reprojection": 4, "reprojection_grad": 0})
    # exp-210: a segmentation-only model, no photometric loss, no kernel
    launches["exp210_depthcomp"] = _run_slice(
        "slice exp210", _packaged_cfg("exp210_depthcomp_synthetic.yml"),
        {"warp": 0, "reprojection": 0, "reprojection_grad": 0})
    # validation: exp-212's 3 steps as above, validated after steps 2 and 3
    # over 2 batches of 4; each batch warps each source frame once (K1) and
    # takes its identity and pred errors through K2, without a backward
    cfg = _packaged_cfg("exp212_pad_online_synthetic.yml")
    cfg["training"].update(val_interval=2, val_batch_size=4)
    cfg["data"]["n_samples"] = 8
    launches["exp212_pad_online_validated"] = _run_slice(
        "eval exp212", cfg, {"warp": 4, "reprojection": 8, "reprojection_grad": 4},
        per_val_batch={"warp": 2, "reprojection": 4, "reprojection_grad": 0}, n_validations=2)
    launches["sde_supervised_eval_step"] = _eval_step_once(
        "eval step sde", "sde_supervised_synthetic.yml")
    launches["exp212_pad_online_eval_step"] = _eval_step_once(
        "eval step exp212", "exp212_pad_online_synthetic.yml")
    return launches


def main():
    phase_device()
    phase_build()
    records = phase_kernels()
    phase_small_steps()
    launches = phase_slices()
    main_path = launches["exp212_pad_online"]
    pkg = Path(PKG)
    kernels = []
    for key, name, source, replaces in (
            ("warp", "warp_bilinear_nchw", "csrc/warp.cu", K1_REPLACES),
            ("reprojection", "reprojection_error", "csrc/reprojection.cu", K2_REPLACES),
            ("reprojection_grad", "reprojection_error_grad", "csrc/reprojection.cu",
             K3_REPLACES)):
        kernels.append({"name": name, "route": "cuda", "source": str(pkg / source),
                        "replaces": replaces, "launches": main_path[key],
                        "launches_by_path": {p: c[key] for p, c in launches.items()},
                        **records[key]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
