"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card, its power limit, the torch/CUDA versions, TF32 flags;
  2. build: compiles the port's CUDA kernels (csrc/*.cu) with nvcc and
     prints each kernel's registers, spills and SASS instruction counts;
  3. kernels: each kernel (K1 warp, K2 fused SSIM+L1 error, K3 its
     gradient) against its plain PyTorch version on the card, at the
     main-path shapes, at odd shapes and at the edges of K2/K3's tiles, with
     times (at the main path's batch-2 shapes, and at the synthetic
     exp-212's batch 4) of both, of one PyTorch reference call where there
     is one (each the median of one-call CUDA-event timings), and the least
     time the card
     could take (bytes over its memory rate, or operations over its f32 rate);
     K1's and `F.grid_sample`'s device times (profiler) at K1's main shape,
     on per-pixel random and on smooth grids;
  4. small steps: one small train step on the card against the same step on
     the CPU (losses, gradients, parameters), for the supervised SDE step and
     for the exp-212 step; a second
     exp-212 step on each device checks the EMA update at alpha 0.5; the
     exp-212 eval step on the card against the CPU;
  5. slices: the packaged configs through `train_main` (the trainer entry
     point; `train_iters` 4 runs 3 steps, as the JAX trainer counts) at full
     width on the synthetic dataset through the threaded loaders, counting
     kernel launches from 0 around each run: `sde_supervised`,
     `exp212_pad_online` with fused_reprojection on and the same with it
     off, `exp210_depthcomp` (no kernel), and exp-212 validated after steps
     1 and 3 over 2 batches of 4 (the eval path: K1 and K2 per batch); then
     the eval step alone at full width, for `sde_supervised` and exp-212,
     with its launches, times and peak memory;
  6. sde_pretrain: SDE pretraining, phase 1 then phase 2, through
     `train_main` at full width (ResNet-101 dilated, dec6 + ASPP, ResNet-18
     pose, batch 4 at 512x512): seeded stand-in weights in the published
     `.pth` layouts are written into a temporary SDT_MODEL_DIR; dec5 (frozen
     ImageNet backbone, Adam) runs 3 steps validated after steps 1 and 3 and
     exports its components; dec6 (bf16 amp, the ImageNet encoder and its
     feature distance) loads them and runs 3 steps the same way. Checks the
     frozen encoder bit for bit, its moving BatchNorm statistics, the pose
     encoder's two-frame conv1, the loaded components and the feature
     distance; prints step times, peak memory, launches per step and per
     validation batch, validation time per batch and the ImageNet encoder's
     forward time. The small-steps phase also holds a small dec6 step card
     vs CPU in f32 and in bf16 (amp, `torch.autocast` on both devices; the
     losses), and the bf16 backward of a smooth function of the dec6
     model's outputs, card vs CPU, against the CPU's f32 backward;
  7. cityscapes_exp212 (the main path): a generated tree in the Cityscapes
     layout (16 train and 8 val frames: 1024x512 JPEGs at q98 with their
     sequence neighbours, 2048x1024 label-id PNGs) read by the data layer;
     `configs/exp212_pad_online_cityscapes.yml` through `train_main` at full
     width: 4 steps of batch 2 + 2, validated at 512x1024 after steps 1, 3
     and 4, best and last full-state checkpoints; then a second run with
     `auto_resume` whose loaded state must equal the first run's last state
     bit for bit and which must take exactly the remaining 2 steps. K1 and
     K2 held against their plain versions at the validation shape. Prints
     the package versions and cores, validation time per batch, the time the
     loop waited for each validation's checkpoint save (best and last from
     one host snapshot) and the last save's copy to the host and file
     writes, peak memory and the launches per step and per validation
     batch; then, on a larger tree (40 train frames, 20 labeled) whose
     epochs each hold a window, the time per step in windows of 8 steps
     between two syncs, in turns: fed by the loaders, from host batches the
     loaders pinned beforehand (the copies and transposes alone, no loader
     thread running) and from the same batches resident on the device, with
     the time waiting on the loaders and issuing the copies;
  8. exp211 (automatic label selection, `configs/exp211_label_selection_*.yml`):
     seeded stand-ins of the ResNet-101 dec6 depth teacher and of
     `imnet/resnet50.pth` in a temporary SDT_MODEL_DIR; (a) on a generated
     Cityscapes tree (16 + 8 frames) the teacher writes its 24 pseudo-depth
     PNGs (time per image; a second call writes none; 2 images within 1
     grey level of the CPU's), then the driver's `train_on_subset` trains
     8 fixed frames for 3 steps of batch 2 at 512x512 reading them,
     validated at 512x1024 after steps 1 and 3, and returns its
     `best_model`; the step's profile (`profile_cli.measure`), peak memory,
     launches per step and per validation batch (K1-K3: 0); (b)
     `label_selection_main` on 24 synthetic samples at 512x1024, rounds
     [4, 8] of 3 steps, timed by part (teacher features and scoring per
     sample, distances, IFP, each round), with its subsets checked (sizes,
     distinct, nested, the subset files, the models removed), then
     `acquire_scores` on 4 samples card against CPU (cuDNN TF32 off):
     label criteria and distances within 1e-3;
  9. experiments (the experiment CLIs): seeded stand-ins of the published
     SDE components (`mono_cityscapes_1024x512_r101dil_aspp_dec6_lr5_fd2_
     crop512x512bs4/{encoder,depth,pose_encoder,pose}.pth`) in a temporary
     SDT_MODEL_DIR; (a) `run_experiments(configs/cityscapes_joint.yml, 212,
     runs=[0], strict=True)`, the generated `pad_transfer_dcompgt0030` trial
     at full width (ResNet-101 dilated, dec6 + ASPP, PAD, pose ResNet-18,
     batch 2 + 2 at 512x512 crops of a generated 16 + 8 frame Cityscapes
     tree, `debug_image` on) on the JAX smoke budgets with its own overrides
     (3 steps validated after steps 1 and 3, 8 labeled frames, best
     checkpoint, print_interval 1): the trial YAML, launches per step and
     per validation batch, peak memory, the mix debug tensors of every step
     (shapes, mask in {0, 1}, pseudo-labels, depths in [0, 1]) and their
     `class_mix_debug` images where matplotlib is installed, then the
     step's profile; (b) `test_experiments_cli.main(["--synthetic",
     "--strict"])`: all 10 generated trials of 210, 211 and 212 at resnet18
     and 64x96, each timed; (c) `export_cli` on (a)'s run dir at 512x1024,
     at batch 1 and with a symbolic batch: sizes, export times, the
     artifacts against the eager model (cuDNN TF32 off) and times per
     image; (d) `inference_cli` over the tree's 8 validation images from
     (a)'s run dir: every input's PNGs, the labels against the artifact's
     argmax and the depths within 1 grey level, time per image by part;
 10. options (the model and step options): each cell through `train_main`
     at full width on the synthetic dataset (3 steps, exact launches per
     step), then timed (`profile_cli.measure`: step median, device time,
     idle share, peak memory) in turns with its packaged config: (a)
     exp-212 with `fuse_unlabeled_forward` (one 2N forward and photometric
     pass: K1 2, K2 4, K3 2 per step against 4, 8, 4) and then also
     `model.remat` (peak memory, the recompute's device time); (b) sde with
     `remat_photometric`, its photometric loss and parameter gradients on
     one batch held equal to the stored chain's and K1 never launched in a
     backward (`pred_layout: nhwc` runs the same packed warp and is not a
     cell of its own); (c) exp-210 with `fuse_unlabeled_forward` (labeled + mixed,
     no kernel); (d) small sde steps (resnet18, 64x128) card against CPU
     with the depth decoder's `n_project_skip_ch`, `aspp_pooling` off and
     `dropout` 0, with `use_skips` off, `pose_model_input: all`,
     `provide_uncropped_for_pose` and a stereo frame, then channel-wise
     dropout on the card (each module of a model its own stream).
The last three lines are the card's name and power limit (as at the
start), the kernels' JSON record and `{"ok": true, "device": {...}}`. Any failure raises, so the exit code is
nonzero and no `ok` line is printed. There is no CPU fallback.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.metadata
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from improving_segmentation_with_selfsupervised_depth_tpu_torch.cli import profile_cli
from improving_segmentation_with_selfsupervised_depth_tpu_torch.config.machine import (
    expand_cfg_vars,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data import synthetic
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic_dataset import (
    SyntheticDataset,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine import (
    checkpoints,
    depth_estimator,
    optim,
    state,
    train_steps,
    trainer,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.label_selection import driver
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models import joint, layers
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.pose_decoder import (
    PoseDecoder,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.models.resnet import (
    ResNetEncoder,
    num_ch_enc,
)
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
# the small f32 steps' gradients, card vs CPU, |card - cpu| / |cpu|: f32
# op-order rounding flips the photometric min's near-ties on random weights,
# which moves gradients by 1-4% of a tensor's largest element between the
# port and JAX, and by 1.4% between 1 and 6 CPU threads
# (tests/test_torch_port_sde_pretrain.py); measured card vs CPU: 1.2e-2
# (sde), 2.9e-3 (exp-212), 1.5e-3 (dec6). A wrong backward is off by O(1).
STEP_GRAD_RTOL = 5e-2
# the small bf16 (amp) step, card vs CPU autocast: both round to bf16 at the
# same points (8 significant bits), in other accumulation orders; a bf16
# model's outputs lie up to ~10% of their largest value from another bf16
# implementation of the same model (tests/test_torch_port_sde_pretrain.py,
# the port against the JAX package), and the losses average that over every
# pixel.
BF16_LOSS_RTOL = 2e-2
# The bf16 backward, card vs CPU, on a smooth function of the model's
# outputs (the photometric min's choices flip under bf16 rounding, so the
# step's own gradients are not compared). Per submodule, the card's bf16
# gradient lies at most BF16_GRAD_OFF times as far from the CPU's f32
# gradient as the CPU's bf16 gradient does, and at most BF16_GRAD_APART
# times that far from the CPU's bf16 gradient (two independent bf16 noises
# of equal size lie sqrt(2) apart). The same bounds hold the port's bf16
# backward against the JAX bf16 model's on the CPU, with ratios 0.99-1.29
# and 1.06-1.47 (tests/test_torch_port_sde_pretrain.py).
BF16_GRAD_OFF = 1.5
BF16_GRAD_APART = 2.0

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


def _time_k1(img, grids, n, s, h, w):
    """K1's times at one shape: the kernel, its plain version, the PyTorch
    reference (`out` plane only) and the bound."""
    ix, iy = (t.contiguous() for t in warp.unnormalize_grid(grids, h, w))
    ms = _time_ms(lambda: warp.warp_bilinear_nchw(img, ix, iy, reps=s))
    plain_ms = _time_ms(lambda: warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s))
    img_rep = img.repeat_interleave(s, 0)
    lib_ms = _time_ms(lambda: F.grid_sample(img_rep, grids, mode="bilinear",
                                            padding_mode="border", align_corners=True))
    m = n * s
    bound_ms, bound_by = _bound(4 * (n * 3 * h * w + 2 * m * h * w + 3 * m * 3 * h * w),
                                m * h * w * (K1_OPS_PER_PIXEL + 3 * K1_OPS_PER_CHANNEL))
    return {"shape": [n, 3, h, w], "reps": s, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _time_k2_k3(pred, target, g, n, reps, h, w):
    """K2's times at one shape and, for the pred error (reps 4), K3's, with
    autograd's backward of the plain chain as K3's PyTorch reference."""
    m, px, f32 = n * reps, h * w, 4
    ms = _time_ms(lambda: reprojection.reprojection_error(pred, target, reps))
    plain_ms = _time_ms(lambda: reprojection.reprojection_error_plain(pred, target, reps))
    bound_ms, bound_by = _bound(f32 * (m * 3 * px + n * 3 * px + m * px), m * 3 * px * K2_OPS)
    k2 = {"shape": [m, 3, h, w], "reps": reps, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    if reps == 1:
        return k2, None
    dms = _time_ms(lambda: reprojection.reprojection_error_grad(pred, target, g, reps))
    dplain_ms = _time_ms(lambda: reprojection.reprojection_error_grad_plain(pred, target, g, reps))
    leaf = pred.clone().requires_grad_()
    chain = reprojection.reprojection_error_plain(leaf, target, reps)
    lib_ms = _time_ms(lambda: torch.autograd.grad(chain, leaf, g, retain_graph=True))
    del chain, leaf
    dbound_ms, dbound_by = _bound(f32 * (2 * m * 3 * px + n * 3 * px + m * px),
                                  m * 3 * px * K3_OPS)
    k3 = {"shape": [m, 3, h, w], "reps": reps, "ms": dms, "plain_ms": dplain_ms,
          "bound_ms": dbound_ms, "bound_by": dbound_by, "library_ms": lib_ms}
    return k2, k3


def phase_kernels():
    """Each kernel against its plain version at every full-width training
    shape the sde and exp-212 paths give it (512^2, batch 8, 4 and 2) and at
    odd shapes (the Cityscapes validation shape: `_kernels_at_val_shape`);
    times at the main path's shape (exp-212 on the Cityscapes tree: batch
    2, 4 scales per frame), which the record's `ms`, `plain_ms`, `bound_ms`
    and `library_ms` belong to, and under `exp212_synthetic_batch4` at the
    synthetic exp-212 shape (batch 4) that earlier records were timed at."""
    records = {}
    b4 = "exp212_synthetic_batch4"

    # K1: one launch per source frame warps the frame at its 4 scale grids;
    # the main path (batch 2, timed), synthetic exp-212 (batch 4, timed), sde
    # (batch 8) and an odd shape
    for i, (n, s, h, w) in enumerate(((2, 4, 512, 512), (4, 4, 512, 512), (8, 4, 512, 512),
                                      (2, 2, 37, 61))):
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
        if i > 1:
            continue
        rec = _time_k1(img, grids, n, s, h, w)
        print(f"[kernels] K1 warp {'main' if i == 0 else 'synthetic exp-212'} shape "
              f"{(n, 3, h, w)} S={s}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
              f"ms, F.grid_sample (out plane only, partial) {rec['library_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        if i == 1:
            records["warp"][b4] = rec
            continue
        records["warp"] = {"max_abs_err": max(errs), **rec,
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
    # scales against one target (reps 4), and the identity error (reps 1),
    # timed at the main path's batch 2 and at synthetic exp-212's batch 4; the
    # identity error of sde (batch 8); odd shapes with reps 1 and 2; the
    # strips' edges (H not a multiple of the row tile, W odd and not a
    # multiple of the strip, H and W of 2 and 3, where the folds of rows 0
    # and H+1 meet); more than 65,535 planes (21,846 x 3)
    timed = {(2, 4): "main", (4, 4): b4, (2, 1): "main", (4, 1): b4}
    for n, reps, h, w in ((2, 4, 512, 512), (4, 4, 512, 512), (2, 1, 512, 512),
                          (4, 1, 512, 512), (8, 1, 512, 512), (2, 1, 37, 61), (2, 2, 37, 61),
                          (1, 4, 50, 97), (2, 1, 2, 3), (2, 1, 3, 2), (1, 2, 3, 3),
                          (21846, 1, 2, 2)):
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
        if "reprojection" not in records:
            records["reprojection"] = {"max_abs_err": err}
            records["reprojection_grad"] = {"max_abs_err": derr, "max_abs_plain": dscale}
        records["reprojection"]["max_abs_err"] = max(records["reprojection"]["max_abs_err"], err)
        records["reprojection_grad"]["max_abs_err"] = max(
            records["reprojection_grad"]["max_abs_err"], derr)
        where = timed.get((n, reps)) if (h, w) == (512, 512) else None
        if where is None:
            continue
        k2, k3 = _time_k2_k3(pred, target, g, n, reps, h, w)
        what = "main" if where == "main" else "synthetic exp-212"
        print(f"[kernels] K2 reprojection {what} {'pred' if k3 else 'identity'} shape {shape}: "
              f"kernel {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, bound "
              f"{k2['bound_ms']:.4f} ms ({k2['bound_by']})")
        if k3:
            print(f"[kernels] K3 reprojection grad {what} shape {shape}: kernel "
                  f"{k3['ms']:.4f} ms, plain {k3['plain_ms']:.4f} ms, autograd of the plain "
                  f"chain {k3['library_ms']:.4f} ms, bound {k3['bound_ms']:.4f} ms "
                  f"({k3['bound_by']})")
        if where == b4:
            sub2 = records["reprojection"].setdefault(b4, {})
            if k3:
                sub2.update(k2)
                records["reprojection_grad"][b4] = k3
            else:
                sub2["identity"] = k2
        elif k3:
            records["reprojection"].update(k2)
            records["reprojection_grad"].update(
                k3, library_call="torch.autograd backward of the f32 plain SSIM+L1 chain")
        else:
            records["reprojection"]["identity"] = k2
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


def _angle(a, b):
    """The angle between two flat gradients, in degrees."""
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).clamp(-1.0, 1.0)
    return math.degrees(math.acos(float(cos)))


def _option_frames(batch, stereo):
    """The batch with the uncropped pose inputs `color_full_aug_{f}_0` (the
    frames mirrored) and, with `stereo`, a stereo frame "s" (the target
    shifted by 4 pixels) with `stereo_T` (a 0.1 baseline along x)."""
    batch = dict(batch)
    for f in (0, -1, 1):
        batch[f"color_full_aug_{f}_0"] = np.ascontiguousarray(batch[f"color_aug_{f}_0"][:, :, ::-1])
    if stereo:
        n = batch["color_0_0"].shape[0]
        batch["color_s_0"] = np.roll(batch["color_0_0"], 4, axis=2)
        batch["color_aug_s_0"] = np.roll(batch["color_aug_0_0"], 4, axis=2)
        batch["stereo_T"] = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
        batch["stereo_T"][:, 0, 3] = 0.1
    return batch


def _small_step(label, cfg_name, n, amp=False, model_opts=None):
    """A small train step (resnet18, 64x128, batch n) on the card (kernels)
    against the same step on the CPU (plain versions): same weights, batches
    and draws, f32 convolutions on both sides. Checks the losses, the
    gradients, the parameters and, for the semi-supervised step, the EMA
    teacher's parameters after the step.

    The semi-supervised step then runs a second time on each device, and
    the teacher must be exactly 0.5 teacher + 0.5 student in the EMA's
    submodules and unchanged elsewhere (the first update copies the
    student). The second step is not compared card vs CPU: its pseudo-label
    threshold and depthcomp mask turn the first step's rounding differences
    into discrete flips.

    With `amp` the model runs under bf16 autocast on both devices and only
    the losses are held, to BF16_LOSS_RTOL: `_small_amp_backward` holds the
    bf16 backward. `model_opts` updates the model's config (`frame_ids`
    the photometric loss's too); the batch carries the uncropped pose
    inputs and, with a stereo frame, its image and `stereo_T`. Returns the
    step config."""
    cfg = _packaged_cfg(cfg_name)
    cfg["model"]["backbone_name"] = "resnet18"
    cfg["model"]["depth_args"] = {"intermediate_aspp": True, "aspp_rates": [1, 2]}
    cfg["model"].update(model_opts or {})
    if "frame_ids" in cfg["model"]:
        cfg["monodepth_options"]["frame_ids"] = cfg["model"]["frame_ids"]
    cfg["training"]["photometric_dtype"] = None
    cfg["training"]["amp"] = amp  # amp: the model and the SSIM/L1 chain in bf16
    h, w = 64, 128
    step_cfg = train_steps.step_config_from_cfg(cfg)
    devices = ("cpu", "cuda")
    torch.manual_seed(0)
    models = [_no_dropout(joint.build_model(cfg["model"], 19, amp=amp))]
    models.append(copy.deepcopy(models[0]).to(devices[1]))
    stereo = "s" in step_cfg.frame_ids
    batch = _option_frames(synthetic.make_synthetic_batch(n, h, w, seed=3), stereo)
    ubatch = _option_frames(synthetic.make_synthetic_batch(n, h, w, seed=4,
                                                           with_unlabeled_extras=True), stereo)
    gen = torch.Generator().manual_seed(5)
    n_src = len(step_cfg.frame_ids) - 1
    noise, noise_u = (torch.randn((n, n_src, h, w), generator=gen) for _ in range(2))
    results, after, grads = [], [], []
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
            grads.append(torch.cat([p.grad.detach().double().cpu().flatten()
                                    for p in model.parameters() if p.grad is not None]))
            if step_cfg.use_ema:
                after[-1]["EMA params"] = _params(kw["teacher"])
                second = step()
                print(f"[{label}] {dev} second step: total_loss {second['total_loss']:.7f}")
                _check_ema_mix(label, dev, after[-1]["EMA params"], _params(model),
                               _params(kw["teacher"]), step_cfg.ema_names)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rel = float((grads[1] - grads[0]).norm() / grads[0].norm())
    print(f"[{label}] gradients card vs cpu: {_angle(grads[0], grads[1]):.4f} degrees apart, "
          f"|card - cpu| / |cpu| {rel:.3e}" + ("" if amp else f" (at most {STEP_GRAD_RTOL:g})"))
    rtol = BF16_LOSS_RTOL if amp else STEP_RTOL
    for k in results[0]:
        a, b = results[0][k], results[1][k]
        print(f"[{label}] {k}: cpu {a:.7f} card {b:.7f} (rtol {rtol:g})")
        if not (math.isfinite(b) and abs(a - b) <= rtol * abs(a)):
            raise AssertionError(f"{label} {k}: card {b} vs cpu {a}")
    if amp:
        return step_cfg
    if not rel <= STEP_GRAD_RTOL:
        raise AssertionError(f"{label}: gradients card vs cpu differ by {rel}")
    for what in after[0]:
        cpu_p, dev_p = after[0][what], after[1][what]
        diff = max(float((dev_p[k].cpu() - cpu_p[k]).abs().max()) for k in cpu_p)
        print(f"[{label}] max |{what} card - {what} cpu| after the step: {diff:.3e}")
        if not diff <= 1e-4:
            raise AssertionError(f"{label}: {what} differ by {diff}")
    return step_cfg


def _small_amp_backward(label, cfg_name, n):
    """The model's backward under amp (resnet18, 64x128, batch n, train
    mode) on the card against the CPU's, both in bf16 autocast, anchored on
    the CPU's f32 backward: the parameter gradients of a smooth function of
    the outputs, random projections of the disparities and poses plus the
    feature distance (`training.feat_dist_lambda`), per submodule, held to
    BF16_GRAD_OFF and BF16_GRAD_APART. The depth decoder's kernels are
    halved, as the parity tests condition them: a random decoder saturates
    the disparity's sigmoid, whose gradient the bf16 logits' rounding then
    sets (CPU bf16 from f32: 98% of the decoder gradient's norm, 10% once
    halved)."""
    cfg = _packaged_cfg(cfg_name)
    cfg["model"]["backbone_name"] = "resnet18"
    cfg["model"]["depth_args"] = {"intermediate_aspp": True, "aspp_rates": [1, 2]}
    feat_dist = cfg["training"]["feat_dist_lambda"]
    torch.manual_seed(0)
    model = _no_dropout(joint.build_model(cfg["model"], 19))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("models.depth.") and p.dim() == 4:
                p.mul_(0.5)
    batch = synthetic.make_synthetic_batch(n, 64, 128, seed=8)
    gen = torch.Generator().manual_seed(9)
    projections, grads = None, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev, amp in (("cpu", False), ("cpu", True), ("cuda", True)):
            m = copy.deepcopy(model).to(dev)
            m.amp = amp
            m.train()
            out = m(synthetic.to_device_batch(batch, dev))
            if projections is None:
                projections = {k: torch.randn(out[k].shape, generator=gen) for k in sorted(out)
                               if k.startswith(("disp_", "axisangle_", "translation_"))}
            loss = sum((out[k].float() * r.to(dev)).mean() for k, r in projections.items())
            d = out["encoder_features"].float() - out["imnet_features"].float()
            (loss + feat_dist * torch.sqrt((d * d).sum())).backward()
            grads[dev, amp] = {k: p.grad.detach().double().cpu()
                               for k, p in m.named_parameters() if p.grad is not None}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for top in ("encoder", "depth", "pose_encoder", "pose"):
        keys = [k for k in grads["cpu", False] if k.split(".")[1] == top]
        f32, cpu16, card16 = (torch.cat([g[k].flatten() for k in keys])
                              for g in (grads["cpu", False], grads["cpu", True],
                                        grads["cuda", True]))
        scale = float(f32.norm())
        noise = float((cpu16 - f32).norm())
        off, apart = float((card16 - f32).norm()), float((card16 - cpu16).norm())
        print(f"[{label}] {top}: |bf16 - f32| / |f32| cpu {noise / scale:.3e}, card "
              f"{off / scale:.3e} (at most {BF16_GRAD_OFF:g} x the cpu's); |card - cpu| "
              f"{apart / scale:.3e} (at most {BF16_GRAD_APART:g} x)")
        if not (0 < off <= BF16_GRAD_OFF * noise and apart <= BF16_GRAD_APART * noise):
            raise AssertionError(f"{label} {top}: card bf16 {off / scale} from f32, "
                                 f"{apart / scale} from the cpu's bf16; cpu {noise / scale}")


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
    # the dec6 step (Adam, the frozen ImageNet encoder, the feature distance)
    # in f32, then with amp, then the bf16 backward alone
    step_cfg = _small_step("small sde_dec6 step, f32", "sde_dec6_crop_synthetic.yml", 4)
    if not step_cfg.feat_dist_lambda > 0:
        raise AssertionError("the dec6 small step must run the feature distance")
    _small_step("small sde_dec6 step, amp (bf16)", "sde_dec6_crop_synthetic.yml", 4, amp=True)
    _small_amp_backward("small sde_dec6 backward, amp (bf16)", "sde_dec6_crop_synthetic.yml", 4)


def _reset_launches():
    warp.warp_bilinear_nchw.launches = 0
    reprojection.reprojection_error.launches = 0
    reprojection.reprojection_error_grad.launches = 0


def _read_launches():
    return {"warp": warp.warp_bilinear_nchw.launches,
            "reprojection": reprojection.reprojection_error.launches,
            "reprojection_grad": reprojection.reprojection_error_grad.launches}


def _run_slice(label, cfg, per_step, per_val_batch=None, n_validations=0, run=None):
    """`cfg` through train_main (on `run`, as `trainer.build_run` made it, or
    a new one); checks finite moving losses and the kernel launches:
    `per_step` of each kernel in every step and, with
    `training.val_interval`, `per_val_batch` in every batch of each of the
    `n_validations` validations, whose records it checks too (mIoU only
    where the model segments). A run from scratch takes train_iters - 1
    steps."""
    n_steps = cfg["training"]["train_iters"] - 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    records = trainer.train_main(cfg, device="cuda:0", run=run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    m, mono = cfg["model"], cfg["monodepth_options"]
    print(f"[{label}] {m['backbone_name']} dilated {m['replace_stride_with_dilation']}, "
          f"{m['segmentation_name']}, num_ch_dec {m['depth_args']['num_ch_dec']}, "
          f"monodepth {not m.get('disable_monodepth', False)}, pose "
          f"{not m.get('disable_pose', False)}, batch {cfg['training']['batch_size']} at "
          f"{mono.get('crop_h', mono['height'])}x{mono.get('crop_w', mono['width'])}, "
          f"fused_reprojection {cfg['training'].get('fused_reprojection', False)}, "
          f"{n_steps} steps")
    validations = []
    for i, r in enumerate(records, start=1):
        losses = " ".join(f"{k} {v:.6f}" for k, v in r.items()
                          if k.endswith("loss") and not k.startswith("val/"))
        print(f"[{label}] step {i}: {losses}  dispatch {r['step_seconds']:.4f} s, waiting "
              f"on the loaders {r['data_seconds']:.4f} s")
        val = {k[4:]: v for k, v in r.items() if k.startswith("val/")}
        if val:
            validations.append(val)
            print(f"[{label}] validation after step {i}: " + " ".join(
                f"{k} {v:.6f}" for k, v in val.items()))
    print(f"[{label}] train_main {wall:.3f} s for {n_steps} steps and "
          f"{sum(any(k.startswith('val/') for k in r) for r in records)} validations; peak memory allocated {peak / 2**30:.3f} GiB; launches {launches}")
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
    segments = cfg["training"].get("segmentation_lambda", 1.0) > 0
    for val in validations:
        best = max(best, val.get("Mean IoU", 0.0))
        if not ((0 <= val["Mean IoU"] <= 1) if segments else "Mean IoU" not in val) \
                or val["best_iou"] != best \
                or len([k for k in val if k.startswith("depth/")]) != 7:
            raise AssertionError(f"{label}: validation record {val}")
    if validations:
        print(f"[{label}] validation time per batch: " + ", ".join(
            f"{v['eval_seconds_per_batch']:.4f} s" for v in validations))
    expect = {k: v * n_steps for k, v in per_step.items()}
    if n_validations:
        vcfg = cfg["training"]
        batches = -(-cfg["data"]["n_samples"] // vcfg.get("val_batch_size",
                                                            vcfg["batch_size"]))
        expect = {k: v + per_val_batch[k] * batches * n_validations for k, v in expect.items()}
    if launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expect}")
    return launches, records


def _eval_step_once(label, cfg_name):
    """One eval step of a packaged config at full width, on its first
    validation batch (`val_batch_size`, default the training batch): K1 2 and
    K2 4 launches, K3 none. Then its host time (the first call's and the
    median of 5 more), its device time per call (profiler) and the peak
    memory of one call."""
    run = trainer.build_run(_packaged_cfg(cfg_name), "cuda:0")
    batch = next(run.val_batches())
    run.close()
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
        {"warp": 2, "reprojection": 2, "reprojection_grad": 0})[0]}
    # exp-212: two photometric passes (labeled, unlabeled) per step, each one
    # K1 launch per source frame, one K2 launch per source frame for the
    # identity error and one for the pred error of all 4 scales, and one K3
    # launch per source frame in the backward
    cfg = _packaged_cfg("exp212_pad_online_synthetic.yml")
    launches["exp212_pad_online"] = _run_slice(
        "slice exp212", cfg, {"warp": 4, "reprojection": 8, "reprojection_grad": 4})[0]
    cfg = _packaged_cfg("exp212_pad_online_synthetic.yml")
    cfg["training"]["fused_reprojection"] = False
    launches["exp212_pad_online_unfused"] = _run_slice(
        "slice exp212 unfused", cfg, {"warp": 4, "reprojection": 4, "reprojection_grad": 0})[0]
    # exp-210: a segmentation-only model, no photometric loss, no kernel
    launches["exp210_depthcomp"] = _run_slice(
        "slice exp210", _packaged_cfg("exp210_depthcomp_synthetic.yml"),
        {"warp": 0, "reprojection": 0, "reprojection_grad": 0})[0]
    # validation: exp-212's 3 steps as above, validated after steps 1 and 3
    # over 2 batches of 4; each batch warps each source frame once (K1) and
    # takes its identity and pred errors through K2, without a backward
    cfg = _packaged_cfg("exp212_pad_online_synthetic.yml")
    cfg["training"].update(val_interval=2, val_batch_size=4)
    cfg["data"]["n_samples"] = 8
    launches["exp212_pad_online_validated"] = _run_slice(
        "eval exp212", cfg, {"warp": 4, "reprojection": 8, "reprojection_grad": 4},
        per_val_batch={"warp": 2, "reprojection": 4, "reprojection_grad": 0}, n_validations=2)[0]
    launches["sde_supervised_eval_step"] = _eval_step_once(
        "eval step sde", "sde_supervised_synthetic.yml")
    launches["exp212_pad_online_eval_step"] = _eval_step_once(
        "eval step exp212", "exp212_pad_online_synthetic.yml")
    return launches


def _torchvision_resnet(depth, seed):
    """Seeded stand-in ImageNet weights in torchvision's ResNet layout (keys
    without the `encoder.` prefix, the `fc` head included)."""
    gen = torch.Generator().manual_seed(seed)
    sd = ResNetEncoder(depth).encoder.state_dict()
    for k, v in sd.items():
        if v.is_floating_point():  # running variances around 1, the rest small
            v.copy_(torch.randn(v.shape, generator=gen) * 0.02 + (1.0 if "var" in k else 0.0))
    width = 512 if depth < 50 else 2048
    sd["fc.weight"] = torch.randn((1000, width), generator=gen) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd


SDE_PER_STEP = {"warp": 2, "reprojection": 2, "reprojection_grad": 0}
SDE_PER_VAL_BATCH = {"warp": 2, "reprojection": 4, "reprojection_grad": 0}


def _count_launches(fn):
    _reset_launches()
    fn()
    torch.cuda.synchronize()
    return _read_launches()


def _sde_extras(label, run):
    """One more train step and one validation batch, each counted alone, the
    optimizer update's device time (profiler), and the ImageNet encoder's
    forward time (CUDA events, median of 10) where the model has one."""
    batch, _ = run.device_batches()
    per_step = _count_launches(lambda: run.step(batch, None))
    val_batch = next(run.val_batches())
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    per_val = _count_launches(lambda: train_steps.eval_step(run.model, val_batch, run.step_cfg,
                                                            generator=gen))
    print(f"[{label}] launches of one train step {per_step}, of one validation batch "
          f"{per_val}")
    # the optimizer's update alone, on the gradients the step left
    opt_ms, opt_kernels, _ = _device_ms(run.optimizer.step, reps=3)
    params = [p for g in run.optimizer.groups for p in g["params"]]
    n = sum(p.numel() for p in params)
    # one pass of Adam reads p, g, mu, nu and writes p, mu, nu: 28 bytes each
    print(f"[{label}] {type(run.optimizer).__name__} update: device {opt_ms:.3f} ms, "
          f"{opt_kernels:g} kernels per step, over {n} parameters in {len(params)} "
          f"tensors (one fused pass: {28 * n / HBM_BYTES_PER_S * 1e3:.3f} ms of bytes)")
    if per_step != SDE_PER_STEP or per_val != SDE_PER_VAL_BATCH:
        raise AssertionError(f"{label}: launches {per_step}, {per_val}")
    if "imnet_encoder" in run.model.models:
        img = batch["color_aug_0_0"]
        encoder = run.model.models["imnet_encoder"]
        for amp in (True, False):
            with torch.no_grad(), torch.autocast("cuda", torch.bfloat16, enabled=amp):
                ms = _time_ms(lambda: encoder(img), reps=10)
            print(f"[{label}] ImageNet encoder forward, batch {img.shape[0]} at "
                  f"{tuple(img.shape[2:])}, {'bf16 autocast' if amp else 'f32'}: {ms:.3f} ms")


def phase_sde_pretrain():
    """SDE pretraining dec5 -> dec6 through train_main, from seeded stand-in
    weights in a temporary SDT_MODEL_DIR (see the module docstring)."""
    saved_env = {k: os.environ.get(k) for k in ("SDT_MODEL_DIR", "SDT_OUT_DIR")}
    model_dir = tempfile.mkdtemp(prefix="sde_models_")
    out_dir = tempfile.mkdtemp(prefix="sde_out_")
    os.environ.update(SDT_MODEL_DIR=model_dir, SDT_OUT_DIR=out_dir)
    launches = {}
    try:
        imnet = Path(model_dir) / "imnet"
        imnet.mkdir()
        tv101, tv18 = _torchvision_resnet(101, 1), _torchvision_resnet(18, 2)
        torch.save(tv101, imnet / "resnet101.pth")
        torch.save(tv18, imnet / "resnet18.pth")
        # dec5's pose source: a ResNet-18 in the reference encoder layout with
        # the one-frame conv1 (loaded through the two-frame adaptation), and a
        # seeded pose decoder
        pose_src = Path(model_dir) / "mono_cityscapes_1024x512_r101dil_aspp_dec5"
        pose_src.mkdir()
        torch.save({"encoder." + k: v for k, v in tv18.items() if not k.startswith("fc.")},
                   pose_src / "pose_encoder.pth")
        torch.manual_seed(3)
        torch.save(PoseDecoder(num_ch_enc(18), 1, 2).state_dict(), pose_src / "pose.pth")
        print(f"[sde_pretrain] stand-in weights (seeded, random) in {model_dir}: "
              f"{sorted(str(p.relative_to(model_dir)) for p in Path(model_dir).rglob('*.pth'))}")

        cfg5 = _packaged_cfg("sde_dec5_crop_synthetic.yml")
        run5 = trainer.build_run(cfg5, "cuda:0")
        enc0 = {k: v.detach().cpu().clone()
                for k, v in run5.model.models["encoder"].state_dict().items()}
        conv1 = run5.model.models["pose_encoder"].encoder.conv1.weight.detach().cpu()
        if not torch.equal(conv1, torch.cat([tv18["conv1.weight"]] * 2, dim=1) / 2):
            raise AssertionError("dec5: the pose encoder's conv1 is not the ResNet-18's "
                                 "repeated over two frames and halved")
        launches["sde_dec5_crop"] = _run_slice("slice sde_dec5", cfg5, SDE_PER_STEP,
                                               SDE_PER_VAL_BATCH, n_validations=2, run=run5)[0]
        enc = {k: v.detach().cpu() for k, v in run5.model.models["encoder"].state_dict().items()}
        params = {k for k, _ in run5.model.models["encoder"].named_parameters()}
        frozen = all(torch.equal(enc[k], tv101[k[len("encoder."):]]) for k in params)
        moved = sum(not torch.equal(enc[k], enc0[k]) for k in enc if "running" in k)
        n_stats = sum("running" in k for k in enc)
        print(f"[slice sde_dec5] encoder after 3 steps: {len(params)} parameters equal to "
              f"imnet/resnet101.pth bit for bit: {frozen}; running statistics moved: "
              f"{moved} of {n_stats}")
        if not (frozen and moved == n_stats):
            raise AssertionError("dec5: the frozen encoder moved or its statistics did not")
        _sde_extras("slice sde_dec5", run5)
        export = Path(cfg5["training"]["log_path"])
        checkpoints.save_component(str(export), run5.model, "encoder")
        print(f"[sde_pretrain] wrote the dec5 run's encoder to {export.name}/encoder.pth with "
              f"checkpoints.save_component: the frozen ImageNet encoder, which the published "
              f"dec5 checkpoint ships (the dec5 export leaves it out under freeze_backbone)")
        run5.close()
        del run5
        torch.cuda.empty_cache()

        cfg6 = _packaged_cfg("sde_dec6_crop_synthetic.yml")
        run6 = trainer.build_run(cfg6, "cuda:0")
        for name in ("encoder", "depth", "pose_encoder", "pose"):
            exported = torch.load(export / f"{name}.pth", map_location="cpu", weights_only=True)
            loaded = run6.model.models[name].state_dict()
            if not all(torch.equal(loaded[k].cpu(), v) for k, v in exported.items()):
                raise AssertionError(f"dec6: {name} differs from the dec5 export")
        print("[slice sde_dec6] encoder, depth, pose_encoder and pose equal the dec5 "
              f"exports; amp {run6.model.amp}, photometric chain {run6.step_cfg.photometric_dtype}")
        launches["sde_dec6_crop_amp"], records = _run_slice(
            "slice sde_dec6 amp", cfg6, SDE_PER_STEP, SDE_PER_VAL_BATCH, n_validations=2,
            run=run6)
        feat = [r["feat_dist_loss"] for r in records]
        print(f"[slice sde_dec6 amp] feat_dist_loss per step: {feat}")
        if not (all(math.isfinite(f) and f > 0 for f in feat) and len(set(feat)) == len(feat)):
            raise AssertionError(f"dec6: feat_dist_loss {feat}")
        _sde_extras("slice sde_dec6 amp", run6)
        run6.close()
        del run6
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches


# Cityscapes label ids of the generated label maps: the 19 train classes'
# ids and two void ids (0 unlabeled, 4 static), which encode to ignore
_LABEL_IDS = np.array([7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33,
                       0, 4], np.uint8)
EXP212_CITYSCAPES_PER_STEP = {"warp": 4, "reprojection": 8, "reprojection_grad": 4}
EXP212_PER_VAL_BATCH = {"warp": 2, "reprojection": 4, "reprojection_grad": 0}


def write_cityscapes_tree(root, n_train=16, n_val=8, seed=0):
    """A tree in the layout that `data/cityscapes.py` reads at 512x1024:
    `leftImg8bit_small/{split}/<city>/<city>_<seq>_000019_leftImg8bit.jpg`
    (1024x512 JPEG at q98, as `data/prepare_cityscapes.py` writes them), the
    frames at offsets -1, 0, +1 under `leftImg8bit_sequence_small/`, and
    `gtFine/{split}/<city>/<city>_<seq>_000019_gtFine_labelIds.png` at
    2048x1024 (label ids, so the loader's NEAREST resize runs). Frames are
    upsampled low-frequency patterns with mild noise, shifted by 4 pixels
    per frame (camera motion), so that JPEG decode costs what it costs on
    real frames; label maps are upsampled random blocks."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    city = "smoketown"
    for split, n in (("train", n_train), ("val", n_val)):
        dirs = [root / tree / split / city
                for tree in ("leftImg8bit_small", "leftImg8bit_sequence_small", "gtFine")]
        for d in dirs:
            d.mkdir(parents=True)
        for i in range(n):
            base = rng.uniform(0, 255, (32, 66, 3)).astype(np.uint8)
            wide = np.asarray(Image.fromarray(base).resize((1056, 512), Image.BICUBIC),
                              np.float32)
            for off in (-1, 0, 1):
                x = 16 + 4 * off
                frame = wide[:, x: x + 1024] + rng.normal(0, 3, (512, 1024, 3))
                img = Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8))
                img.save(dirs[1] / f"{city}_{i:06d}_{19 + off:06d}_leftImg8bit.jpg", quality=98)
                if off == 0:
                    img.save(dirs[0] / f"{city}_{i:06d}_000019_leftImg8bit.jpg", quality=98)
            lbl = Image.fromarray(rng.choice(_LABEL_IDS, (16, 32)), "L")
            lbl.resize((2048, 1024), Image.NEAREST).save(
                dirs[2] / f"{city}_{i:06d}_000019_gtFine_labelIds.png")


def _host_packages():
    """The host's data-layer packages and cores, as a line."""
    parts = []
    for mod, dist in (("PIL", "pillow"), ("msgpack", "msgpack"), ("tensorboard", "tensorboard"),
                      ("psutil", "psutil"), ("matplotlib", "matplotlib")):
        found = importlib.util.find_spec(mod) is not None
        parts.append(f"{mod} {importlib.metadata.version(dist) if found else 'missing'}")
    return ", ".join(parts) + f"; {os.cpu_count()} cores"


def _run_state(run):
    """A host copy of what a full-state checkpoint holds."""
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree

    return host({"model": run.model.state_dict(), "teacher": run.teacher.state_dict(),
                 "optimizer": run.optimizer.state_dict(), "best_iou": run.best_iou,
                 "step": run.optimizer.step_count})


def _equal_trees(a, b, path=""):
    """Paths where two state trees differ (bit for bit, dtypes included)."""
    if isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))[:3]}"]
        return [d for k in b for d in _equal_trees(a[k], b[k], f"{path}/{k}")]
    if isinstance(b, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [path]
    return [] if a == b else [f"{path}: {a} != {b}"]


def _window(run, k, source, resident=False):
    """Seconds per step of `k` steps between two syncs, the seconds per step
    spent waiting on the loaders and those spent issuing the copies to the
    device. `source` is a pair of epoch iterators (labeled, unlabeled) of
    host batches fed by the loaders, or a list of (labeled, unlabeled) pairs
    of host batches already loaded (pinned) or, with `resident`, already on
    the device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    waited = copied = 0.0
    for i in range(k):
        t = time.perf_counter()
        if isinstance(source, list):
            batch, unlabeled = source[i % len(source)]
        else:
            batch, unlabeled = next(source[0]), next(source[1])
        t1 = time.perf_counter()
        if not resident:
            batch, unlabeled = run.to_device(batch), run.to_device(unlabeled)
        t2 = time.perf_counter()
        waited, copied = waited + t1 - t, copied + t2 - t1
        run.step(batch, unlabeled)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / k, waited / k, copied / k


def _data_path_windows(label, run, k=8):
    """The data path's cost, in windows of `k` steps between two syncs taken
    in turns: fed by the loaders (each window inside one epoch of both
    loaders, after one step that fills the prefetch queues), from host
    batches that the loaders pinned beforehand, with no loader thread
    running (the copies to the device and the NHWC -> NCHW transposes
    alone), and from the same batches resident on the device."""
    def fresh_epochs():
        for loader in (run.train_loader, run.unlabeled_loader):
            if len(loader) < k + 1:
                raise AssertionError(f"{label}: an epoch of {len(loader)} batches holds no "
                                     f"window of {k} steps after its first")
        return iter(run.train_loader), iter(run.unlabeled_loader)

    def stop(epochs):
        for e in epochs:
            e.close()
        run.train_loader.close()
        run.unlabeled_loader.close()

    epochs = fresh_epochs()
    pinned = [(next(epochs[0]), next(epochs[1])) for _ in range(k)]
    stop(epochs)
    resident = [(run.to_device(b), run.to_device(u)) for b, u in pinned]
    windows = {"loaders": [], "pinned": [], "resident": []}
    for kind in ("loaders", "pinned", "resident", "resident", "pinned", "loaders"):
        if kind == "loaders":
            epochs = fresh_epochs()
            run.step(run.to_device(next(epochs[0])), run.to_device(next(epochs[1])))
            windows[kind].append(_window(run, k, epochs))
            stop(epochs)
        else:
            windows[kind].append(_window(run, k, pinned if kind == "pinned" else resident,
                                         resident=kind == "resident"))
    for kind, ws in windows.items():
        print(f"[{label}] windows of {k} steps, {kind}: " + ", ".join(
            f"{t:.4f} s per step ({w:.4f} s waiting on the loaders, {c:.4f} s issuing the "
            f"copies)" for t, w, c in ws))
    return windows


def _kernels_at_val_shape(records):
    """K1 and K2 against their plain versions at the Cityscapes validation
    shape (batch 2 at 512x1024; K1 with the 4 scale grids of a source frame,
    K2 on the pred error of the 4 scales and the identity error)."""
    n, s, h, w = 2, 4, 512, 1024
    img, grids = _warp_inputs(n, s, h, w, seed=17)
    ix, iy = (t.contiguous() for t in warp.unnormalize_grid(grids, h, w))
    got = warp.warp_bilinear_nchw(img, ix, iy, reps=s)
    ref = warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    ms = _time_ms(lambda: warp.warp_bilinear_nchw(img, ix, iy, reps=s))
    plain_ms = _time_ms(lambda: warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s))
    print(f"[cityscapes_exp212] K1 warp img {(n, 3, h, w)} S={s}: max|err| out/dfx/dfy = "
          f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tolerance {KERNEL_TOL:.0e}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not all(math.isfinite(e) and e <= KERNEL_TOL for e in errs):
        raise AssertionError(f"K1 disagrees with its plain version at {(n, h, w)}: {errs}")
    records["warp"]["max_abs_err"] = max(records["warp"]["max_abs_err"], *errs)
    records["warp"]["val_shape"] = {"shape": [n, 3, h, w], "reps": s, "max_abs_err": max(errs),
                                    "ms": ms, "plain_ms": plain_ms}
    for reps in (4, 1):
        pred, target, _ = _reprojection_inputs(n, reps, h, w, seed=23 + reps)
        got = reprojection.reprojection_error(pred, target, reps)
        ref = reprojection.reprojection_error_plain(pred, target, reps)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ms = _time_ms(lambda: reprojection.reprojection_error(pred, target, reps))
        plain_ms = _time_ms(lambda: reprojection.reprojection_error_plain(pred, target, reps))
        print(f"[cityscapes_exp212] K2 reprojection pred {(n * reps, 3, h, w)} reps {reps}: "
              f"max|err| = {err:.3e} (tolerance {KERNEL_TOL:.0e}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        if not (math.isfinite(err) and err <= KERNEL_TOL) or got.shape != (n * reps, 1, h, w):
            raise AssertionError(f"K2 disagrees with its plain version at {(n, reps, h, w)}: "
                                 f"{err}")
        records["reprojection"]["max_abs_err"] = max(records["reprojection"]["max_abs_err"], err)
        records["reprojection"].setdefault("val_shape", []).append(
            {"shape": [n * reps, 3, h, w], "reps": reps, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms})


def _check_validations(label, records, at):
    got = [i for i, r in enumerate(records, start=1) if "val/Mean IoU" in r]
    if got != at:
        raise AssertionError(f"{label}: validated after steps {got}, expected {at}")


def phase_cityscapes_exp212(records):
    """exp-212 from a generated Cityscapes tree through train_main, cut and
    resumed (see the module docstring). Returns the launches of the two
    runs."""
    label = "cityscapes_exp212"
    print(f"[{label}] host packages: {_host_packages()}")
    tmp = Path(tempfile.mkdtemp(prefix="cityscapes_exp212_"))
    launches = {}
    run1 = run2 = run3 = None
    try:
        t0 = time.perf_counter()
        write_cityscapes_tree(tmp / "cityscapes")
        print(f"[{label}] wrote the tree (16 train, 8 val frames) in "
              f"{time.perf_counter() - t0:.2f} s")

        def config(train_iters, auto_resume):
            cfg = _packaged_cfg("exp212_pad_online_cityscapes.yml")
            cfg["data"]["path"] = str(tmp / "cityscapes")
            cfg["training"].update(log_path=str(tmp / "run"), train_iters=train_iters,
                                   auto_resume=auto_resume)
            return cfg

        cfg1 = config(5, False)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run1 = trainer.build_run(cfg1, "cuda:0")
        n_val_batches = len(run1.val_loader)
        print(f"[{label}] train set {len(run1.train_loader.dataset)} labeled, unlabeled set "
              f"{len(run1.unlabeled_loader.dataset)}, val set {len(run1.val_loader.dataset)} "
              f"({n_val_batches} batches of 2 at 512x1024)")
        _reset_launches()
        t0 = time.perf_counter()
        first = trainer.train_main(cfg1, "cuda:0", run=run1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["exp212_pad_online_cityscapes"] = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        _check_validations(label, first, [1, 3, 4])
        expect = {k: 4 * v + 3 * n_val_batches * EXP212_PER_VAL_BATCH[k]
                  for k, v in EXP212_CITYSCAPES_PER_STEP.items()}
        print(f"[{label}] run 1: 4 steps, validated after steps 1, 3 and 4, in {wall:.3f} s; "
              f"launches {launches['exp212_pad_online_cityscapes']} (expected {expect}); peak "
              f"memory allocated {peak / 2**30:.3f} GiB")
        for i, r in enumerate(first, start=1):
            print(f"[{label}] run 1 step {i}: total_loss {r['total_loss']:.6f} unlabeled_loss "
                  f"{r['unlabeled_loss']:.6f} waiting on the loaders {r['data_seconds']:.4f} "
                  f"s, dispatch {r['step_seconds']:.4f} s" + (
                      f"; validation mIoU {r['val/Mean IoU']:.6f}, "
                      f"{r['val/eval_seconds_per_batch']:.4f} s per batch"
                      if "val/Mean IoU" in r else ""))
        if launches["exp212_pad_online_cityscapes"] != expect:
            raise AssertionError(f"{label}: launches {launches}, expected {expect}")
        if not all(math.isfinite(v) for r in first for v in r.values()):
            raise AssertionError(f"{label}: a value is not finite")
        files = sorted(os.listdir(tmp / "run"))
        print(f"[{label}] run 1 files: {files}")
        for f in ("best_model.pth", "best_model.json", "last_model.pth", "last_model.json",
                  "metrics.jsonl", "cfg.yml"):
            if f not in files:
                raise AssertionError(f"{label}: run 1 wrote no {f}")
        with open(tmp / "run" / "last_model.json") as f:
            side = json.load(f)
        if side["step"] != 4:
            raise AssertionError(f"{label}: last_model.json {side}")
        saves = [(i, r["val/save_seconds"]) for i, r in enumerate(first, start=1)
                 if "val/save_seconds" in r]
        print(f"[{label}] run 1 waited for the checkpoint saves (best and last from one host "
              f"snapshot, behind the previous save's write) after steps " + ", ".join(
                  f"{i}: {t:.4f} s" for i, t in saves) + "; the last save: synchronous copy "
              f"to the host {run1.checkpoints.snapshot_seconds:.4f} s, files written on its "
              f"thread {run1.checkpoints.write_seconds:.4f} s, "
              f"{os.path.getsize(tmp / 'run' / 'last_model.pth') / 2**20:.1f} MiB each")

        saved = _run_state(run1)
        cfg2 = config(7, True)
        run2 = trainer.build_run(cfg2, "cuda:0")
        loaded = _run_state(run2)
        diff = _equal_trees(loaded, saved)
        n_tensors = sum(len(saved[k]) for k in ("model", "teacher"))
        print(f"[{label}] resumed at iteration {run2.start_iter}, best_iou {run2.best_iou:.6f}, "
              f"lr_scale {run2.optimizer.lr_scale}; state equal to run 1's last bit for bit "
              f"({n_tensors} model and teacher tensors, "
              f"{len(saved['optimizer']['state'])} momentum buffers): {not diff}")
        if diff or run2.start_iter != 4:
            raise AssertionError(f"{label}: resumed state differs at {diff[:5]}, iteration "
                                 f"{run2.start_iter}")
        run1.close()
        run1 = None
        torch.cuda.empty_cache()
        _reset_launches()
        second = trainer.train_main(cfg2, "cuda:0", run=run2)
        launches["exp212_pad_online_cityscapes_resumed"] = _read_launches()
        _check_validations(label, second, [1, 2])  # steps 5 ((5 + 1) % 2) and 6 (the last)
        expect = {k: 2 * v + 2 * n_val_batches * EXP212_PER_VAL_BATCH[k]
                  for k, v in EXP212_CITYSCAPES_PER_STEP.items()}
        print(f"[{label}] run 2: {len(second)} steps (5 and 6), launches "
              f"{launches['exp212_pad_online_cityscapes_resumed']} (expected {expect})")
        if len(second) != 2 or launches["exp212_pad_online_cityscapes_resumed"] != expect:
            raise AssertionError(f"{label}: the resumed run took {len(second)} steps")

        # launches of one step and of one validation batch, alone
        batch, unlabeled = run2.device_batches()
        per_step = _count_launches(lambda: run2.step(batch, unlabeled))
        val_batch = next(run2.val_batches())
        gen = torch.Generator(device="cuda:0").manual_seed(0)
        per_val = _count_launches(lambda: train_steps.eval_step(run2.model, val_batch,
                                                                run2.step_cfg, generator=gen))
        print(f"[{label}] launches of one train step {per_step}, of one validation batch "
              f"{per_val}")
        if per_step != EXP212_CITYSCAPES_PER_STEP or per_val != EXP212_PER_VAL_BATCH:
            raise AssertionError(f"{label}: launches {per_step}, {per_val}")
        del batch, unlabeled, val_batch
        run2.close()
        run2 = None
        torch.cuda.empty_cache()

        # the data path's cost, on a larger tree whose epochs hold a window:
        # 40 train frames, 20 of them labeled (10 batches per epoch), all 40
        # unlabeled (20 batches)
        write_cityscapes_tree(tmp / "cityscapes_windows", n_train=40, n_val=2, seed=1)
        cfg3 = config(7, False)
        cfg3["data"]["path"] = str(tmp / "cityscapes_windows")
        cfg3["data"]["restrict_to_subset"]["n_subset"] = 20
        cfg3["training"]["log_path"] = str(tmp / "run_windows")
        run3 = trainer.build_run(cfg3, "cuda:0")
        _data_path_windows(label, run3)
        _kernels_at_val_shape(records)
    finally:
        for run in (run1, run2, run3):
            if run is not None:
                run.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _exp211_weights(model_dir, teacher_name):
    """Seeded stand-in weights in the published layouts: the ResNet-101
    dilated dec6 ASPP depth teacher (`<teacher>/{encoder,depth}.pth`) and
    `imnet/resnet50.pth` (torchvision keys). The teacher's decoder has no
    BatchNorm, so its random convolutions grow the activations layer by
    layer until the ELUs saturate at -1 (half the u3 channels came out
    constant, and the features' normalization divided by their std of 0):
    each decoder convolution is scaled, in forward order, to unit output
    std on two synthetic frames, and the running statistics are then set
    from them (a trained teacher's are, by training)."""
    imnet = Path(model_dir) / "imnet"
    imnet.mkdir(parents=True)
    torch.save(_torchvision_resnet(50, 4), imnet / "resnet50.pth")
    torch.manual_seed(5)
    teacher = joint.build_model({
        "backbone_name": "resnet101", "replace_stride_with_dilation": [False, False, True],
        "segmentation_name": None, "disable_pose": True, "frame_ids": [0],
        "depth_args": {"intermediate_aspp": True, "aspp_rates": [6, 12, 18],
                       "num_ch_dec": [64, 128, 128, 256, 256]}}, 19).to("cuda:0")
    frames = SyntheticDataset(n_samples=2, split="train", img_size=(512, 1024), frame_idxs=(0,),
                              num_scales=1, load_labels=False, load_sequence=False)
    x = torch.stack([torch.from_numpy(frames[i]["color_0_0"]) for i in range(2)])
    batch = {"color_aug_0_0": x.permute(0, 3, 1, 2).contiguous().to("cuda:0")}
    with torch.no_grad():
        teacher.train()
        for conv in [m for m in teacher.models["depth"].modules()
                     if isinstance(m, torch.nn.Conv2d)]:
            out = []
            hook = conv.register_forward_hook(lambda m, i, o: out.append(o))
            teacher(batch)
            hook.remove()
            conv.weight.div_(out[0].std())
        bns = [m for m in teacher.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        for m in bns:
            m.momentum = 1.0
        teacher(batch)
        for m in bns:
            m.momentum = 0.1
    for name in ("encoder", "depth"):
        checkpoints.save_component(str(Path(model_dir) / teacher_name), teacher, name)
    del teacher, batch
    torch.cuda.empty_cache()


def _exp211_cityscapes(tmp, label):
    """(a): the depth teacher's PNGs on a generated Cityscapes tree, card
    against CPU on 2 images, then one round of training on 8 fixed frames
    through the driver's `train_on_subset` and its step's profile. Returns
    the launches of the round and the model file it saved."""
    from PIL import Image

    t0 = time.perf_counter()
    write_cityscapes_tree(tmp / "cityscapes")
    print(f"[{label}] wrote the tree (16 train, 8 val frames) in {time.perf_counter() - t0:.2f} s")
    cfg = _packaged_cfg("exp211_label_selection_cityscapes.yml")
    cfg["data"].update(path=str(tmp / "cityscapes"), generated_depth_dir=str(tmp / "depth"))
    cfg["training"]["log_path"] = str(tmp / "ls")
    os.makedirs(tmp / "ls")
    teacher_cfg = copy.deepcopy(cfg)
    expand_cfg_vars(teacher_cfg)
    trainer._merge_shared_options(teacher_cfg)

    # the teacher's PNGs, with cuDNN's TF32 off: the 8-bit quantization of a
    # min-max normalized map turns a small disparity error into grey levels
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        est = depth_estimator.DepthEstimator(teacher_cfg, "cuda:0")
        t0 = time.perf_counter()
        written = est.prepare_depth_estimates()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        again = depth_estimator.DepthEstimator(teacher_cfg, "cuda:0").prepare_depth_estimates()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    per_image = [t / 4 for t in est.batch_seconds[1:]]
    print(f"[{label}] depth teacher (ResNet-101 dec6 at 512x1024, batch 4, cuDNN TF32 off): "
          f"{written} PNGs in {wall:.3f} s, the first batch (model build and weights "
          f"included) {est.batch_seconds[0]:.3f} s, then {statistics.median(per_image):.4f} s "
          f"per image (median; forward, copy to the host, 8-bit PNG write); a second call "
          f"wrote {again}")
    if written != 24 or again != 0:
        raise AssertionError(f"{label}: {written} PNGs written, then {again}")
    # the teacher forward alone, per image, with TF32 at the run's setting
    x = torch.rand((4, 3, 512, 1024), device="cuda:0")
    with torch.no_grad():
        ms = _time_ms(lambda: est.model.predict_test_disp({"color_0_0": x}), reps=5)
    print(f"[{label}] teacher forward alone (CUDA events, cuDNN TF32 {tf32}): "
          f"{ms / 4:.3f} ms per image at batch 4")

    # card against CPU on the first 2 train images, read back as the dataset reads them
    sub = [est.train_ds[i] for i in range(2)]
    color = torch.stack([torch.from_numpy(it["color_0_0"]) for it in sub]).permute(0, 3, 1, 2)
    cpu = depth_estimator.DepthEstimator(teacher_cfg, "cpu")
    cpu.depth_dir = str(tmp / "depth_cpu")
    cpu._init_model()
    with torch.no_grad():
        disp = cpu.model.predict_test_disp({"color_0_0": color})["disp_0"][:, 0].numpy()
    cpu._write([it["filename"] for it in sub], disp)
    worst, share = 0, 0.0
    for it in sub:
        a = np.asarray(Image.open(est.build_filename(it["filename"])), np.int16)
        b = np.asarray(Image.open(cpu.build_filename(it["filename"])), np.int16)
        worst = max(worst, int(np.abs(a - b).max()))
        share = max(share, float((a != b).mean()))
    print(f"[{label}] PNGs card vs CPU on 2 images: max |diff| {worst} grey levels, on "
          f"{100 * share:.4f}% of the pixels at most")
    if worst > 1:
        raise AssertionError(f"{label}: the card's PNGs lie {worst} grey levels from the CPU's")
    del x, cpu
    torch.cuda.empty_cache()

    # one round through the driver on a fixed subset of 8 train frames, 3 steps,
    # validated after steps 1 and 3 (val_interval 2)
    subset = list(range(8))
    captured = {}

    def train_main(cfg_, device, run):
        captured["records"] = trainer.train_main(cfg_, device, run=run)
        captured["n_val_batches"] = len(run.val_loader)
        return captured["records"]

    saved_train_main, driver.train_main = driver.train_main, train_main
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    try:
        t0 = time.perf_counter()
        model_file = driver.train_on_subset(cfg, subset, 4, device="cuda:0")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        driver.train_main = saved_train_main
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    records = captured["records"]
    _check_validations(label, records, [1, 3])
    for i, r in enumerate(records, start=1):
        print(f"[{label}] step {i}: total_loss {r['total_loss']:.6f} segmentation_loss "
              f"{r['segmentation_loss']:.6f} pseudo_depth_loss {r['pseudo_depth_loss']:.6f} "
              f"waiting on the loaders {r['data_seconds']:.4f} s, dispatch "
              f"{r['step_seconds']:.4f} s" + (
                  f"; validation mIoU {r['val/Mean IoU']:.6f}, depth/abs_rel "
                  f"{r['val/depth/abs_rel']:.6f}, {r['val/eval_seconds_per_batch']:.4f} s per "
                  f"batch of 2 at 512x1024" if "val/Mean IoU" in r else ""))
    if not (len(records) == 3 and all(math.isfinite(v) for r in records for v in r.values())
            and all(r["pseudo_depth_loss"] > 0 for r in records)):
        raise AssertionError(f"{label}: records {records}")
    if not os.path.isfile(model_file) or Path(model_file).name != "best_model.pth":
        raise AssertionError(f"{label}: train_on_subset returned {model_file}")
    print(f"[{label}] train_on_subset (8 frames, 3 steps, 2 validations over "
          f"{captured['n_val_batches']} batches) in {wall:.3f} s, returned "
          f"{Path(model_file).relative_to(tmp)}; peak memory allocated {peak / 2**30:.3f} GiB; "
          f"launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"{label}: the exp-211 path launched {launches}")

    # the step's profile (profile_cli's method) and launches per step and per
    # validation batch, on a run of the same config and subset
    run_cfg = copy.deepcopy(cfg)
    run_cfg["data"]["restrict_to_subset"] = {"mode": "fixed", "n_subset": 8, "subset": subset}
    run_cfg["training"]["log_path"] = str(tmp / "profile")
    run = trainer.build_run(run_cfg, "cuda:0")
    try:
        batches = [run.device_batches() for _ in range(2)]
        val_batch = next(run.val_batches())
    finally:
        run.close()
    m = profile_cli.measure(run, batches)
    classes = sorted(m["by_class"].items(), key=lambda kv: -kv[1][0])
    n_kernels = sum(n for _, n in m["by_class"].values()) / profile_cli.PROFILED
    print(f"[{label}] step (ResNet-50 + dec9, batch 2 at 512x512, Adam): median "
          f"{m['median_s']:.4f} s of {len(m['step_s'])} (min {min(m['step_s']):.4f}, max "
          f"{max(m['step_s']):.4f}); device {m['device_ms']:.2f} ms per step, "
          f"{n_kernels:,.0f} kernels; idle share {m['idle']:.4f}; peak memory allocated "
          f"{m['peak_bytes'] / 2**30:.3f} GiB; by class (ms, kernels per step): " + ", ".join(
              f"{c} {ms:.2f} ({n / profile_cli.PROFILED:,.0f})" for c, (ms, n) in classes))
    per_step = _count_launches(lambda: run.step(*batches[0]))
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    per_val = _count_launches(lambda: train_steps.eval_step(run.model, val_batch, run.step_cfg,
                                                            generator=gen))
    eval_ms = _time_ms(lambda: train_steps.eval_step(run.model, val_batch, run.step_cfg,
                                                     generator=gen), reps=5)
    print(f"[{label}] launches of one train step {per_step}, of one validation batch "
          f"{per_val}; a validation batch (2 at 512x1024) {eval_ms:.2f} ms (CUDA events)")
    if any(per_step.values()) or any(per_val.values()):
        raise AssertionError(f"{label}: launches {per_step}, {per_val}")
    del run, batches, val_batch
    torch.cuda.empty_cache()
    return launches, model_file


def _exp211_label_selection(tmp, label, model_file):
    """(b): label_selection_main on the synthetic exp-211 config at full
    width, timed by part, then acquire_scores card against CPU on 4 samples
    from `model_file`. Returns the loop's launches."""
    cfg = _packaged_cfg("exp211_label_selection_synthetic.yml")
    cfg["training"]["log_path"] = str(tmp / "ls_synthetic")
    scoring_calls, ifp_seconds, rounds = [], [], []
    saved = {k: getattr(driver, k) for k in ("acquire_scores", "iterative_farthest_point",
                                             "train_on_subset", "train_main")}

    def acquire_scores(*args, **kwargs):
        t0 = time.perf_counter()
        out = saved["acquire_scores"](*args, **kwargs)
        scoring_calls.append((time.perf_counter() - t0, out[1]["seconds"], len(out[0])))
        return out

    def iterative_farthest_point(*args, **kwargs):
        t0 = time.perf_counter()
        out = saved["iterative_farthest_point"](*args, **kwargs)
        ifp_seconds.append(time.perf_counter() - t0)
        return out

    def train_on_subset(cfg_, labeled, train_iters, model_file=None, device="cuda:0"):
        t0 = time.perf_counter()
        out = saved["train_on_subset"](cfg_, labeled, train_iters, model_file, device=device)
        rounds[-1]["seconds"] = time.perf_counter() - t0
        return out

    def train_main(cfg_, device, run):
        rounds.append({"records": saved["train_main"](cfg_, device, run=run),
                       "n_val_batches": len(run.val_loader)})
        return rounds[-1]["records"]

    for k, fn in (("acquire_scores", acquire_scores),
                  ("iterative_farthest_point", iterative_farthest_point),
                  ("train_on_subset", train_on_subset), ("train_main", train_main)):
        setattr(driver, k, fn)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    try:
        t0 = time.perf_counter()
        driver.label_selection_main(cfg, device="cuda:0")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, fn in saved.items():
            setattr(driver, k, fn)
    launches = _read_launches()
    base = Path(cfg["training"]["log_path"])  # <log_path>/<name> after the call
    print(f"[{label}] label_selection_main: 24 synthetic samples at 512x1024, rounds "
          f"[4, 8] of 3 steps, in {wall:.3f} s; peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}")
    for i, (secs, parts, n_scores) in enumerate(scoring_calls, start=1):
        teacher = parts["teacher"]
        score = parts["score"]
        print(f"[{label}] scoring call {i}: {secs:.3f} s for {len(parts['load'])} samples "
              f"({n_scores} scores): loader {statistics.median(parts['load']):.4f} s, teacher "
              f"u3 features {statistics.median(teacher):.4f} s" + (
                  f", student scoring (512x1024 forward at batch 1) "
                  f"{statistics.median(score):.4f} s" if score else "")
              + f" per sample (medians; first teacher sample {teacher[0]:.4f} s); distance "
              f"matrix {parts['distances']:.4f} s")
    print(f"[{label}] IFP: " + ", ".join(f"{t * 1e3:.3f} ms" for t in ifp_seconds))
    for n, r in zip((4, 8), rounds):
        vals = [v for v in r["records"] if "val/eval_seconds_per_batch" in v]
        print(f"[{label}] round nlabels{n}: train_on_subset {r['seconds']:.3f} s (a new "
              f"run, {len(r['records'])} steps, dispatch " + " ".join(
                  f"{v['step_seconds']:.4f}" for v in r["records"]) + " s; "
              f"{len(vals)} validations of {r['n_val_batches']} batches at "
              + ", ".join(f"{v['val/eval_seconds_per_batch']:.4f}" for v in vals)
              + " s per batch, the loop waiting for the best and last checkpoints "
              + ", ".join(f"{v['val/save_seconds']:.3f}" for v in vals)
              + " s; then the returned best_model's save)")
    subsets = []
    for n in (4, 8):
        path = base / f"nlabels{n}_subset.json"
        if not path.is_file():
            raise AssertionError(f"{label}: no {path.name}")
        with open(path) as f:
            subsets.append(json.load(f))
    print(f"[{label}] chosen subsets: {subsets[0]} then {subsets[1]}")
    left = sorted(str(p.relative_to(base)) for p in base.rglob("best_model.pth"))
    if not ([len(s) for s in subsets] == [4, 8] and len(set(subsets[1])) == 8
            and set(subsets[0]) <= set(subsets[1]) and max(subsets[1]) < 24):
        raise AssertionError(f"{label}: subsets {subsets}")
    if left or len(rounds) != 2 or len(scoring_calls) != 2:
        raise AssertionError(f"{label}: models left {left}, {len(rounds)} rounds, "
                             f"{len(scoring_calls)} scoring calls")
    if any(launches.values()):
        raise AssertionError(f"{label}: the exp-211 path launched {launches}")

    # acquire_scores card against CPU on 4 samples from one model file, with
    # cuDNN's TF32 off on the card (f32 against f32)
    samples = subsets[0]
    check = copy.deepcopy(cfg)
    check["training"]["log_path"] = str(tmp / "ls_check")
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for device in ("cuda:0", "cpu"):
            t0 = time.perf_counter()
            out[device] = driver.acquire_scores(check, samples, samples, model_file,
                                                depth_ifp_w=1, device=device)
            print(f"[{label}] acquire_scores on 4 samples on {device}: "
                  f"{time.perf_counter() - t0:.2f} s")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (card_scores, card_d), (cpu_scores, cpu_d) = out["cuda:0"], out["cpu"]
    crit = np.array([s["label_criterion"] for s in card_scores])
    crit_cpu = np.array([s["label_criterion"] for s in cpu_scores])
    dist, dist_cpu = np.asarray(card_d["distances"]), np.asarray(cpu_d["distances"])
    rel_c = float(np.max(np.abs(crit - crit_cpu) / np.abs(crit_cpu)))
    rel_d = float(np.max(np.abs(dist - dist_cpu)) / np.max(np.abs(dist_cpu)))
    print(f"[{label}] acquire_scores card vs CPU: label criteria {crit.ravel().tolist()} "
          f"(max relative difference {rel_c:.3e}), distances max difference {rel_d:.3e} "
          f"of the largest")
    if [s["idx"] for s in card_scores] != [s["idx"] for s in cpu_scores] \
            or not rel_c <= 1e-3 or not rel_d <= 1e-3:
        raise AssertionError(f"{label}: acquire_scores card vs CPU {rel_c}, {rel_d}")
    return launches


def phase_exp211():
    """exp-211, automatic label selection (see the module docstring): seeded
    stand-in weights in a temporary SDT_MODEL_DIR, then the file path on a
    generated Cityscapes tree and the whole loop on synthetic frames."""
    saved_env = {k: os.environ.get(k) for k in ("SDT_MODEL_DIR",)}
    tmp = Path(tempfile.mkdtemp(prefix="exp211_"))
    model_dir = tmp / "models"
    os.environ["SDT_MODEL_DIR"] = str(model_dir)
    launches = {}
    try:
        cfg = _packaged_cfg("exp211_label_selection_synthetic.yml")
        _exp211_weights(model_dir, cfg["data"]["depth_teacher"])
        print(f"[exp211] stand-in weights (seeded, random) in {model_dir.name}: "
              f"{sorted(str(p.relative_to(model_dir)) for p in model_dir.rglob('*.pth'))}")
        t0 = time.perf_counter()
        launches["exp211_cityscapes"], model_file = _exp211_cityscapes(tmp, "exp211_cityscapes")
        t1 = time.perf_counter()
        launches["exp211_label_selection"] = _exp211_label_selection(
            tmp, "exp211_label_selection", model_file)
        print(f"[exp211] phase times: cityscapes {t1 - t0:.1f} s, label selection "
              f"{time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches


EXPERIMENTS_BASE = "configs/cityscapes_joint.yml"
SDE_STANDIN = "mono_cityscapes_1024x512_r101dil_aspp_dec6_lr5_fd2_crop512x512bs4"
EXP212_UNFUSED_PER_STEP = {"warp": 4, "reprojection": 4, "reprojection_grad": 0}


def _sde_standins(model_dir, name):
    """Seeded stand-ins of the published SDE components (`encoder`, `depth`,
    `pose_encoder`, `pose` of the ResNet-101 dilated dec6 ASPP model) under
    `<model_dir>/<name>/`, as `_exp211_weights` writes its teacher."""
    torch.manual_seed(11)
    model = joint.build_model({
        "backbone_name": "resnet101", "replace_stride_with_dilation": [False, False, True],
        "segmentation_name": None, "frame_ids": [0, -1, 1],
        "depth_args": {"intermediate_aspp": True, "aspp_rates": [6, 12, 18],
                       "num_ch_dec": [64, 128, 128, 256, 256]}}, 19)
    for component in ("encoder", "depth", "pose_encoder", "pose"):
        checkpoints.save_component(str(Path(model_dir) / name), model, component)


def _experiments_trial(tmp, label, base_cfg):
    """(a): the generated exp-212 trial 0 through `run_experiments` on a
    generated Cityscapes tree, with the phase's overrides on the JAX smoke
    budgets; its launches per step and per validation batch, the mix debug
    tensors and images, then its step's profile. Returns (launches, run dir)."""
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.cli import (
        run_experiments_cli,
        test_experiments_cli,
    )

    write_cityscapes_tree(tmp / "cityscapes")

    def overrides(cfg):
        test_experiments_cli.smoke_overrides(cfg)
        for path, value in (("training.train_iters", 4), ("training.val_interval", {"0": 2}),
                            ("data.restrict_to_subset.n_subset", 8),
                            ("training.save_model", True), ("training.print_interval", 1)):
            *keys, last = path.split(".")
            node = cfg
            for k in keys:
                node = node[k]
            node[last] = value
            print(f"[{label}] override {path}: {value} (3 steps, validated after steps 1 and "
                  f"3, 8 of the tree's 16 train frames labeled)" if path == "training.train_iters"
                  else f"[{label}] override {path}: {value}")

    debug, val_launches, validations = [], [], []
    saved_dump, saved_validate = trainer.Run.dump_mix_debug, trainer.Run.validate

    def dump_mix_debug(run, tensors, step):
        t0 = time.perf_counter()
        saved_dump(run, tensors, step)
        seconds = time.perf_counter() - t0
        host = {k: v.float().cpu().numpy() for k, v in tensors.items()}
        debug.append((step, seconds, host))

    def validate(run, step):
        before = _read_launches()
        out = saved_validate(run, step)
        after = _read_launches()
        val_launches.append({k: after[k] - before[k] for k in after})
        validations.append(len(run.val_loader))
        return out

    trainer.Run.dump_mix_debug, trainer.Run.validate = dump_mix_debug, validate
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    try:
        t0 = time.perf_counter()
        out_dir = run_experiments_cli.run_experiments(
            copy.deepcopy(base_cfg), 212, runs=[0], strict=True, device="cuda:0",
            config_name="cityscapes_joint", overrides=overrides)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer.Run.dump_mix_debug, trainer.Run.validate = saved_dump, saved_validate
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    trial_yaml = Path(out_dir) / "trial_0.yaml"
    with open(trial_yaml) as f:
        trial = yaml.safe_load(f)
    m, t = trial["model"], trial["training"]
    print(f"[{label}] wrote {trial_yaml.relative_to(tmp)}: variant {m['variant']}, "
          f"{m['backbone_name']} dilated {m['replace_stride_with_dilation']}, "
          f"{m['segmentation_name']} {m['segmentation_args']}, dec6 {m['depth_args']}, "
          f"pose {not m['disable_pose']}, batch {t['batch_size']} + {t['batch_size']}, "
          f"{t['optimizer']}, clip {t['clip_grad_norm']}, debug_image "
          f"{t['unlabeled_segmentation']['debug_image']}, fused_reprojection "
          f"{t.get('fused_reprojection', False)}")
    if m["variant"] != "pad_transfer_dcompgt0030" or not \
            t["unlabeled_segmentation"]["debug_image"]:
        raise AssertionError(f"{label}: trial 0 is {m['variant']}")
    run_dir = tmp / "logs" / "cityscapes_joint_212"
    n_val = len(val_launches)
    per_val = val_launches[0] if val_launches else {}
    step_launches = {k: v - sum(vl[k] for vl in val_launches) for k, v in launches.items()}
    per_step = {k: v / 3 for k, v in step_launches.items()}
    print(f"[{label}] run_experiments {wall:.3f} s (the run's build, 3 steps, {n_val} "
          f"validations of {validations} batches of 2 at 512x1024, checkpoints, debug images); "
          f"peak memory allocated {peak / 2**30:.3f} GiB; launches {launches}: per step "
          f"{per_step}, per validation batch {[{k: v / b for k, v in vl.items()} for vl, b in zip(val_launches, validations)]}")
    if n_val != 2 or per_step != EXP212_UNFUSED_PER_STEP or any(
            vl != {k: v * b for k, v in EXP212_PER_VAL_BATCH.items()}
            for vl, b in zip(val_launches, validations)):
        raise AssertionError(f"{label}: launches {launches}, validations {val_launches}")

    # the debug tensors of every step (print_interval 1), whether or not
    # matplotlib drew them
    if len(debug) != 3:
        raise AssertionError(f"{label}: {len(debug)} debug dumps for 3 steps")
    for step, seconds, host in debug:
        imgs, mask = host["debug/mixed_imgs"], host["debug/mix_mask"]
        pseudo, depths = host["debug/pseudo_label"], host["debug/depths"]
        labels = np.unique(pseudo)
        print(f"[{label}] step {step} debug tensors: mixed_imgs {imgs.shape} in "
              f"[{imgs.min():.3f}, {imgs.max():.3f}], mix_mask {mask.shape} mean "
              f"{mask.mean():.4f}, pseudo_label {pseudo.shape} values {labels.astype(int).tolist()}, "
              f"depths {depths.shape} in [{depths.min():.4f}, {depths.max():.4f}]; the loop's "
              f"dump took {seconds:.4f} s")
        # 250 (ignore) where mix_use_gt's one-hot labels are all zero
        if imgs.shape != (2, 3, 512, 512) or mask.shape != pseudo.shape != depths.shape \
                or mask.shape != (2, 512, 512) or not set(np.unique(mask)) <= {0.0, 1.0} \
                or not all(0 <= v < 19 or v == 250 for v in labels) \
                or not (0 <= depths.min() and depths.max() <= 1):
            raise AssertionError(f"{label}: debug tensors at step {step}")
    jpgs = sorted(os.listdir(run_dir / "class_mix_debug")) if (
        run_dir / "class_mix_debug").is_dir() else []
    if importlib.util.find_spec("matplotlib") is None:
        print(f"[{label}] matplotlib is not installed: the loop wrote no class_mix_debug "
              f"images ({jpgs})")
        if jpgs:
            raise AssertionError(f"{label}: debug images without matplotlib")
    else:
        print(f"[{label}] class_mix_debug: {jpgs}")
        if jpgs != [f"{s}_{j}_img.jpg" for s in (1, 2, 3) for j in (0, 1)]:
            raise AssertionError(f"{label}: debug images {jpgs}")
    files = sorted(os.listdir(run_dir))
    if "best_model.pth" not in files or "cfg.yml" not in files:
        raise AssertionError(f"{label}: run dir {files}")

    # the trial's step alone: profile_cli's method on a run of the trial's config
    trial["training"]["log_path"] = str(tmp / "profile")
    run = trainer.build_run(trial, "cuda:0")
    try:
        batches = [run.device_batches() for _ in range(2)]
    finally:
        run.close()
    prof = profile_cli.measure(run, batches)
    n_kernels = sum(n for _, n in prof["by_class"].values()) / profile_cli.PROFILED
    print(f"[{label}] step (batch 2 + 2 at 512x512, debug images on): median "
          f"{prof['median_s']:.4f} s of {len(prof['step_s'])} (min {min(prof['step_s']):.4f}, "
          f"max {max(prof['step_s']):.4f}); device {prof['device_ms']:.2f} ms per step, "
          f"{n_kernels:,.0f} kernels; idle share {prof['idle']:.4f}; peak memory allocated "
          f"{prof['peak_bytes'] / 2**30:.3f} GiB")
    del run, batches
    torch.cuda.empty_cache()
    return launches, run_dir


def _experiments_synthetic(label, base_cfg_path):
    """(b): every generated trial of 210, 211 and 212 through the smoke
    runner on synthetic data at resnet18 and 64x96, each timed. Returns the
    launches."""
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.cli import (
        run_experiments_cli,
        test_experiments_cli,
    )

    trials = []
    saved = {k: getattr(run_experiments_cli, k) for k in ("train_main", "label_selection_main")}

    def timed(name):
        def call(cfg, **kwargs):
            t0 = time.perf_counter()
            trials.append([cfg["model"]["variant"], None])
            out = saved[name](cfg, **kwargs)
            torch.cuda.synchronize()
            trials[-1][1] = time.perf_counter() - t0
            return out
        return call

    for k in saved:
        setattr(run_experiments_cli, k, timed(k))
    _reset_launches()
    try:
        t0 = time.perf_counter()
        test_experiments_cli.main(["--config", base_cfg_path, "--synthetic", "--strict",
                                   "--exps", "210,211,212", "--device", "cuda:0"])
        wall = time.perf_counter() - t0
    finally:
        for k, fn in saved.items():
            setattr(run_experiments_cli, k, fn)
    launches = _read_launches()
    finished = [t for t in trials if t[1] is not None]
    print(f"[{label}] test_experiments_cli --synthetic --strict: dispatched {len(trials)} "
          f"trials, finished {len(finished)}, in {wall:.1f} s; launches {launches}")
    for variant, secs in trials:
        print(f"[{label}] trial {variant}: {secs:.2f} s")
    if len(trials) != 10 or len(finished) != 10:
        raise AssertionError(f"{label}: {len(trials)} dispatched, {len(finished)} finished")
    return launches


def _experiments_export(tmp, label, run_dir):
    """(c): export_cli on the trial's run dir at 512x1024, at batch 1 and
    with a symbolic batch; the artifacts against the eager model at batch 1
    and 2 (cuDNN TF32 off), their sizes, export times and times per image.
    Returns the symbolic artifact's path."""
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.cli import export_cli
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.export import (
        load_exported,
    )

    h, w = 512, 1024
    paths = {}
    for batch in (1, 0):
        path = tmp / f"model_b{batch or 'sym'}.pt2"
        t0 = time.perf_counter()
        export_cli.main(["--model", str(run_dir), "--out", str(path), "--height", str(h),
                         "--width", str(w), "--batch", str(batch), "--device", "cuda:0"])
        secs = time.perf_counter() - t0
        print(f"[{label}] export_cli --batch {batch} ({'symbolic' if not batch else 'fixed'}): "
              f"{path.stat().st_size / 2**20:.1f} MiB in {secs:.2f} s (the run dir's load "
              f"included)")
        paths[batch] = path
    model, _ = export_cli.load_run_model(str(run_dir), "cuda:0")
    x = torch.rand((2, 3, h, w), generator=torch.Generator().manual_seed(3)).to("cuda:0")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for batch, path in paths.items():
            serve = load_exported(str(path))
            for n in ((1,) if batch else (1, 2)):
                out = serve(x[:n])
                with torch.no_grad():
                    eager = model({"color_aug_0_0": x[:n]}, use_pose=False)
                for k in ("semantics", "disp_0"):
                    err = float((out[k] - eager[k]).abs().max())
                    scale = float(eager[k].abs().max())
                    print(f"[{label}] artifact ({'symbolic' if not batch else 'batch 1'}) at n "
                          f"{n}, {k} {tuple(out[k].shape)}: max |artifact - eager| {err:.3e}, "
                          f"max |eager| {scale:.3e} (tolerance 1e-4 of it, TF32 off)")
                    if not (math.isfinite(err) and err <= 1e-4 * max(scale, 1.0)):
                        raise AssertionError(f"{label}: artifact {k} off by {err}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    serve = load_exported(str(paths[0]))
    with torch.no_grad():
        art_ms = _time_ms(lambda: serve(x), reps=5)
        eager_ms = _time_ms(lambda: model({"color_aug_0_0": x}, use_pose=False), reps=5)
    print(f"[{label}] time per image at batch 2, 512x1024 (CUDA events, median of 5, cuDNN "
          f"TF32 {tf32}): artifact {art_ms / 2:.3f} ms, eager forward {eager_ms / 2:.3f} ms")
    del model, x
    torch.cuda.empty_cache()
    return paths[0]


def _experiments_inference(tmp, label, run_dir, artifact):
    """(d): inference_cli over the tree's 8 validation images from the
    trial's run dir (cuDNN TF32 off): every input's PNGs, the labels against
    the argmax of the artifact (differences only at near ties) and the
    depths within 1 grey level; time per image by part."""
    from PIL import Image

    from improving_segmentation_with_selfsupervised_depth_tpu_torch.cli import inference_cli
    from improving_segmentation_with_selfsupervised_depth_tpu_torch.engine.export import (
        load_exported,
    )

    data = tmp / "cityscapes" / "leftImg8bit_small" / "val"
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        inf = inference_cli.main(["--model", str(run_dir), "--data", str(data),
                                  "--device", "cuda:0"])
        wall = time.perf_counter() - t0
        serve = load_exported(str(artifact))
        stems = sorted(str(p)[:-4] for p in Path(inf.logdir).rglob("*.jpg"))
        worst_depth, flips, near = 0, 0, 0
        for stem in stems:
            for suffix in ("_depth.png", "_label.png"):
                if not os.path.isfile(stem + suffix):
                    raise AssertionError(f"{label}: no {stem + suffix}")
            # the input as the dataset read it (the written copy is a new JPEG)
            source = data.parent / Path(stem).relative_to(inf.logdir)
            img = np.asarray(Image.open(str(source) + ".jpg"), np.float32) / 255.0
            with torch.no_grad():
                out = serve(torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to("cuda:0"))
            logits = out["semantics"][0].float()
            top2 = logits.topk(2, dim=0).values
            gap = (top2[0] - top2[1]).cpu().numpy()
            pred = logits.argmax(0).cpu().numpy()
            want = (inf.val_dataset.decode_segmap_tocolor(pred) * 255).astype(np.uint8)
            got = np.asarray(Image.open(stem + "_label.png"))
            differ = np.any(got != want, axis=-1)
            flips += int(differ.sum())
            near += int((differ & (gap > 1e-3)).sum())
            disp = (np.clip(out["disp_0"][0, 0].float().cpu().numpy(), 0, 1) * 255).astype(
                np.int16)
            depth = np.asarray(Image.open(stem + "_depth.png"), np.int16)
            worst_depth = max(worst_depth, int(np.abs(depth - disp).max()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    sec = {k: np.asarray(v) / 2 for k, v in inf.seconds.items()}  # batches of 2
    print(f"[{label}] inference_cli over {len(stems)} images at 512x1024 in {wall:.2f} s (the "
          f"run dir's load included); per image, median over the batches (first batch): "
          + ", ".join(f"{k} {np.median(v) * 1e3:.2f} ms ({v[0] * 1e3:.2f})"
                      for k, v in sec.items()))
    print(f"[{label}] against the artifact: {flips} label pixels differ ({near} of them with "
          f"top-two logits more than 1e-3 apart), depth PNGs within {worst_depth} grey levels")
    if len(stems) != 8 or near or worst_depth > 1:
        raise AssertionError(f"{label}: {len(stems)} images, {near} label flips off a near "
                             f"tie, depth {worst_depth}")


def phase_experiments():
    """The experiment CLIs (see the module docstring): (a) a generated
    exp-212 trial at full width, (b) every generated trial on synthetic
    data, (c) export and (d) inference from (a)'s run dir. Returns the
    launches of (a) and (b)."""
    label = "experiments"
    env = ("SDT_MODEL_DIR", "CITYSCAPES_DIR", "SDT_LOG_DIR", "SDT_DISPATCH_DIR")
    saved_env = {k: os.environ.get(k) for k in env}
    tmp = Path(tempfile.mkdtemp(prefix="experiments_"))
    for k, sub in zip(env, ("models", "cityscapes", "logs", "dispatch")):
        os.environ[k] = str(tmp / sub)
    base_path = str(Path(__file__).resolve().parent / EXPERIMENTS_BASE)
    with open(base_path) as f:
        base_cfg = yaml.safe_load(f)
    launches = {}
    try:
        _sde_standins(tmp / "models", SDE_STANDIN)
        print(f"[{label}] stand-in SDE components (seeded, random) in models/{SDE_STANDIN}: "
              f"{sorted(p.name for p in (tmp / 'models' / SDE_STANDIN).iterdir())}")
        times = [time.perf_counter()]
        launches["experiments_exp212_trial"], run_dir = _experiments_trial(
            tmp, label + " a", base_cfg)
        times.append(time.perf_counter())
        launches["experiments_synthetic"] = _experiments_synthetic(label + " b", base_path)
        times.append(time.perf_counter())
        artifact = _experiments_export(tmp, label + " c", run_dir)
        times.append(time.perf_counter())
        _experiments_inference(tmp, label + " d", run_dir, artifact)
        times.append(time.perf_counter())
        print(f"[{label}] part times: " + ", ".join(
            f"{p} {b - a:.1f} s" for p, a, b in zip("abcd", times, times[1:])))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches


# exp-212's launches per step (phase_slices): two photometric passes, each
# one K1 launch per source frame, K2 for its identity and its pred error, K3
# in the backward; fused, one pass over 2N
EXP212_PER_STEP = {"warp": 4, "reprojection": 8, "reprojection_grad": 4}
EXP212_FUSED_PER_STEP = {"warp": 2, "reprojection": 4, "reprojection_grad": 2}
# sde: each source frame warped at its 4 scales with one K1 launch, the
# identity error through K2
SDE_PACK_PER_STEP = {"warp": 2, "reprojection": 2, "reprojection_grad": 0}
NO_KERNELS = {"warp": 0, "reprojection": 0, "reprojection_grad": 0}
# the photometric loss's gradients with and without `remat_photometric`, on
# the card, f32 chain: |remat - stored| / |stored| over all parameters (the
# same per-pixel arithmetic; cuDNN's backward accumulates in its own order)
REMAT_GRAD_RTOL = 1e-3


def _option_run(label, cfg, per_step):
    """`cfg` through train_main (`_run_slice`: 3 steps, exact launches) on a
    run that is kept, with two device batches, for `_measure_turns`.
    Returns (launches, the first step's record, run, batches, the device
    memory the run keeps: model, teacher, optimizer state, gradients,
    batches)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    run = trainer.build_run(cfg, "cuda:0")
    try:
        launches, records = _run_slice(label, cfg, per_step, run=run)
        batches = [run.device_batches() for _ in range(2)]
    finally:
        run.close()
    torch.cuda.synchronize()
    return launches, records[0], run, batches, torch.cuda.memory_allocated() - before


def _measure_turns(label, cells):
    """`profile_cli.measure` (one warm-up, 4 timed steps and 1 profiled
    step; the profiler's processing of a step's ~19,000 kernels takes most
    of a cell's time) of each cell's run in turns, the packaged config
    first; prints the step median, the device time per step (with K1-K3's),
    the idle share and the peak memory, and the first steps' losses side by
    side. The cells' runs stay on the card together, so a run's peak is
    taken as it would be alone: what the run keeps plus the step's peak
    above what was allocated before it (`peak_bytes` is replaced by that).
    Returns {cell: measure result}."""
    results = {}
    classes = ("K1 warp", "K2 reprojection", "K3 reprojection grad")
    for name, cell in cells.items():
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        m = profile_cli.measure(cell["run"], cell["batches"], steps=4, profiled=1)
        m["peak_bytes"] = cell["resident"] + m["peak_bytes"] - base
        results[name] = m
        kernels = sum(m["by_class"][c][0] for c in classes if c in m["by_class"])
        print(f"[{label}] {name}: step median {m['median_s']:.4f} s, device "
              f"{m['device_ms']:.2f} ms per step (K1-K3 {kernels:.3f} ms), idle "
              f"{m['idle']:.3f}, peak {m['peak_bytes'] / 2**30:.3f} GiB; launches per step "
              f"{cell['per_step']}")
    first = {name: cell["first"] for name, cell in cells.items()}
    for k in next(iter(first.values())):
        if k.endswith("loss") and not k.startswith("val/"):
            print(f"[{label}] first step {k}: " + ", ".join(
                f"{name} {r[k]:.6f}" for name, r in first.items() if k in r))
    return results


def _cells(label, variants):
    """Each (name, cfg, per step launches) through `_option_run`."""
    cells = {}
    for name, cfg, per_step in variants:
        launches, first, run, batches, resident = _option_run(f"{label} {name}", cfg, per_step)
        print(f"[{label} {name}] the run keeps {resident / 2**30:.3f} GiB on the card")
        cells[name] = dict(launches=launches, first=first, run=run, batches=batches,
                           per_step=per_step, resident=resident)
    return cells


def _remat_photometric_check(label, run, batch):
    """One forward of sde's model (train mode) on `batch`, then the
    photometric loss and its parameter gradients with and without
    `remat_photometric`, the chain and the convolutions in f32 (TF32 rounds
    the backward's inputs to 10 bits, which turns op-order rounding into
    ~2e-3 of the gradient): equal losses and gradients, and K1 never
    launched in a backward."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _remat_photometric_grads(label, run, batch)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _remat_photometric_grads(label, run, batch):
    cfg = dataclasses.replace(run.step_cfg, photometric_dtype=None)
    n, _, h, w = batch["color_0_0"].shape
    noise = torch.randn((n, len(cfg.frame_ids) - 1, h, w), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    params = [p for p in run.model.parameters() if p.requires_grad]
    run.model.train()
    outputs = run.model(batch)
    got = {}
    for name, variant in (("stored", dataclasses.replace(cfg, remat_photometric=False)),
                          ("remat_photometric", dataclasses.replace(
                              cfg, remat_photometric=True))):
        _reset_launches()
        loss = train_steps._monodepth_loss(variant, batch, outputs, None, noise)
        forward = _read_launches()
        grads = torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True)
        torch.cuda.synchronize()
        flat = torch.cat([g.flatten() for g in grads if g is not None]).double()
        got[name] = (float(loss.detach()), flat, forward, _read_launches())
    ref_loss, ref_grad, _, _ = got["stored"]
    for name, (loss, grad, forward, after) in got.items():
        rel = float((grad - ref_grad).norm() / ref_grad.norm())
        print(f"[{label}] {name}: loss {loss:.7f} (stored {ref_loss:.7f}), gradients "
              f"|{name} - stored| / |stored| {rel:.3e} (at most {REMAT_GRAD_RTOL:g}); "
              f"launches in the loss {forward}, after the backward {after}")
        if not (abs(loss - ref_loss) <= 1e-5 * abs(ref_loss) and rel <= REMAT_GRAD_RTOL):
            raise AssertionError(f"{label}: {name} differs from the stored chain")
        if after != forward or forward["warp"] != 2:
            raise AssertionError(f"{label}: {name} launches {forward} then {after}")
    del outputs


def _dropout_on_card(label):
    """Channel-wise dropout (p 0.3) on the card: whole planes zeroed, the
    others scaled by 1 / (1 - p), the draws from its own CUDA generator; then
    a decoder with dropout in every ConvBlock through one train-mode step's
    forward and backward."""
    p = 0.3
    drop = layers.ChannelDropout(p, seed=1)
    x = torch.rand((8, 64, 32, 32), device="cuda") + 0.5
    y = drop(x)
    zeroed = (y == 0).all(dim=(2, 3))
    scale_err = float((y[~zeroed] - x[~zeroed] / (1 - p)).abs().max())
    print(f"[{label}] ChannelDropout p {p}: {float(zeroed.float().mean()):.3f} of 512 planes "
          f"zeroed, survivors' max |y - x / (1 - p)| {scale_err:.3e}, generator on "
          f"{drop.generator.device}")
    if not (torch.equal((y != 0).any(dim=(2, 3)), ~zeroed) and scale_err <= 1e-6
            and 0.2 < float(zeroed.float().mean()) < 0.4 and drop.generator.device.type == "cuda"):
        raise AssertionError(f"{label}: channel dropout")
    cfg = _packaged_cfg("sde_supervised_synthetic.yml")
    cfg["model"].update(backbone_name="resnet18", depth_args={
        "intermediate_aspp": True, "aspp_rates": [1, 2], "dropout": 0.2})
    model = joint.build_model(cfg["model"], 19).cuda().train()
    batch = synthetic.to_device_batch(synthetic.make_synthetic_batch(2, 64, 128, seed=3), "cuda")
    out = model(batch)
    sum(out[f"disp_{s}"].sum() for s in range(4)).backward()
    drops = [m for m in model.modules() if isinstance(m, layers.ChannelDropout)]
    blocks = [m for m in model.modules() if isinstance(m, layers.ConvBlock)]
    if not (len(drops) == len(blocks) > 0
            and all(m.generator.device.type == "cuda" for m in drops)
            and len({m.seed for m in drops}) == len(drops)
            and all(torch.isfinite(out[f"disp_{s}"]).all() for s in range(4))):
        raise AssertionError(f"{label}: the decoders' dropout")
    print(f"[{label}] decoders with dropout 0.2 in their {len(drops)} ConvBlocks, each "
          "with its own seed: one train-mode forward and backward on the card, finite")


def phase_options():
    """The model and step options (see the module docstring): (a) exp-212
    with `fuse_unlabeled_forward`, then also `model.remat`; (b) sde with
    `remat_photometric`, and its losses and gradients against the stored
    chain's; (c) exp-210 with `fuse_unlabeled_forward`; each
    against its packaged config in the same turns; (d) small steps with the
    model options, card against CPU, and dropout on the card. Returns the
    launches of every run."""
    label = "options"
    launches = {}
    times = [time.perf_counter()]
    exp212 = _packaged_cfg("exp212_pad_online_synthetic.yml")
    fused = copy.deepcopy(exp212)
    fused["training"]["fuse_unlabeled_forward"] = True
    remat = copy.deepcopy(fused)
    remat["model"]["remat"] = True
    cells = _cells(label + " a", (("exp212", exp212, EXP212_PER_STEP),
                                  ("exp212 fused", fused, EXP212_FUSED_PER_STEP),
                                  ("exp212 fused + remat", remat, EXP212_FUSED_PER_STEP)))
    launches["options_exp212_fused"] = cells["exp212 fused"]["launches"]
    launches["options_exp212_fused_remat"] = cells["exp212 fused + remat"]["launches"]
    m = _measure_turns(label + " a", cells)
    remat_m, fused_m = m["exp212 fused + remat"], m["exp212 fused"]
    print(f"[{label} a] remat: peak {remat_m['peak_bytes'] / 2**30:.3f} GiB against "
          f"{fused_m['peak_bytes'] / 2**30:.3f} GiB, the recompute "
          f"{remat_m['device_ms'] - fused_m['device_ms']:+.2f} ms of device time per step")
    del cells, m
    times.append(time.perf_counter())

    sde = _packaged_cfg("sde_supervised_synthetic.yml")
    remat_ph = copy.deepcopy(sde)
    remat_ph["training"]["remat_photometric"] = True
    cells = _cells(label + " b", (("sde", sde, SDE_PACK_PER_STEP),
                                  ("sde remat_photometric", remat_ph, SDE_PACK_PER_STEP)))
    launches["options_sde_remat_photometric"] = cells["sde remat_photometric"]["launches"]
    _measure_turns(label + " b", cells)
    stored = cells["sde"]
    _remat_photometric_check(label + " b", stored["run"], stored["batches"][0][0])
    del cells, stored
    times.append(time.perf_counter())

    exp210 = _packaged_cfg("exp210_depthcomp_synthetic.yml")
    fused = copy.deepcopy(exp210)
    fused["training"]["fuse_unlabeled_forward"] = True
    cells = _cells(label + " c", (("exp210", exp210, NO_KERNELS),
                                  ("exp210 fused", fused, NO_KERNELS)))
    launches["options_exp210_fused"] = cells["exp210 fused"]["launches"]
    _measure_turns(label + " c", cells)
    del cells
    times.append(time.perf_counter())

    aspp = {"intermediate_aspp": True, "aspp_rates": [1, 2]}
    for name, opts in (
            ("n_project_skip_ch 16, aspp_pooling off, dropout 0",
             {"depth_args": dict(aspp, n_project_skip_ch=16, aspp_pooling=False, dropout=0.0)}),
            ("use_skips off", {"depth_args": dict(aspp, use_skips=False)}),
            ("pose_model_input all", {"pose_model_input": "all"}),
            ("provide_uncropped_for_pose", {"provide_uncropped_for_pose": True}),
            ("stereo frames (0, -1, 1, s)", {"frame_ids": [0, -1, 1, "s"]})):
        _small_step(f"{label} d small sde step, {name}", "sde_supervised_synthetic.yml", 2,
                    model_opts=opts)
    _dropout_on_card(label + " d")
    times.append(time.perf_counter())
    print(f"[{label}] part times: " + ", ".join(
        f"{p} {b - a:.1f} s" for p, a, b in zip("abcd", times, times[1:])))
    return launches


def main():
    t0 = time.perf_counter()
    card = phase_device()
    # the runs' log paths default to $SDT_OUT_DIR/logs: keep them out of the checkout
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_out_")
    os.environ["SDT_OUT_DIR"] = out_dir
    try:
        phase_build()
        records = phase_kernels()
        phase_small_steps()
        launches = phase_slices()
        launches.update(phase_sde_pretrain())
        launches.update(phase_cityscapes_exp212(records))
        launches.update(phase_exp211())
        launches.update(phase_experiments())
        launches.update(phase_options())
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    main_path = launches["exp212_pad_online_cityscapes"]
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
    print(f"[smoke] total wall time {time.perf_counter() - t0:.1f} s")
    print(card)  # again near the end: the output's head may be cut
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
