"""The one generator of training traffic: a ring of host batches made from
`--seed` and a traffic file's parameters, and the step draws that the checked
steps inject.

A batch has the key set and layout of the port's Cityscapes loader
(`data/base.py`; NHWC float32 frames in [0, 1] on the host, pinned on a
CUDA run), which `data/loader.py::to_device_batch` copies to the device:

  color_{f}_{s}     every frame f of the configuration at every scale s
                    (2x2 means of the scale above, as the loader's
                    antialiased resize)
  color_aug_{f}_0   the frames with one brightness / contrast / saturation
                    jitter per sample, on `color_aug_share` of the samples
  K_{s}, inv_K_{s}  the loader's intrinsics: full-resolution focals, the
                    principal point moved by the crop offset (and mirrored
                    on a flip), rows 0 and 1 divided by 2^s
  lbl               int32 labels in blocks of `label_cell` pixels, the top
                    `ignore_top_share` of the rows ignored (250); with
                    `labels` false the key is absent
  onehot_lbl        (unlabeled batch, `unlabeled_onehot`) one-hot labels,
                    zero where ignored and on unlabeled rows
  idx, is_labeled   int32 ids, bool flags (the unlabeled batch's first
                    `unlabeled_labeled_rows` rows are labeled, the others
                    carry ignore labels)

The frames of one sample are windows of one smooth random texture (two
octaves, `texture_cell` pixels and a quarter of it), each frame moved by
`motion_px` pixels a frame id, plus `pixel_noise`: a camera moving sideways
over a textured scene, so that the photometric loss has a signal to warp.

Every seed gives the same sizes and the same amount of work; the seed picks
the values only. Batches are made on the device in a few large calls and
then copied to the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

IGNORE = 250
FULL_RES = (2048, 1024)  # the loader's full_res_shape, (w, h), for a flip


def mix_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for a stream of its own, from the run's seed and parts."""
    x = int(seed) & (2**64 - 1)
    for p in parts:
        x = (x * 6364136223846793005 + 1442695040888963407 + int(p)) & (2**64 - 1)
        x ^= x >> 29
    return x & (2**63 - 1)


def key_of(name: str, *idx) -> str:
    return "_".join([name, *[str(i) for i in idx]])


def shape_of(config: Dict[str, Any]) -> Tuple[List[Any], int, int]:
    """(frame ids, number of scales, number of classes) of a configuration."""
    mono = config["monodepth_options"]
    return list(mono["frame_ids"]), int(mono["num_scales"]), int(config["data"]["n_classes"])


def _uniform(g, device, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _texture(g, device, n: int, h: int, w: int, cell: int) -> torch.Tensor:
    """(n, 3, h, w) smooth random texture in (0, 1): two octaves of bilinearly
    upsampled normal noise through a sigmoid."""
    out = torch.zeros((n, 3, h, w), device=device)
    for c, amp in ((cell, 1.0), (max(cell // 4, 1), 0.35)):
        rows, cols = h // c + 2, w // c + 2
        coarse = torch.randn((n, 3, rows, cols), generator=g, device=device)
        up = F.interpolate(coarse, size=(rows * c, cols * c), mode="bilinear",
                           align_corners=False)
        out = out + amp * up[..., :h, :w]
    return torch.sigmoid(1.5 * out)


def _jitter(g, device, img: torch.Tensor, share: float):
    """One brightness, contrast and saturation factor per sample (the
    loader's shared jitter, applied to all frames of a sample alike)."""
    n = img.shape[0]
    on = (_uniform(g, device, (n, 1, 1, 1)) < share).float()
    b, c, s = (1.0 + on * _uniform(g, device, (n, 1, 1, 1), -0.2, 0.2) for _ in range(3))
    return b, c, s


def _apply_jitter(img, b, c, s):
    out = (img * b).clamp(0, 1)
    mean = out.mean((1, 2, 3), keepdim=True)
    out = ((out - mean) * c + mean).clamp(0, 1)
    gray = out.mean(1, keepdim=True)
    return ((out - gray) * s + gray).clamp(0, 1)


def _intrinsics(g, device, n: int, h: int, w: int, traffic: Dict[str, Any], num_scales: int):
    cam = traffic["camera"]
    src_h, src_w = traffic["source_height"], traffic["source_width"]
    x1 = torch.randint(0, src_w - w + 1, (n,), generator=g, device=device).double()
    y1 = torch.randint(0, src_h - h + 1, (n,), generator=g, device=device).double()
    flip = _uniform(g, device, (n,)) < cam["flip_share"]
    u0 = torch.where(flip, FULL_RES[0] - cam["u0"], torch.full_like(x1, cam["u0"]))
    v0 = torch.where(flip, FULL_RES[1] - cam["v0"], torch.full_like(x1, cam["v0"]))
    out = {}
    for s in range(num_scales):
        K = torch.zeros((n, 4, 4), dtype=torch.float64, device=device)
        K[:, 0, 0] = cam["fx"] / 2**s
        K[:, 1, 1] = cam["fy"] / 2**s
        K[:, 0, 2] = (u0 - x1) / 2**s
        K[:, 1, 2] = (v0 - y1) / 2**s
        K[:, 2, 2] = 1.0
        K[:, 3, 3] = 1.0
        out[key_of("K", s)] = K.float()
        out[key_of("inv_K", s)] = torch.linalg.inv(K).float()
    return out


def _labels(g, device, n: int, h: int, w: int, n_classes: int, traffic: Dict[str, Any],
            labeled_rows: int) -> torch.Tensor:
    cell = traffic["label_cell"]
    coarse = torch.randint(0, n_classes, (n, -(-h // cell), -(-w // cell)), generator=g,
                           device=device)
    lbl = coarse.repeat_interleave(cell, 1).repeat_interleave(cell, 2)[:, :h, :w]
    lbl = lbl.to(torch.int32)
    lbl[:, : int(h * traffic["ignore_top_share"])] = IGNORE
    lbl[labeled_rows:] = IGNORE
    return lbl


def make_batch(g, device, n: int, traffic: Dict[str, Any], config: Dict[str, Any], first_id: int,
               labeled_rows: int, onehot: bool) -> Dict[str, torch.Tensor]:
    """One batch of `n` samples on `device` (NHWC frames)."""
    frames, num_scales, n_classes = shape_of(config)
    h, w = traffic["height"], traffic["width"]
    motion = traffic["motion_px"]
    ids = [f for f in frames if f != "s"]
    reach = int(max(abs(int(f)) for f in ids) * motion) + 1
    scene = _texture(g, device, n, h, w + 2 * reach, traffic["texture_cell"])
    b, c, s = _jitter(g, device, scene, traffic["color_aug_share"])
    batch: Dict[str, torch.Tensor] = {}
    for f in ids:
        x0 = reach + int(round(int(f) * motion))
        img = scene[..., x0:x0 + w]
        img = (img + traffic["pixel_noise"] * torch.randn(img.shape, generator=g,
                                                          device=device)).clamp(0, 1)
        prev = img
        for sc in range(num_scales):
            if sc > 0:
                prev = F.avg_pool2d(prev, 2)
            batch[key_of("color", f, sc)] = prev.permute(0, 2, 3, 1)
        batch[key_of("color_aug", f, 0)] = _apply_jitter(img, b, c, s).permute(0, 2, 3, 1)
    batch.update(_intrinsics(g, device, n, h, w, traffic, num_scales))
    if traffic["labels"]:
        lbl = _labels(g, device, n, h, w, n_classes, traffic, labeled_rows)
        batch["lbl"] = lbl
        if onehot:
            valid = (lbl != IGNORE)
            hot = F.one_hot(torch.where(valid, lbl, 0).long(), n_classes).float()
            batch["onehot_lbl"] = hot * valid[..., None].float()
    batch["idx"] = torch.arange(first_id, first_id + n, dtype=torch.int32, device=device)
    batch["is_labeled"] = torch.arange(n, device=device) < labeled_rows
    return {k: v.contiguous() for k, v in batch.items()}


def make_ring(seed: int, traffic: Dict[str, Any], config: Dict[str, Any], device,
              pin: bool) -> List[Dict[str, Optional[Dict[str, torch.Tensor]]]]:
    """`traffic["ring"]` slots, each {"labeled": batch, "unlabeled": batch or
    None}, every row distinct, on the host (pinned with `pin`)."""
    n, nu = traffic["batch"], traffic.get("unlabeled_batch", 0)
    ring = []
    for slot in range(traffic["ring"]):
        g = torch.Generator(device=device).manual_seed(mix_seed(seed, 1, slot))
        first = slot * (n + nu)
        parts = {"labeled": make_batch(g, device, n, traffic, config, first, n, False),
                 "unlabeled": (make_batch(g, device, nu, traffic, config, first + n,
                                          traffic.get("unlabeled_labeled_rows", 0),
                                          traffic.get("unlabeled_onehot", False))
                               if nu else None)}
        for part, batch in parts.items():
            if batch is None:
                continue
            host = {k: v.cpu() for k, v in batch.items()}
            parts[part] = {k: v.pin_memory() for k, v in host.items()} if pin else host
        ring.append(parts)
    return ring


def step_draws(seed: int, k: int, step: Dict[str, Any], traffic: Dict[str, Any],
               config: Dict[str, Any], device) -> Dict[str, Any]:
    """The draws of checked step `k`: the labeled pass's tie-break noise and
    the fields of `StepDraws`, as plain values and tensors that either side
    turns into its own `StepDraws`. `step` says which the step takes
    (`needs_draws`)."""
    frames, _, n_classes = shape_of(config)
    g = torch.Generator(device=device).manual_seed(mix_seed(seed, 2, k))
    h, w = traffic["height"], traffic["width"]
    f = 1 if step["avg_reprojection"] else len(frames) - 1
    n, nu = traffic["batch"], traffic.get("unlabeled_batch", 0)
    out: Dict[str, Any] = {"tie_break_noise": torch.randn((n, f, h, w), generator=g,
                                                           device=device)}
    draws: Dict[str, Any] = {}
    if step["semi"]:
        if step["photometric_unlabeled"]:
            draws["tie_break_noise_u"] = torch.randn((nu, f, h, w), generator=g, device=device)
        u = torch.rand((8,), generator=g, device=device).tolist()
        if step["color_jitter"]:
            draws["jitter"] = [0.75 + 0.5 * u[0], 0.75 + 0.5 * u[1], 0.75 + 0.5 * u[2],
                               -0.25 + 0.5 * u[3]]
            draws["jitter_apply"] = u[4]
        if step["blur"]:
            draws["blur_sigma"] = 0.15 + u[5]
            draws["blur_apply"] = u[6]
        thr = step["foreground_threshold"]
        if step["mix_mask"] == "depthcomp" and isinstance(thr, (list, tuple)):
            draws["mix_threshold"] = thr[0] + (thr[1] - thr[0]) * u[7]
        elif step["mix_mask"] == "depth":
            draws["mix_threshold"] = 0.1 + 0.3 * torch.rand((nu, 1, 1), generator=g,
                                                            device=device)
        elif step["mix_mask"] == "class":
            draws["class_scores"] = torch.rand((nu, n_classes), generator=g, device=device)
        elif step["mix_mask"] == "depthhist":
            draws["depthhist_u"] = torch.rand((nu,), generator=g, device=device)
    out["draws"] = draws
    out["default_seed"] = mix_seed(seed, 3, k)
    out["generator_seed"] = mix_seed(seed, 4, k)
    return out


def step_kind(config: Dict[str, Any]) -> Dict[str, Any]:
    """What a configuration's step draws, from its `training` section."""
    t = config["training"]
    u = t.get("unlabeled_segmentation") or {}
    mono = dict(config.get("monodepth_options", {}))
    mono.update(t.get("monodepth_loss") or {})
    semi = bool(u)
    online = semi and u.get("depthmix_online_depth", False)
    return {"semi": semi,
            "photometric_unlabeled": online and t.get("monodepth_lambda", 0.0) > 0,
            "avg_reprojection": mono.get("avg_reprojection", False),
            "color_jitter": bool(u.get("color_jitter", False)),
            "blur": bool(u.get("blur", False)),
            "mix_mask": u.get("mix_mask"),
            "foreground_threshold": u.get("depthcomp_foreground_threshold", 0.0)}
