"""The least work of the port's kernels in one training step, from the
shapes of the step's photometric passes: the bytes each needs to read and
write (every input once, every output once) and its f32 operations. The
arithmetic of the port's `chip_smoke.py`: K1 reads the source frame and its
grids (8 bytes a pixel) and writes three planes; K2 reads the predictions
and the target and writes one plane; K3 reads the predictions, the target
and the incoming gradient and writes one gradient per channel. Operations
per (pixel, channel), counted from the kernels' arithmetic (a division
counts as one): K1 17 per channel plus 16 per grid pixel, K2 76, K3 143.

A step's passes: the labeled batch's, and the unlabeled batch's where the
semi-supervised step takes the photometric loss on it (online DepthMix).
The target frame is counted once a pass, however many launches read it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from .traffic import shape_of, step_kind

F32 = 4
K1_OPS_PER_CHANNEL, K1_OPS_PER_PIXEL = 17, 16
K2_OPS = 76
K3_OPS = 143


def passes(config: Dict[str, Any], traffic: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The photometric passes of a step: rows (over all passes), source
    frames, scales, pixels, whether the pred error takes K2/K3 and whether
    the automask takes K2; None without a photometric loss."""
    t = config["training"]
    if t.get("monodepth_lambda", 0.0) <= 0:
        return None
    mono = dict(config.get("monodepth_options", {}))
    mono.update(t.get("monodepth_loss") or {})
    frames, scales, _ = shape_of(config)
    rows = traffic["batch"]
    if step_kind(config)["photometric_unlabeled"]:
        rows += traffic.get("unlabeled_batch", 0)
    ssim = not mono.get("no_ssim", False)
    return {"rows": rows, "sources": len(frames) - 1, "scales": scales,
            "pixels": traffic["height"] * traffic["width"],
            "fused": ssim and bool(t.get("fused_reprojection", False)),
            "automask": ssim and not mono.get("disable_automasking", False)}


def k1(p: Dict[str, Any]) -> Tuple[int, int]:
    n, f, s, px = p["rows"], p["sources"], p["scales"], p["pixels"]
    m = n * s
    return (f * F32 * (n * 3 * px + 2 * m * px + 3 * m * 3 * px),
            f * m * px * (K1_OPS_PER_PIXEL + 3 * K1_OPS_PER_CHANNEL))


def k2(p: Dict[str, Any]) -> Optional[Tuple[int, int]]:
    n, f, s, px = p["rows"], p["sources"], p["scales"], p["pixels"]
    preds = (f * n if p["automask"] else 0) + (f * n * s if p["fused"] else 0)
    if not preds:
        return None
    return F32 * (n * 3 * px + preds * 4 * px), preds * 3 * px * K2_OPS


def k3(p: Dict[str, Any]) -> Optional[Tuple[int, int]]:
    if not p["fused"]:
        return None
    n, f, s, px = p["rows"], p["sources"], p["scales"], p["pixels"]
    m = f * n * s
    return F32 * (n * 3 * px + 2 * m * 3 * px + m * px), m * 3 * px * K3_OPS


def roofline_share(ctx, patterns, work) -> Optional[float]:
    """Percent of the least time the step's work of a kernel could take (the
    larger of bytes over the card's bandwidth and operations over its f32
    rate) in the device time of the launches whose names match `patterns`;
    None where the trace holds none of them or the card's peaks are not
    known."""
    if ctx.trace is None or ctx.peaks is None:
        return None
    p = passes(ctx.config, ctx.traffic)
    amount = work(p) if p is not None else None
    ops = ctx.trace.matching(patterns)
    if amount is None or not ops:
        return None
    n_bytes, n_ops = amount
    bound = max(n_bytes / ctx.peaks["hbm_bytes_per_s"], n_ops / ctx.peaks["fp32"])
    return 100.0 * bound / ctx.trace.seconds_per_step(ops)
