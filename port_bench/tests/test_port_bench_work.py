"""The yardstick's arithmetic against hand counts at small shapes: the
kernels' bytes and operations, a roofline share from a made-up trace, the
idle share, and the FLOP counter."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.harness import flops, work
from port_bench.harness.manifest import BENCH_DIR
from port_bench.harness.trace import Op, Trace

EXP212 = json.loads((BENCH_DIR / "configs" / "exp212_pad_online.json").read_text())["config"]
DEC6 = json.loads((BENCH_DIR / "configs" / "sde_dec6_crop_amp.json").read_text())["config"]


def _traffic(n, nu, h, w):
    return {"batch": n, "unlabeled_batch": nu, "height": h, "width": w}


def test_passes():
    p = work.passes(EXP212, _traffic(2, 2, 8, 16))
    assert p == {"rows": 4, "sources": 2, "scales": 4, "pixels": 128, "fused": True,
                 "automask": True}
    p = work.passes(DEC6, _traffic(3, 0, 8, 16))
    assert p["rows"] == 3 and not p["fused"] and p["automask"]


def test_k1_hand_count():
    # 1 row, 1 source frame, 2 scales, 2x2 pixels: the frame 3*4 floats,
    # the grids 2*2*4 floats, three planes 3*2*3*4 floats
    p = {"rows": 1, "sources": 1, "scales": 2, "pixels": 4, "fused": False, "automask": True}
    n_bytes, n_ops = work.k1(p)
    assert n_bytes == 4 * (12 + 16 + 72)
    assert n_ops == 2 * 4 * (16 + 3 * 17)
    assert work.k1(dict(p, sources=2)) == (2 * n_bytes, 2 * n_ops)


def test_k2_and_k3_hand_count():
    p = {"rows": 1, "sources": 2, "scales": 2, "pixels": 4, "fused": False, "automask": True}
    # the target once (3*4), two identity sources (2 * 3*4) and their planes (2 * 4)
    assert work.k2(p) == (4 * (12 + 24 + 8), 2 * 12 * 76)
    assert work.k3(p) is None
    fused = dict(p, fused=True)
    # plus the packed predictions, 2 frames * 2 scales: 4 * (3*4) in, 4 * 4 out
    assert work.k2(fused) == (4 * (12 + 24 + 8 + 48 + 16), (2 + 4) * 12 * 76)
    # the target once, the predictions and their gradients (2 * 4 * 12), g (4 * 4)
    assert work.k3(fused) == (4 * (12 + 96 + 16), 4 * 12 * 143)
    assert work.k2(dict(p, automask=False)) is None


class _Ctx:
    def __init__(self, trace, config, traffic):
        self.trace, self.config, self.traffic = trace, config, traffic
        self.peaks = {"hbm_bytes_per_s": 1e9, "fp32": 1e12}


def test_roofline_share_from_a_trace():
    traffic = _traffic(1, 0, 2, 2)
    cfg = json.loads(json.dumps(DEC6))
    n_bytes, _ = work.k1(work.passes(cfg, traffic))
    bound = n_bytes / 1e9
    # two steps, each with one warp taking four times the bound
    ops = [Op("warp_bilinear_nchw_kernel", 0, int(4e9 * bound)),
           Op("interleave_rgb_kernel", 10**9, 10**9),
           Op("warp_bilinear_nchw_kernel", 2 * 10**9, 2 * 10**9 + int(4e9 * bound))]
    t = Trace(ops=ops, steps=2, window_ns=(0, 3 * 10**9), spans=[])
    share = work.roofline_share(_Ctx(t, cfg, traffic), ("warp_bilinear_nchw_kernel",), work.k1)
    assert share == pytest.approx(25.0, rel=1e-6)
    assert work.roofline_share(_Ctx(t, cfg, traffic), ("nothing",), work.k1) is None


def test_busy_union_and_idle_gaps():
    ops = [Op("a", 10, 30), Op("b", 20, 40), Op("c", 60, 70)]
    t = Trace(ops=ops, steps=1, window_ns=(0, 100),
              spans=[("dispatch", 0, 50), ("sync", 50, 100)])
    assert t.busy_intervals() == [(10, 40), (60, 70)]
    assert t.busy_s == pytest.approx(40e-9)
    assert t.idle_gaps() == [("sync", 30e-9), ("sync", 20e-9), ("dispatch", 10e-9)]


def test_the_flop_counter_counts_a_convolution_by_hand():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False, device="meta")
    x = torch.empty((2, 3, 5, 7), device="meta")
    with FlopCounterMode(display=False) as fc:
        conv(x)
    assert fc.get_total_flops() == 2 * 2 * 8 * 5 * 7 * 3 * 3 * 3


def _conv_macs(config, n, h, w):
    """{conv name: multiply-adds} of one student forward with its pose
    network, from the shapes a real forward at this size gives."""
    from port_bench.reference.steps import build_reference_model

    model = build_reference_model(config, "cpu")
    model.eval()
    macs = {}

    def hook(name):
        def count(mod, inp, out):
            k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
            macs[name] = macs.get(name, 0) + out.numel() * k
        return count

    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(hook(name))
    batch = {f"color_aug_{f}_0": torch.rand((n, 3, h, w)) for f in (0, -1, 1)}
    with torch.no_grad():
        model(batch)
    return macs


def test_step_flops_is_a_hand_tally_of_the_steps_convolutions():
    """dec6 at 32x32: 2 multiply-adds a forward convolution; for every
    student convolution 2 more for its kernel's gradient and, where its
    input needs one (all but the first layers, which read the frames), 2
    more for the input's. The ImageNet encoder runs forward only. The pose
    geometry's 4x4 products are the rest (under a ten-thousandth)."""
    traffic = _traffic(2, 0, 32, 32)
    macs = _conv_macs(DEC6, 2, 32, 32)
    first = {"models.encoder.encoder.conv1", "models.pose_encoder.encoder.conv1"}
    hand = 0
    for name, m in macs.items():
        hand += 2 * m
        if not name.startswith("models.imnet_encoder."):
            hand += 2 * m + (0 if name in first else 2 * m)
    counted = flops.step_flops(DEC6, traffic)
    assert counted == pytest.approx(hand, rel=1e-4)
    assert flops.step_flops(DEC6, _traffic(4, 0, 32, 32)) == pytest.approx(2 * counted, rel=1e-6)
