"""The program's phase spans on a synthetic device trace
(`harness/phases.py`): which span launched each operation, the idle gaps'
names, the host time, syncs and collections per step, and that every
reader of `BENCHMARK.json` reads a `PhaseTrace` as it reads the harness's
own `Trace`.

The trace: one step; the trace's clock 500 ns ahead of the host's (the
least of three probes' gaps), the marker launched at host time 1,000, then ops launched in
`to_device`, `forward`, `photometric`, `backward` (two: by time, whatever
the thread), `optimizer`, `ema`, `train_step` outside its phases, one copy
after `train_step` and one op whose launching call the trace lacks.
"""

import pytest

from port_bench.harness import cell as cells
from port_bench.harness import phases, trace
from port_bench.harness.manifest import load_benchmark, load_cell, load_reader

SHIFT = 500  # trace time - host time
MS = 1_000_000


def _synthetic():
    # (name, host time of the launching call or None, device start, device end)
    launched = [
        ("spin_kernel", 1_000, 2_000, 3_000),
        ("copy_nhwc_to_nchw", 10 * MS, 10 * MS + 100, 11 * MS),        # to_device
        ("sm90_xmma_fprop", 21 * MS, 21 * MS + 100, 25 * MS),           # forward
        ("reflection_pad2d_out", 31 * MS, 31 * MS + 100, 33 * MS),      # photometric
        ("avg_pool2d_out", 32 * MS, 33 * MS, 34 * MS),                  # photometric
        ("sm90_xmma_dgrad", 41 * MS, 41 * MS + 100, 45 * MS),           # backward
        ("batch_norm_backward", 46 * MS, 46 * MS + 100, 48 * MS),       # backward
        ("multi_tensor_apply", 61 * MS, 61 * MS + 100, 62 * MS),        # optimizer
        ("vectorized_elementwise", 71 * MS, 71 * MS + 100, 72 * MS),    # ema
        ("reduce_kernel", 76 * MS, 76 * MS + 100, 77 * MS),             # train_step itself
        ("Memcpy DtoH", 81 * MS, 81 * MS + 100, 82 * MS),               # after train_step
        ("fill_kernel", None, 83 * MS, 84 * MS),                        # no call in the trace
    ]
    ops = [trace.Op(n, s + SHIFT, e + SHIFT) for n, _, s, e in launched]
    launches = {(n, s + SHIFT): at + SHIFT for n, at, s, e in launched if at is not None}
    harness = [("feed", 9 * MS, 12 * MS), ("dispatch", 20 * MS, 80 * MS),
               ("sync", 80 * MS, 90 * MS)]
    program = [("to_device", 9 * MS, 12 * MS), ("train_step", 20 * MS, 80 * MS),
               ("forward", 20 * MS, 30 * MS), ("photometric", 30 * MS, 40 * MS),
               ("backward", 40 * MS, 60 * MS), ("gc", 50 * MS, 58 * MS),
               ("optimizer", 60 * MS, 70 * MS), ("ema", 70 * MS, 75 * MS)]
    syncs = [(25 * MS, "a.py:1"), (62 * MS, "b.py:2"), (85 * MS, "a.py:1")]
    shift = phases.host_shift([500, 900, 1_300], [1_010, 1_400, 1_830])
    found = phases.build(ops, launches, shift, 1, 1_000, (1_000, 90 * MS), harness, program,
                         syncs)
    base = trace.build_trace(ops, 1, 1_000, (1_000, 90 * MS), harness)
    return found, base


def test_every_operation_goes_to_the_innermost_span_that_launched_it():
    found, _ = _synthetic()
    assert found.host_shift_ns == SHIFT
    by = found.by_span()
    assert {k: round(1e3 * s, 6) for k, (s, _) in by.items()} == {
        "to_device": 0.9999, "forward": 3.9999, "photometric": 2.9999, "backward": 5.9998,
        "optimizer": 0.9999, "ema": 0.9999, "train_step": 0.9999, "unattributed": 1.9999}
    kernels = {k: n for k, (_, n) in by.items()}
    # the copy is timed but is no kernel, as in `kernels_per_step`
    assert kernels["unattributed"] == 1 and kernels["backward"] == 2
    total = sum(op.end_ns - op.start_ns for op in found.ops) / 1e9
    assert sum(s for s, _ in by.values()) == pytest.approx(total, rel=1e-12)
    ctx = cells.Context(cell=None, window=None, setup_s=0.0, window_peak_bytes=0, trace=found,
                        peaks=None)
    assert sum(n for _, n in by.values()) == load_reader("kernels_per_step").read(ctx)


def test_idle_gaps_are_named_by_harness_span_then_program_span():
    found, base = _synthetic()
    gaps = found.phase_gaps()
    assert [s for _, s in gaps] == [s for _, s in base.idle_gaps()]
    assert [(n, round(1e3 * s, 4)) for n, s in gaps] == [
        ("dispatch/gc", 13.0001), ("loop", 10.0001), ("loop", 9.9981),
        ("dispatch/optimizer", 9.0001), ("dispatch/photometric", 7.0001), ("sync", 6.001),
        ("dispatch/forward", 6.0001), ("dispatch/ema", 4.0001), ("dispatch/train_step", 4.0001),
        ("dispatch/backward", 1.0001), ("sync", 1.0)]


def test_host_time_syncs_and_collections_per_step():
    found, _ = _synthetic()
    assert found.host_ms(("optimizer", "ema")) == pytest.approx(15.0)
    assert found.host_ms(("mix",)) is None
    assert found.host_ms(phases.PHASES) == pytest.approx(55.0)
    assert found.syncs_per_step() == 2  # the third is after train_step
    assert phases.gc_ms([("gc", 0, 2 * MS), ("gc", 5 * MS, 6 * MS)], 3) == pytest.approx(1.0)
    assert phases.gc_ms([], 3) == 0 and phases.gc_ms([], 0) is None


def test_the_innermost_span_of_a_time():
    find = phases.Innermost([("a", 0, 100), ("b", 10, 50), ("c", 20, 30), ("d", 60, 70)])
    assert [find(t) for t in (-1, 0, 15, 25, 30, 55, 65, 100, 150)] == [
        None, "a", "b", "c", "b", "a", "d", None, None]


def test_without_the_probes_there_is_no_phase_trace():
    ops = [trace.Op("spin_kernel", 2_500, 3_500), trace.Op("k", 4_000, 5_000)]
    assert phases.host_shift([500, 900], [1_010]) is None and phases.host_shift([], []) is None
    assert phases.build(ops, {}, None, 1, 1_000, (1_000, 10_000), [], [], []) is None


@pytest.mark.parametrize("workload", ["exp212_pad_online.b4", "sde_dec6_crop_amp.b4"])
def test_every_reader_reads_a_phase_trace_as_the_harness_s_trace(workload):
    found, base = _synthetic()
    cell = load_cell(workload)
    window = cells.Window(steps=10, seconds=5.0, intervals_ms=[400.0] * 9,
                          dispatch_s=[0.3] * 10, batch=4, losses=[1.0] * 10)
    read = {}
    for t in (base, found):
        ctx = cells.Context(cell=cell, window=window, setup_s=20.0, window_peak_bytes=2**30,
                            trace=t, peaks=cells.H100_PEAKS, _flops=10**13)
        read[id(t)] = {m["name"]: load_reader(m["name"]).read(ctx)
                       for m in load_benchmark()["per_layer"] + load_benchmark()["end_to_end"]}
    assert read[id(found)] == read[id(base)]
    assert read[id(base)]["kernels_per_step"] == 10 and read[id(base)]["ssim_chain_ms"] > 0
    harness = cells.breakdown(base)
    extended = phases.breakdown(found)
    assert extended["device_ops"][:len(harness["device_ops"])] == harness["device_ops"]
    assert any(n.startswith("span: ") for n, _ in extended["device_ops"])
