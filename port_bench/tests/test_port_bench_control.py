"""The control of each cell comes out as not correct: the plain reference
computed in the step below the configuration's precision (bf16 for
exp-212's TF32 convolutions, float8 convolutions for dec6's bf16), put in
the program's place, fails at least one of the cell's compared numbers,
while the program, on the same seeds, passes every one.

On the CPU at a tiny size (`_tiny.py`; the CPU has no TF32, so there the
program and the reference agree to the bit); on the card at the cell's own
size, on three seeds (`-m cuda`; PERF.md gives the readings the limits were
set from, `calibrate.py` makes them)."""

import pytest
import torch

from port_bench.harness import cell as harness
from port_bench.harness.compare import gaps
from port_bench.harness.manifest import load_cell
from port_bench.tests._tiny import tiny_cell

CELLS = ["exp212_pad_online.b4", "sde_dec6_crop_amp.b4"]


def _readings(cell, seed, device):
    with harness.scratch_dir() as scratch:
        program = harness.set_up(cell, seed, device, scratch)
        program.run = None
        harness.free(device)
        ref = harness.reference_readings(cell, seed, program, device)
        control = harness.reference_readings(cell, seed, program, device,
                                             precision=cell.config["control_precision"])
    return gaps(program.readings, ref), gaps(control, ref)


def _over(readings, limits):
    return {n for n, limit in limits.items() if readings[n][0] > limit}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_cpu(name):
    torch.set_num_threads(4)
    cell = tiny_cell(name)
    program, control = _readings(cell, 7, "cpu")
    limits = cell.workload["limits"]
    assert not _over(program, limits), program
    assert _over(control, limits), {n: control[n] for n in limits}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [9001, 9002, 9003])
def test_the_control_fails_on_the_card_at_the_cells_size(name, seed, cuda):
    cell = load_cell(name)
    program, control = _readings(cell, seed, cuda)
    limits = cell.workload["limits"]
    assert not _over(program, limits), program
    assert _over(control, limits), {n: control[n] for n in limits}
