"""A cell at a size a CPU test run holds: the cell's configuration as it
is, its traffic cut to 4 (+ 4) rows of 48x48 (4, so that half a batch still
has 2 rows for the ASPP's pooled BatchNorm)."""

import copy

from port_bench.harness.manifest import load_cell


def tiny_cell(name: str):
    cell = load_cell(name)
    t = copy.deepcopy(cell.traffic)
    t.update(batch=4, unlabeled_batch=4 if t["unlabeled_batch"] else 0, height=48, width=48,
             source_height=48, source_width=96, label_cell=16)
    cell.traffic = t
    return cell
