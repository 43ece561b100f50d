"""Stored label-selection results: the port's copy of the JAX package's
`data/preselected.py`.

The reference hard-codes the selected image indices per dataset, method and
seed in loader/preselected_labels.py (tables of exp-211's results). Here the
tables are JSON files, one per dataset, next to this module (or under
SDT_PRESELECTED_DIR), which `store_selection` writes (from a label-selection
run's `nlabels{N}_subset.json`) and `import_reference_tables` fills from the
reference's module.

  preselected_labels(seed, n, dataset, method) -> the first n stored indices
  with seed in {42, 43, 44} and method in {"ent", "ds", "us", "ds_us"}.
"""

from __future__ import annotations

import json
import os
from typing import List

_DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "preselected_tables")


def _table_path(dataset: str) -> str:
    base = os.environ.get("SDT_PRESELECTED_DIR", _DEFAULT_DIR)
    return os.path.join(base, f"{dataset}.json")


def store_selection(dataset: str, method: str, seed: int, indices: List[int]) -> str:
    """Store `indices` as the selection of (`dataset`, `method`, `seed`).
    Returns the table's path."""
    path = _table_path(dataset)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    table.setdefault(method, {})[str(seed)] = [int(i) for i in indices]
    with open(path, "w") as f:
        json.dump(table, f)
    return path


def preselected_labels(seed: int, n: int, dataset: str = "cityscapes",
                       method: str = "ds_us") -> List[int]:
    """The first `n` stored indices of (`dataset`, `method`, `seed`)."""
    path = _table_path(dataset)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"No preselected-label table for {dataset} at {path}. Run the "
            f"label-selection experiment (id 211) to generate one, or import "
            f"the reference's tables with import_reference_tables().")
    with open(path) as f:
        table = json.load(f)
    sel = table[method][str(seed)]
    if len(sel) < n:
        raise ValueError(f"Stored selection has {len(sel)} < {n} indices")
    return sel[:n]


def import_reference_tables(reference_root: str) -> None:
    """Store the reference's tables (its module is imported and called for
    each combination; no code is copied: the tables are results)."""
    import importlib.util
    import sys

    path = os.path.join(reference_root, "loader", "preselected_labels.py")
    spec = importlib.util.spec_from_file_location("_ref_preselected", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_ref_preselected"] = mod
    spec.loader.exec_module(mod)
    for dataset in ("cityscapes", "camvid"):
        for method in ("ent", "ds", "us", "ds_us"):
            for seed in (42, 43, 44):
                try:
                    sel = mod.preselected_labels(seed, 10**9, dataset, method)
                except Exception:
                    try:
                        # a table shorter than the request: ask for one index
                        sel = mod.preselected_labels(seed, 1, dataset, method)
                    except Exception:
                        continue
                store_selection(dataset, method, seed, sel)
