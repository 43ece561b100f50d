"""What a run reads before it starts: `BENCHMARK.json` at the checkout's root
and, by the names it gives, the cell's own files under `port_bench/`:

  workloads/<cell>.json     the cell: its configuration, traffic, chips, why,
                            the steps the reference follows and the limits of
                            the comparison that decides `correct`
  configs/<config>.json     the configuration as it is run (`config`), with
                            its source, the port YAML it starts from, each
                            key changed and why, `reduced` and `assumed`
  traffic/<traffic>.json    the parameters the one generator
                            (`harness/traffic.py`) reads
  metrics/<metric>.py       one reader per metric (`read(ctx)`)

Nothing here names a cell, a configuration or a metric: a new one is a new
file and an entry in `BENCHMARK.json`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]       # the cell's entry in BENCHMARK.json
    workload: Dict[str, Any]    # workloads/<cell>.json
    config: Dict[str, Any]      # configs/<config>.json
    traffic: Dict[str, Any]     # traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _read_json(Path(root) / "BENCHMARK.json")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Optional[Path] = None) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its files; raises
    where the cell is unknown or its file disagrees with the entry."""
    bench = load_benchmark(root)
    bench_dir = Path(bench_dir) if bench_dir is not None else Path(root) / "port_bench"
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    workload = _read_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key} {workload[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = _read_json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = _read_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, entry=entry, workload=workload, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The module of metrics/<metric>.py; it defines `read(ctx)`, which
    returns the metric's value or None where it finds nothing to read."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"{path} defines no read(ctx)")
    return module
