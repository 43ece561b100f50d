"""BENCHMARK.json against the benchmark's contract and against the files
it names."""

import json
import math
import re

import pytest

from port_bench.harness.manifest import BENCH_DIR, ROOT, load_benchmark, load_cell, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"]
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert bench["command"][:2] == ["python3", "port_bench/run.py"]
    assert len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key), key
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_end_to_end_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_every_per_layer_metric_has_its_reader_and_moves_a_reported_metric(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        reader = load_reader(m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
        assert reader.UNIT == m["unit"]
    for m in bench["end_to_end"]:
        assert load_reader(m["name"]).UNIT == m["unit"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        # a cell that reports a per-layer metric reports what it moves
        assert "samples_per_s" in e2e
        assert {m["moves"] for m in cell.per_layer} <= e2e


def test_configurations_and_cells_agree_with_their_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert set(data["reduced"]) <= set(data["changed"])
        assert data["precision"] in ("tf32", "bf16")
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.workload["why"] == w["why"]
        assert cell.workload["limits"], "a cell compares at least one number"
        for name, limit in cell.workload["limits"].items():
            assert math.isfinite(limit) and limit > 0


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
