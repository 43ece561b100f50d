"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files alone: in a copy of the benchmark, new files and new entries in
BENCHMARK.json, and no file that was there changes."""

import hashlib
import json
import shutil

from port_bench.harness.manifest import BENCH_DIR, ROOT, load_cell, load_reader


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_configuration_cell_and_metric_are_new_files(tmp_path):
    bench_dir = tmp_path / "port_bench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench_dir)

    config = json.loads((bench_dir / "configs" / "sde_dec6_crop_amp.json").read_text())
    config["name"] = "sde_dec6_crop_amp_wide"
    (bench_dir / "configs" / "sde_dec6_crop_amp_wide.json").write_text(json.dumps(config))
    traffic = json.loads((bench_dir / "traffic" / "sde_b4_512.json").read_text())
    traffic["batch"] = 8
    (bench_dir / "traffic" / "sde_b8_512.json").write_text(json.dumps(traffic))
    workload = json.loads((bench_dir / "workloads" / "sde_dec6_crop_amp.b4.json").read_text())
    workload.update(config="sde_dec6_crop_amp_wide", traffic="sde_b8_512", why="batch 8")
    (bench_dir / "workloads" / "sde_dec6_crop_amp_wide.b8.json").write_text(json.dumps(workload))
    (bench_dir / "metrics" / "steps_in_window.py").write_text(
        'LAYER = "step: Run.step -> train_step"\nMOVES = "samples_per_s"\nUNIT = "steps"\n\n\n'
        "def read(ctx):\n    return ctx.window.steps\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sde_dec6_crop_amp_wide", "source": "as sde_dec6_crop_amp",
                             "file": "port_bench/configs/sde_dec6_crop_amp_wide.json",
                             "reduced": config["reduced"], "why": "a test"})
    bench["workloads"].append({"name": "sde_dec6_crop_amp_wide.b8",
                               "config": "sde_dec6_crop_amp_wide", "traffic": "sde_b8_512",
                               "chips": 1, "why": "batch 8"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "step: Run.step -> train_step",
                               "moves": "samples_per_s",
                               "workloads": ["sde_dec6_crop_amp_wide.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("sde_dec6_crop_amp_wide.b8", tmp_path)
    assert cell.traffic["batch"] == 8 and cell.config["name"] == "sde_dec6_crop_amp_wide"
    assert [m["name"] for m in cell.per_layer][-1] == "steps_in_window"
    assert "steps_in_window" not in [m["name"] for m in load_cell("sde_dec6_crop_amp.b4",
                                                                  tmp_path).per_layer]

    class Ctx:
        class window:
            steps = 17

    assert load_reader("steps_in_window", bench_dir).read(Ctx) == 17
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
