"""The command refuses to measure without a card, and in a checkout that
holds only BENCHMARK.json and the benchmark's files: no result, an exit
code other than 0."""

import os
import shutil
import subprocess
import sys

import pytest

from port_bench.harness.manifest import BENCH_DIR, ROOT

ARGS = ["--workload", "sde_dec6_crop_amp.b4", "--seed", "2147483711", "--seconds", "1",
        "--trace", "0"]


def _run(root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_only_the_benchmark_files_no_result_on_the_card(tmp_path, cuda):
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
