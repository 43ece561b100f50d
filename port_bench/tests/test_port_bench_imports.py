"""What the benchmark loads: nothing of JAX or of the JAX package anywhere,
and nothing of the port in the plain reference. Module names are compared
by their top-level name whole: the port's name begins with the JAX
package's."""

import json
import subprocess
import sys

from port_bench.harness.manifest import ROOT

JAX_NAMES = ("jax", "jaxlib", "flax", "improving_segmentation_with_selfsupervised_depth_tpu")
PORT = "improving_segmentation_with_selfsupervised_depth_tpu_torch"


def _loaded(code: str):
    """The top-level names of the modules a fresh interpreter holds after
    running `code` from the checkout's root."""
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_its_readers_load_no_jax():
    top = _loaded(
        "import port_bench.harness.cell, port_bench.calibrate\n"
        "from port_bench.harness.manifest import load_benchmark, load_reader\n"
        "b = load_benchmark()\n"
        "[load_reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "port_bench.harness.cell._port()")
    assert not top & set(JAX_NAMES), top & set(JAX_NAMES)
    assert PORT in top  # the program is the port


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded("import port_bench.reference.steps, port_bench.reference.segsde.engine.train_steps,"
                  " port_bench.harness.flops")
    assert PORT not in top
    assert not top & set(JAX_NAMES)


def test_no_source_of_the_benchmark_names_the_jax_package_or_the_old_harness():
    for path in (ROOT / "port_bench").rglob("*.py"):
        if "tests" in path.relative_to(ROOT).parts:
            continue
        text = path.read_text()
        for word in ("import jax", "from jax", "import flax", "bench_artifacts", "bench.py"):
            assert word not in text, (path, word)
        for line in text.splitlines():
            if line.lstrip().startswith(("import ", "from ")):
                assert "improving_segmentation_with_selfsupervised_depth_tpu " not in line + " "
                assert "improving_segmentation_with_selfsupervised_depth_tpu." not in line, line
