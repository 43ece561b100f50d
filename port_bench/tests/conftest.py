"""The benchmark's own tests (not the repository's tier-1 `tests/`).

    python -m pytest -p no:cacheprovider port_bench/tests            # on the CPU
    python3 -m pytest -p no:cacheprovider port_bench/tests -m cuda   # on a CUDA card

Tests marked `cuda` need a CUDA card and skip without one; whether there is
one is decided inside the test (the `cuda` fixture), never at import.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
