"""The benchmark's own tests, on the CPU at ``tiny.json``'s sizes.

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA device and skip without one (decided inside
the test); run them on the chip with ``python -m pytest benchmark/tests -m card``.
"""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = Path(__file__).resolve().parent / "tiny.json"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def tiny() -> dict:
    with open(TINY) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    yield
    torch.set_num_threads(n)
