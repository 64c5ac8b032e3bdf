"""What the port's ``cuda`` test cases share beside card_cases.py (the case
tables, input builders and ``launched``, which chip_smoke.py's kernel table
takes too): the ``card`` fixture and the kernel-against-plain comparison
(``assert_close``, at card_cases.TOL).

A test file with ``cuda`` cases imports no JAX: the card machine has none,
and runs the file alone with ``python -m pytest <file> -m cuda --noconftest``
(tests/conftest.py imports JAX). Import the fixture into the test module as
``tests/torch_threads.py``'s is: ``from torch_card import card``."""

import pytest
import torch

from card_cases import TOL

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# a dropout kernel's keep mask, read back: the kept share of its draws (1.7 M
# in the short attention's case) must lie within KEPT_TOL of 1 - p (about 4
# standard deviations)
KEPT_TOL = 1e-3


def assert_close(got: torch.Tensor, want: torch.Tensor, dtype_name: str) -> None:
    atol, rtol = TOL[dtype_name]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.fixture
def card():
    """The CUDA device, TF32 off; skips without one (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest <this file> -m cuda --noconftest` on one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
