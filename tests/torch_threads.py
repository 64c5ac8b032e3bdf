"""A fixture for the port's CPU tests: one intra-op torch thread per module.

The tests run many tiny ops, and the test workers share one machine: with
torch's default pool (a thread a core, spinning between ops) in every worker,
a module of small training steps ran some 25x slower than with one thread.
Import ``one_torch_thread`` into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
