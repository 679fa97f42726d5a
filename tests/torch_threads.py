"""The thread fixture of the port's CPU test modules (``test_torch_*.py``).

A module takes it with ``from torch_threads import one_torch_thread``: an
autouse fixture imported into a module applies to that module's tests."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module, then the setting it had: at
    these small shapes more threads buy little, and beside other test
    processes (pytest-xdist) they oversubscribe the cores; two workers on
    eight cores took 228 s for what one thread each ran in 35 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
