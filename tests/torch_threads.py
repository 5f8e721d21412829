"""A few torch threads for a port test module.

The suite runs its files in several worker processes at once, and a CPU
torch process takes a thread per core by default, so the workers'
intra-op threads outnumber the cores many times over and wait on each
other. A test module imports ``few_torch_threads`` to run its tests and
module fixtures on ``THREADS`` threads; the previous count comes back after
the module:

    from torch_threads import few_torch_threads  # noqa: F401
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)
