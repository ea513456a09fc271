"""One intra-op thread for the port's CPU tests.

The tier-1 command runs several pytest workers on one machine, and
torch's default intra-op pool (a thread per core in every worker) makes
them spin against each other on the plain versions' small tensors: two
port test files took twice the CPU time on the default pool for a longer
wall time, under the load of a third worker. ``one_thread`` runs a test
module on one thread, as the gloo ranks of ``torch_ranks`` already run,
and gives the worker its thread count back after the module. A module
imports it by name; it is autouse.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
