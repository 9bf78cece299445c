"""The port tests' shared fixture: torch on one thread in each test module.

Tiny models' ops under several test workers on a few cores: torch's
spinning thread pool slows each op by an order of magnitude, so a port test
module imports this autouse fixture::

    from torch_port_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
