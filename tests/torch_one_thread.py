"""One intra-op torch thread for the port's CPU test modules (not
collected by pytest).  The suite's workers share the host's cores, and at
the tests' sizes more threads add CPU load, not speed.  A module turns it
on by importing the fixture:

    from torch_one_thread import one_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
