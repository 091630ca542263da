"""A module fixture for the port's CPU tests: two intra-op torch threads.

Tier-1 runs six pytest workers on the CPU, each with a torch thread per
core by default; oversubscribed, the torch forwards run several times
slower. A test module takes the cap by importing the fixture:

    from torch_threads import _two_threads  # noqa: F401 (autouse)
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
