"""One intra-op thread per torch test, for the port's CPU test files that
train or run InceptionV3.

The suite runs in several pytest-xdist workers at once (``-n 6``), and
torch gives each one a thread per core: on an 8-core host that is 48
threads whose OpenMP barriers spin against each other, which made a tiny
fine-tune 20x slower than alone (190 s against 9 s). The tests' shapes are
small, so one thread each costs little alone and nothing under the
workers. A test file takes the fixture by importing it::

    from torch_threads import one_torch_thread  # noqa: F401

The count is restored after each test.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
