"""Fixtures that several of the port's test files share; a test file
imports the ones it takes by name."""

import pytest
import torch


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test (restored after): tiny
    shapes gain nothing from threads, and beside other busy test processes
    idle OpenMP threads stall each op (the kernel-variant CLI test alone
    under six busy processes: 51.6 s at 8 threads, 10.5 s at one; the
    vanilla CLI's 300-step run in the 6-worker suite: 150 s with every
    core, 14 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
