"""The port's CPU test files run torch on a few intra-op threads.

By default torch starts one intra-op thread per core in every process, and
six xdist workers (``-n 6``) then thrash the cores: the port's tests ran
several times their lone time. Every other
``tests/test_torch_*.py`` imports ``torch_threads`` below, an autouse module
fixture, so its tests run on ``THREADS`` threads; the worker's setting is
restored after the module. This file holds no test.
"""
import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
