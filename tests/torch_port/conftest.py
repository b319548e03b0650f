"""Settings for the PyTorch port's parity tests.

Registers the ``cuda`` marker: a test that needs an NVIDIA GPU carries
it and skips, from inside the test, where ``torch.cuda.is_available()``
is false. Whether a card is present is never decided at import or
collection time, so every worker of a parallel run collects the same
tests.

Each test here runs with one torch thread (set before its fixtures, put
back after its teardown): the tiny models gain nothing from intra-op
threads, which spin on every small op and take cores from the other
workers of a parallel run.
"""

import pytest

_THREADS = []


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    import torch

    _THREADS.append(torch.get_num_threads())
    torch.set_num_threads(1)


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    import torch

    if _THREADS:
        torch.set_num_threads(_THREADS.pop())
