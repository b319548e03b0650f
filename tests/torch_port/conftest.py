"""Settings for the PyTorch port's parity tests.

Registers the ``cuda`` marker: a test that needs an NVIDIA GPU carries
it and skips, from inside the test, where ``torch.cuda.is_available()``
is false. Whether a card is present is never decided at import or
collection time, so every worker of a parallel run collects the same
tests.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")
