"""pytest settings of the benchmark's own tests (``python -m pytest h100bench/tests``).

``h100bench_card``: a test that needs an NVIDIA card; the ``card`` fixture
decides at run time, never at import, and skips without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "h100bench_card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda:0")
