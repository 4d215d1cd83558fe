"""The benchmark's own tests: CPU tests at tiny sizes; tests marked ``chip``
need a CUDA card and skip without one (decided inside the test)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
