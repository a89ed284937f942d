"""Marker of the tests that need a CUDA card; they skip inside a fixture
where there is none."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (run on the GPU machine)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
