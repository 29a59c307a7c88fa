"""The benchmark's own tests. Tests that need the card carry the ``card``
marker and skip without one; the look for a card is made in the ``card``
fixture, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs on the chip machine)")


@pytest.fixture
def card():
    from port_bench.run import environment

    environment()         # cuBLAS's deterministic workspace before CUDA
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
