"""The benchmark's own tests (run them with `python -m pytest perfbench/tests`).
Tests marked `card` need a CUDA card and skip without one; whether there is
one is decided inside the `card` fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell on the card")
    return "cuda"
