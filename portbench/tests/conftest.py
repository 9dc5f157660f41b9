"""Shared fixtures of the benchmark's own tests. Whether a card is there is
decided inside the `card` fixture, never while a module is imported."""
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
