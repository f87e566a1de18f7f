"""Support for the PyTorch port's GPU-only tests (imports torch only).

Tests that need an NVIDIA GPU carry ``@pytest.mark.cuda`` (registered in
pyproject.toml) and take the ``cuda_device`` fixture, which decides at run
time, never at import, whether a card exists and skips otherwise: a CUDA
kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def assert_close(actual, expected, atol_scale=1e-5, label=""):
    """|a - e| <= atol_scale * max|e| elementwise, as tests/conftest.py's
    _assert_close (which cannot be imported where JAX is absent)."""
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    assert actual.shape == expected.shape, (
        f"{label}: shape {actual.shape} != {expected.shape}")
    scale = max(np.max(np.abs(expected)), 1e-12)
    err = np.max(np.abs(actual - expected)) / scale
    assert err <= atol_scale, f"{label}: max rel err {err:.3e} > {atol_scale:.0e}"
