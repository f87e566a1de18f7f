"""The port's Fourier-domain filters (webgpufft_tpu_torch/ndimage.py)
through the JAX package's own cases: tests/test_ndimage.py's functions run
here with its module stood in by ``BothModules`` (numpy inputs on the CPU
device), so every call runs the port's copy and the JAX package's on the
same arguments and holds them within 1e-6 of max|JAX result| (the same
float64 tables, cast once and multiplied in the same order), and each case
then holds the port's result against scipy.ndimage at that test's own
tolerance.  The end-to-end case runs the port's own fft and ifft."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import test_ndimage as J
import webgpufft_tpu_torch as T
from webgpufft_tpu import ndimage as JN
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import ndimage as N
from test_ndimage import (test_fourier_ellipsoid_ranks, test_fourier_gaussian,  # noqa: F401
                          test_fourier_shift, test_fourier_uniform, test_interleaved_roundtrip,
                          test_param_validation, test_real_input_stays_real,
                          test_rfft_domain_n, zc)
from torch_port_support import BothModules, assert_close, assert_close_c


@pytest.fixture(autouse=True)
def _through_the_port(monkeypatch):
    monkeypatch.setattr(J, "N", BothModules(N, JN, 1e-6))
    with TF.default_device("cpu"):
        yield


def test_shift_then_ifft_shifts_signal(rng):
    """End-to-end on the port: fft -> fourier_shift -> ifft performs a
    circular shift."""
    x = rng.standard_normal(32)
    y = T.fft.ifft(N.fourier_shift(T.fft.fft(x), 5))
    assert_close(y[..., 0].numpy(), np.roll(x, 5), 3e-5, "roll")


def test_names():
    assert N.__all__ == JN.__all__


@pytest.mark.parametrize("name,arg", [("fourier_gaussian", (0.0, 1.5, 2.0)),
                                      ("fourier_uniform", (1.0, 3.0, 2.5)),
                                      ("fourier_ellipsoid", (2.0, 3.0, 4.0)),
                                      ("fourier_shift", (1.0, -2.5, 0.5))])
def test_spectrum_of_fft2_on_its_device(rng, name, arg):
    """A batch of images through the port's fft2, the filter and ifft2,
    the spectrum staying a tensor: against scipy.ndimage on the same
    complex spectrum (every axis filtered, the batch axis too, as scipy)."""
    im = rng.standard_normal((3, 16, 20))
    X = T.fft.fft2(torch.from_numpy(im))
    got = TF.ascomplex(getattr(N, name)(X, arg))
    want = getattr(ndi, name)(TF.ascomplex(X), arg)
    assert_close_c(got, want, 3e-5, name)
    assert getattr(N, name)(X, arg).device == X.device
