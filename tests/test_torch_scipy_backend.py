"""The port's scipy.fft uarray backend (webgpufft_tpu_torch.scipy_backend)
against the JAX package's, case by case as tests/test_scipy_backend.py.

Both backends get the same seeded numpy input through ``scipy.fft``'s own
dispatch, the port's built for the CPU device; outputs are numpy in
scipy's promised dtypes (complex64 / float32) and agree at 1e-5 of
max|expected| (1e-4 for the two Hankel transforms, whose float32 kernel
coefficients span orders of magnitude).
"""

import numpy as np
import pytest
import scipy.fft as sf
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from torch_port_support import assert_close_c


@pytest.fixture(scope="module")
def backends():
    return W.scipy_fft_backend(), T.scipy_fft_backend(device="cpu")


def _dispatched(y):
    return y.dtype in (np.complex64, np.float32)


def _both(backends, name, *args, tol=1e-5, **kw):
    jb, tb = backends
    with sf.set_backend(jb):
        want = getattr(sf, name)(*args, **kw)
    with sf.set_backend(tb):
        got = getattr(sf, name)(*args, **kw)
    assert isinstance(got, np.ndarray) and _dispatched(got), name
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert_close_c(got, want, tol, name)
    return got


_COMPLEX_IN = {"ifft", "ifft2", "ifftn", "irfft", "irfft2", "irfftn",
               "hfft", "hfft2", "hfftn"}
_ND = {"fft2", "ifft2", "fftn", "ifftn", "rfft2", "irfft2", "rfftn",
       "irfftn", "hfft2", "ihfft2", "hfftn", "ihfftn",
       "dctn", "idctn", "dstn", "idstn"}
_ALL_MULTIMETHODS = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "fht", "ifht",
]


@pytest.mark.parametrize("name", _ALL_MULTIMETHODS)
def test_every_multimethod_dispatches_and_matches(backends, name, rng):
    if name in ("fht", "ifht"):
        _both(backends, name, rng.standard_normal(32), 0.05, 1.0, tol=1e-4)
        return
    shape = (4, 8, 6) if name in _ND else (3, 16)
    x = rng.standard_normal(shape)
    if name in _COMPLEX_IN:
        x = x + 1j * rng.standard_normal(shape)
    _both(backends, name, x)


def test_scipy_positional_calling_convention(backends, rng):
    z = rng.standard_normal(24) + 1j * rng.standard_normal(24)
    got = _both(backends, "fft", z, 16, -1, "ortho", True, 4)
    assert got.dtype == np.complex64


def test_trig_kwargs_roundtrip(backends, rng):
    x = rng.standard_normal(15)
    for norm in (None, "forward", "ortho"):
        for o in (True, False, None):
            _both(backends, "idct", x, type=3, norm=norm, orthogonalize=o)


def test_foreign_plan_and_planerror_fall_back(backends, rng):
    z = rng.standard_normal(8) + 0j
    for b in backends:
        assert b.__ua_function__(sf.fft, (z,), {"plan": object()}) is NotImplemented
        assert b.__ua_function__(sf.dct, (np.zeros(4), 7), {}) is NotImplemented
        with sf.set_backend(b):
            with pytest.raises(NotImplementedError):
                sf.fft(z, plan=object())


def test_duplicate_axes_keep_scipy_semantics(backends, rng):
    x = rng.standard_normal((4, 6))
    for b in backends:
        with sf.set_backend(b):
            with pytest.raises(ValueError):
                sf.fftn(x, axes=(1, 1))
            with pytest.raises(ValueError):
                sf.fftn(x, axes=(1, -1))
    _both(backends, "fftn", x, axes=(0, -1))


def test_coerce_and_only_modes(backends, rng):
    x = rng.standard_normal(20)
    _, tb = backends
    with sf.set_backend(tb, coerce=True):
        y = sf.irfft(sf.rfft(x))
    assert np.allclose(y, x, atol=1e-4)
    with sf.set_backend(tb, only=True):
        y2 = sf.dstn(rng.standard_normal((4, 6)))
    assert _dispatched(y2)


def test_native_flavor_returns_tensors_on_the_device(rng):
    b = T.scipy_fft_backend(as_numpy=False, device="cpu")
    z = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    with sf.set_backend(b):
        y = sf.fft(z)
    assert isinstance(y, torch.Tensor) and y.shape == (16, 2)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    with sf.set_backend(W.scipy_fft_backend(as_numpy=False)):
        want = np.asarray(sf.fft(z))
    assert_close_c(y.numpy(), want, 1e-5)
    # one cached instance per (flavor, device)
    assert T.scipy_fft_backend(device="cpu") is T.scipy_fft_backend(True, "cpu")
    assert T.scipy_fft_backend(False, "cpu") is b
    assert T.scipy_fft_backend() is not T.scipy_fft_backend(device="cpu")


def test_default_backend_needs_a_gpu_or_a_device_block(rng):
    """Built with no device, the backend runs on the facade's default
    device: without a GPU that raises through scipy's dispatch instead of
    quietly running on the CPU; inside a default_device block it runs."""
    from webgpufft_tpu_torch import fftapi as TF
    z = rng.standard_normal(12) + 0j
    b = T.scipy_fft_backend()
    if not torch.cuda.is_available():
        with sf.set_backend(b), pytest.raises(RuntimeError, match="cuda"):
            sf.fft(z)
    with TF.default_device("cpu"), sf.set_backend(b):
        y = sf.fft(z)
    assert y.dtype == np.complex64


def test_backend_accelerates_scipy_signal(backends, rng):
    import scipy.signal as ss
    x = rng.standard_normal(2048)
    k = np.ones(32) / 32
    jb, tb = backends
    with sf.set_backend(jb):
        _, want_p = ss.welch(x, nperseg=256)
        want_c = ss.fftconvolve(x, k)
    with sf.set_backend(tb):
        _, p = ss.welch(x, nperseg=256)
        c = ss.fftconvolve(x, k)
    assert c.dtype == np.float32          # proof the backend did the FFTs
    assert_close_c(p, want_p, 1e-5, "welch")
    assert_close_c(c, want_c, 1e-5, "fftconvolve")


def test_global_install_uninstall(rng):
    z = rng.standard_normal(12) + 1j * rng.standard_normal(12)
    try:
        b = T.install_scipy_fft_backend(device="cpu")
        assert isinstance(b, T.ScipyFftBackend)
        assert sf.fft(z).dtype == np.complex64
    finally:
        T.uninstall_scipy_fft_backend()
    assert sf.fft(z).dtype == np.complex128
