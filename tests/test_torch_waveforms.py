"""The port's waveform generators (webgpufft_tpu_torch/waveforms.py) against
the JAX package's and scipy.signal, case by case as tests/test_waveforms.py:
the same numpy time vectors through both packages (the port on the CPU
device, ``facade_both``: 1e-5 of max|expected| between the two), then the
port against scipy at that test's own tolerance.  Where the JAX test traces
the time vector under ``jax.jit``, the port's case gives a tensor that
requires grad: the torch path on the tensor's device, with its gradient."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import waveforms as TW
from torch_port_support import facade_both, facade_raises, to_numpy


def _close(a, b, tol=1e-5, label=""):
    a = to_numpy(a)
    b = np.asarray(b)
    if np.iscomplexobj(b) and not np.iscomplexobj(a):
        a = a[..., 0] + 1j * a[..., 1]
    assert a.shape == b.shape, (label, a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)
    assert err < tol, (label, err)


def _both(name, *args, **kw):
    return facade_both(name, *args, module="waveforms", **kw)


def _tracked(t):
    return torch.tensor(t, dtype=torch.float32, requires_grad=True)


class TestChirp:
    @pytest.mark.parametrize("method", [
        "linear", "quadratic", "logarithmic", "hyperbolic"])
    def test_methods(self, method):
        t = np.linspace(0, 10, 3001)
        _close(_both("chirp", t, 1.5, 10, 25, method=method, phi=30),
               ss.chirp(t, 1.5, 10, 25, method=method, phi=30), label=method)

    def test_vertex_zero_false(self):
        t = np.linspace(0, 10, 2001)
        _close(_both("chirp", t, 1.5, 10, 25, method="quadratic", vertex_zero=False),
               ss.chirp(t, 1.5, 10, 25, method="quadratic", vertex_zero=False))

    def test_complex_analytic(self):
        t = np.linspace(0, 10, 2001)
        got = _both("chirp", t, 1.5, 10, 25, complex=True)
        assert got.shape == (2001, 2)
        _close(got, ss.chirp(t, 1.5, 10, 25, complex=True))

    def test_descending_and_negative_sweeps(self):
        t = np.linspace(0, 4, 801)
        _close(_both("chirp", t, 25, 4, 1.5, method="logarithmic"),
               ss.chirp(t, 25, 4, 1.5, method="logarithmic"))
        _close(_both("chirp", t, -2, 4, -10, method="hyperbolic"),
               ss.chirp(t, -2, 4, -10, method="hyperbolic"))

    def test_equal_endpoints(self):
        t = np.linspace(0, 4, 801)
        for method in ("logarithmic", "hyperbolic"):
            _close(_both("chirp", t, 5, 4, 5, method=method),
                   ss.chirp(t, 5, 4, 5, method=method), label=method)

    @pytest.mark.parametrize("method", ["linear", "logarithmic", "hyperbolic"])
    def test_traced_path(self, method):
        t = np.linspace(0, 1, 257)
        tt = _tracked(t)
        y = TW.chirp(tt, 2.0, 1.0, 8.0, method=method)
        assert y.requires_grad and y.dtype == torch.float32
        _close(y.detach(), ss.chirp(t, 2.0, 1.0, 8.0, method=method), tol=2e-4, label="traced")
        g, = torch.autograd.grad(y.sum(), tt)
        # d cos(phase)/dt = -sin(phase) * 2 pi f(t), f the instantaneous frequency
        want = torch.autograd.functional.jacobian(
            lambda v: TW.chirp(v, 2.0, 1.0, 8.0, method=method).sum(), tt.detach().double())
        assert torch.isfinite(g).all()
        _close(g, want.numpy(), tol=1e-3, label="gradient")

    def test_validation(self):
        t = np.linspace(0, 1, 65)
        facade_raises("chirp", None, t, -1, 1, 2, method="logarithmic", module="waveforms")
        facade_raises("chirp", None, t, 0, 1, 2, method="hyperbolic", module="waveforms")
        facade_raises("chirp", None, t, 1, 1, 2, method="cubic", module="waveforms")


class TestSweepPoly:
    def test_poly1d_and_coeffs(self):
        t = np.linspace(0, 10, 2001)
        p = np.poly1d([0.05, -0.75, 2.5, 1.0])
        _close(_both("sweep_poly", t, p, phi=20), ss.sweep_poly(t, p, phi=20))
        _close(_both("sweep_poly", t, [0.1, 1.0]), ss.sweep_poly(t, [0.1, 1.0]))

    def test_traced(self):
        t = np.linspace(0, 1, 129)
        tt = _tracked(t)
        y = TW.sweep_poly(tt, [0.5, 2.0])
        _close(y.detach(), ss.sweep_poly(t, [0.5, 2.0]), tol=2e-4)
        g, = torch.autograd.grad(y.sum(), tt)
        # d/dt cos(2 pi P(t)) = -2 pi sin(2 pi P(t)) p(t), P = integral of p
        intp = np.poly1d([0.5, 2.0]).integ()
        want = -2 * np.pi * np.sin(2 * np.pi * intp(t)) * np.polyval([0.5, 2.0], t)
        _close(g, want, tol=2e-4, label="gradient")


class TestGausspulse:
    def test_default(self):
        t = np.linspace(-0.01, 0.01, 2001)
        _close(_both("gausspulse", t, fc=1000), ss.gausspulse(t, fc=1000))

    def test_quad_env(self):
        t = np.linspace(-0.01, 0.01, 2001)
        got = _both("gausspulse", t, fc=1000, retquad=True, retenv=True)
        exp = ss.gausspulse(t, fc=1000, retquad=True, retenv=True)
        for g, e, nm in zip(got, exp, ("i", "q", "env")):
            _close(g, e, label=nm)

    def test_bw_bwr(self):
        t = np.linspace(-0.01, 0.01, 1001)
        _close(_both("gausspulse", t, fc=1000, bw=0.8, bwr=-3),
               ss.gausspulse(t, fc=1000, bw=0.8, bwr=-3))

    def test_cutoff(self):
        got = TW.gausspulse("cutoff", fc=500, tpr=-40)
        assert isinstance(got, float)
        assert np.isclose(got, ss.gausspulse("cutoff", fc=500, tpr=-40))

    def test_validation(self):
        for args, kw in [((np.zeros(4),), {"fc": -1}), ((np.zeros(4),), {"bw": 0}),
                         ((np.zeros(4),), {"bwr": 1}), (("middle",), {}),
                         (("cutoff",), {"tpr": 3})]:
            facade_raises("gausspulse", None, *args, module="waveforms", **kw)


class TestPeriodicWaves:
    @pytest.mark.parametrize("width", [1.0, 0.0, 0.5, 0.3])
    def test_sawtooth(self, width):
        t = np.linspace(0, 20, 4001)
        _close(_both("sawtooth", t, width), ss.sawtooth(t, width), label=f"width={width}")

    @pytest.mark.parametrize("duty", [0.5, 0.2, 1.0, 0.0])
    def test_square(self, duty):
        t = np.linspace(0, 20, 4001)
        _close(_both("square", t, duty), ss.square(t, duty), label=f"duty={duty}")

    def test_invalid_params_nan(self):
        t = np.linspace(0, 5, 33)
        with TF.default_device("cpu"):
            assert torch.isnan(TW.sawtooth(t, 1.5)).all()
            assert torch.isnan(TW.square(t, -0.1)).all()
        assert torch.isnan(TW.sawtooth(_tracked(t), 1.5)).all()
        assert torch.isnan(TW.square(_tracked(t), -0.1)).all()

    def test_traced(self):
        t = np.linspace(0, 20, 801)
        _close(TW.square(_tracked(t), 0.3), ss.square(t, 0.3), tol=1e-6)
        tt = _tracked(t)
        y = TW.sawtooth(tt, 0.5)
        _close(y.detach(), ss.sawtooth(t, 0.5), tol=1e-5)
        g, = torch.autograd.grad(y.sum(), tt)
        assert torch.isfinite(g).all() and set(np.round(g.numpy() * np.pi, 4)) <= {2.0, -2.0}


class TestUnitImpulse:
    def test_shapes_and_idx(self):
        for args in [(7,), ((5, 5), "mid"), (9, 4), ((4, 6), (1, 2)), ((3, 3), 1)]:
            got = _both("unit_impulse", *args)
            assert np.array_equal(got, ss.unit_impulse(*args))

    def test_dtype(self):
        with TF.default_device("cpu"):
            assert TW.unit_impulse(5).dtype == torch.float32
            got = TW.unit_impulse(5, dtype=int)
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), ss.unit_impulse(5, dtype=int))


def test_max_len_seq_matches_scipy():
    for nbits in (3, 8, 11):
        seq, state = TW.max_len_seq(nbits)
        want_seq, want_state = ss.max_len_seq(nbits)
        assert np.array_equal(seq, want_seq) and np.array_equal(state, want_state)
    facade_raises("max_len_seq", "nbits", 40, module="waveforms")


def test_tensor_time_vectors_keep_their_device():
    """A time tensor nothing tracks takes the host-f64 path and comes back
    on its own device (here the CPU, outside any default_device block);
    numpy goes to the facade default, which raises without a card."""
    t = np.linspace(0, 10, 501)
    got = TW.chirp(torch.from_numpy(t), 1.5, 10, 25)
    assert got.device.type == "cpu" and got.dtype == torch.float32 and not got.requires_grad
    _close(got, ss.chirp(t, 1.5, 10, 25))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TW.chirp(t, 1.5, 10, 25)
    assert T.waveforms is TW
