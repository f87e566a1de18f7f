"""The port's native torch.fft namespace (webgpufft_tpu_torch.torch_fft)
against ``torch.fft`` on the CPU, case by case as tests/test_torch_fft.py
(which holds the JAX package's host-crossing bridge to the same oracle),
plus what only the native namespace offers: tensors stay on their device
and ``torch.autograd.grad`` / ``torch.func.grad`` flow through every
function and agree with torch.fft's gradients.

Tolerance 1e-5 of max|expected| for values, 3e-5 for gradients (a forward
and a backward pass of float32 rounding).
"""

import numpy as np
import pytest
import torch
import torch.fft as tref

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu import torch_fft as jtf
from webgpufft_tpu_torch import torch_fft as tf


def _close(got, want, tol=1e-5, label=""):
    assert isinstance(got, torch.Tensor), label
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    e = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-12)
    assert e <= tol, (label, e)


@pytest.fixture()
def tx():
    return torch.randn(3, 16, generator=torch.Generator().manual_seed(0))


@pytest.fixture()
def tz():
    return torch.randn(3, 16, generator=torch.Generator().manual_seed(1),
                       dtype=torch.complex64)


@pytest.mark.parametrize("norm", [None, "forward", "backward", "ortho"])
@pytest.mark.parametrize("n", [None, 12, 20])
def test_fft_1d_conventions(tz, tx, n, norm):
    _close(tf.fft(tz, n=n, norm=norm), tref.fft(tz, n=n, norm=norm), label="fft")
    _close(tf.ifft(tz, n=n, norm=norm), tref.ifft(tz, n=n, norm=norm), label="ifft")
    _close(tf.rfft(tx, n=n, norm=norm), tref.rfft(tx, n=n, norm=norm), label="rfft")
    _close(tf.ihfft(tx, n=n, norm=norm), tref.ihfft(tx, n=n, norm=norm),
           label="ihfft")
    # and the JAX package's bridge gives the same tensors
    _close(tf.fft(tz, n=n, norm=norm), jtf.fft(tz, n=n, norm=norm), label="jax")


def test_half_spectrum_roundtrips(tx, tz):
    _close(tf.irfft(tref.rfft(tx)), tref.irfft(tref.rfft(tx)), label="irfft")
    _close(tf.irfft(tref.rfft(tx), n=16), tx, label="irfft-n")
    _close(tf.hfft(tz), tref.hfft(tz), label="hfft")
    assert tf.rfft(tx).dtype == torch.complex64
    assert tf.irfft(tref.rfft(tx)).dtype == torch.float32


def test_nd_dims_and_s():
    g = torch.Generator().manual_seed(2)
    v = torch.randn(2, 8, 6, generator=g)
    zc = torch.randn(2, 8, 6, generator=g, dtype=torch.complex64)
    _close(tf.fft2(zc), tref.fft2(zc), label="fft2")
    _close(tf.ifft2(zc), tref.ifft2(zc), label="ifft2")
    _close(tf.fftn(zc, dim=(0, 2)), tref.fftn(zc, dim=(0, 2)), label="fftn-dim")
    _close(tf.rfft2(v, s=(4, 10)), tref.rfft2(v, s=(4, 10)), label="rfft2-s")
    _close(tf.rfftn(v), tref.rfftn(v), label="rfftn")
    _close(tf.irfftn(tref.rfftn(v)), tref.irfftn(tref.rfftn(v)), label="irfftn")
    _close(tf.irfft2(tref.rfft2(v)), tref.irfft2(tref.rfft2(v)), label="irfft2")
    _close(tf.hfftn(zc), tref.hfftn(zc), label="hfftn")
    _close(tf.hfft2(zc), tref.hfft2(zc), label="hfft2")
    _close(tf.ihfftn(v), tref.ihfftn(v), label="ihfftn")
    _close(tf.ihfft2(v), tref.ihfft2(v), label="ihfft2")
    _close(tf.ifftn(zc, norm="ortho"), tref.ifftn(zc, norm="ortho"),
           label="ifftn-ortho")


def test_real_input_with_trailing_two_is_real_data():
    """torch has no interleaved convention: a real (..., 2) tensor given to
    a complex transform is real data, as in torch.fft."""
    v = torch.randn(4, 2, generator=torch.Generator().manual_seed(5))
    _close(tf.fft(v), tref.fft(v), label="fft of real (4, 2)")
    _close(tf.fft2(v), tref.fft2(v), label="fft2 of real (4, 2)")


def test_wider_dtypes_are_cast_to_float32(tz, tx):
    got = tf.fft(tz.to(torch.complex128))
    assert got.dtype == torch.complex64
    _close(got, tref.fft(tz), label="complex128 in")
    got = tf.rfft(tx.double())
    assert got.dtype == torch.complex64
    _close(got, tref.rfft(tx), label="float64 in")


def test_duplicate_dims_and_bad_input_rejected():
    g = torch.Generator().manual_seed(3)
    zc = torch.randn(4, 6, generator=g, dtype=torch.complex64)
    v = torch.randn(4, 6, generator=g)
    for mod, err in ((jtf, W.PlanError), (tf, T.PlanError)):
        for fn, arr in ((mod.fftn, zc), (mod.rfftn, v), (mod.irfftn, zc)):
            for dims in ((1, 1), (1, -1)):
                with pytest.raises(err, match="unique"):
                    fn(arr, dim=dims)
    _close(tf.fftn(zc, dim=(0, -1)), tref.fftn(zc, dim=(0, -1)),
           label="fftn mixed-sign distinct")
    with pytest.raises(T.PlanError, match="real"):
        tf.rfft(zc)
    with pytest.raises(TypeError, match="Tensor"):
        tf.fft(np.zeros(8))


def test_helpers_match_torch():
    _close(tf.fftfreq(7, 0.5), tref.fftfreq(7, 0.5), label="fftfreq")
    _close(tf.rfftfreq(8, 2.0), tref.rfftfreq(8, 2.0), label="rfftfreq")
    f = tf.fftfreq(6, dtype=torch.float64, requires_grad=True)
    assert f.dtype == torch.float64 and f.requires_grad
    with pytest.raises(TypeError):
        tf.fftfreq(6, out=torch.zeros(6))
    with pytest.raises(TypeError):
        tf.rfftfreq(6, layout=torch.sparse_coo)
    v = torch.randn(4, 5, generator=torch.Generator().manual_seed(3))
    _close(tf.fftshift(v), tref.fftshift(v), label="fftshift")
    _close(tf.fftshift(v, dim=1), tref.fftshift(v, dim=1), label="fftshift-dim")
    _close(tf.ifftshift(v), tref.ifftshift(v), label="ifftshift")
    _close(tf.ifftshift(tf.fftshift(v)), v, label="shift-roundtrip")


def test_surface_is_complete():
    assert sorted(tf.__all__) == sorted(jtf.__all__)
    assert T.torch_fft is tf
    for n in tf.__all__:
        assert callable(getattr(tf, n)) and hasattr(tref, n), n


# ---------------------------------------------------------------- gradients

_CPLX_IN = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
            "irfft", "irfft2", "irfftn", "hfft", "hfft2", "hfftn"]
_REAL_IN = ["rfft", "rfft2", "rfftn", "ihfft", "ihfft2", "ihfftn"]


def _loss(y, w):
    """A scalar that weighs every output entry differently, so a wrong
    adjoint cannot hide behind Parseval."""
    if y.is_complex():
        y = torch.view_as_real(y.resolve_conj())    # torch.fft.ihfft* return lazy conj
    return (y * w).sum() + y.pow(2).sum()


@pytest.mark.parametrize("name", _CPLX_IN + _REAL_IN)
def test_autograd_grad_agrees_with_torch_fft(name):
    g = torch.Generator().manual_seed(7)
    dtype = torch.float32 if name in _REAL_IN else torch.complex64
    x = torch.randn(3, 8, 10, generator=g, dtype=dtype)
    y0 = getattr(tref, name)(x)
    shape = (*y0.shape, 2) if y0.is_complex() else y0.shape
    w = torch.randn(shape, generator=g)
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    ya, yb = getattr(tf, name)(xa), getattr(tref, name)(xb)
    _close(ya.detach(), yb.detach(), label=name)
    ga, = torch.autograd.grad(_loss(ya, w), xa)
    gb, = torch.autograd.grad(_loss(yb, w), xb)
    _close(ga, gb, tol=3e-5, label=f"grad {name}")


@pytest.mark.parametrize("name", _CPLX_IN + _REAL_IN)
def test_func_grad_agrees_with_torch_fft(name):
    """torch.func.grad takes real inputs: differentiate with respect to the
    real tensor (or the real view of the complex one)."""
    g = torch.Generator().manual_seed(11)
    real_in = name in _REAL_IN
    x = torch.randn(*((2, 6, 8) if real_in else (2, 6, 8, 2)), generator=g)

    def run(mod, v):
        y = getattr(mod, name)(v if real_in else torch.view_as_complex(v))
        y = torch.view_as_real(y.resolve_conj()) if y.is_complex() else y
        return y.pow(2).sum() + y.sum()

    ga = torch.func.grad(lambda v: run(tf, v))(x)
    gb = torch.func.grad(lambda v: run(tref, v))(x)
    _close(ga, gb, tol=3e-5, label=f"func.grad {name}")


def test_shift_gradients_flow():
    x = torch.randn(4, 5, requires_grad=True)
    w = torch.randn(4, 5)
    for fn, ref in ((tf.fftshift, tref.fftshift), (tf.ifftshift, tref.ifftshift)):
        ga, = torch.autograd.grad((fn(x) * w).sum(), x)
        gb, = torch.autograd.grad((ref(x) * w).sum(), x)
        assert torch.equal(ga, gb)


def test_complex64_input_is_a_view_not_a_copy(tz):
    """``asinterleaved`` keeps a complex64 tensor a view (view_as_real), so
    no host crossing and no detached copy sits between input and plan."""
    from webgpufft_tpu_torch import fftapi as TF
    v = TF.asinterleaved(tz)
    assert v.data_ptr() == tz.data_ptr() and v.shape == (3, 16, 2)
    z = tz.clone().requires_grad_(True)
    assert TF.asinterleaved(z).requires_grad
    c128 = TF.asinterleaved(tz.to(torch.complex128))
    assert c128.dtype == torch.float32
