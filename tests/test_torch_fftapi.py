"""The port's functional facade (webgpufft_tpu_torch.fftapi) against the JAX
package's (webgpufft_tpu.fftapi): tests/test_fftapi.py and the facade-only
cases of tests/test_signal_utils.py, case by case.

Every case feeds the same seeded numpy inputs to both packages (the port on
the CPU device, where its kernel wrappers run their plain versions) and
holds the port's outputs against the JAX package's at 1e-5 of
max|expected| (``torch_port_support.facade_both``); a case with a wider
tolerance says why.  ``PlanError`` cases must raise in both.  The JAX
package's own tests pin its facade to numpy/scipy.
"""

import warnings

import numpy as np
import pytest

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu import fftapi as JF
from webgpufft_tpu_torch import fftapi as TF
from torch_port_support import (assert_close_c, facade_both as both,
                                facade_raises as raises, to_numpy)

# float32 pipelines of several transforms and long sums (resampling filters,
# overlap-add normalisation, Bluestein chirps): the two packages' float32
# roundings differ by a few 1e-6 per stage and the stages add up
TOL_CHAIN = 5e-5


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture()
def zc(rng):
    return _cplx(rng, 3, 32)


def test_public_surface():
    """Every public name of the JAX facade exists in the port, the module is
    exported as both ``fft`` and ``fftapi``, and the host helpers return
    numpy while transforms return float32 tensors."""
    import torch
    missing = [n for n in JF.__all__ if not hasattr(TF, n)]
    assert not missing, missing
    assert set(JF.__all__) <= set(TF.__all__)
    assert hasattr(TF, "plan_tuning") and hasattr(TF, "default_device")
    assert TF.COMPLEX_VALUED_FFTS == JF.COMPLEX_VALUED_FFTS
    assert T.fft is TF and T.fftapi is TF
    for n in ("fft", "fftapi", "windows", "ShortTimeFFT", "ScipyFftBackend",
              "scipy_fft_backend", "install_scipy_fft_backend",
              "uninstall_scipy_fft_backend", "torch_fft", "fftpack", "pyfftw"):
        assert n in T.__all__ and hasattr(T, n), n
    with TF.default_device("cpu"):
        y = TF.fft(np.ones((2, 8)))
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    assert isinstance(TF.fftfreq(8), np.ndarray)
    assert isinstance(TF.ascomplex(y), np.ndarray)
    assert TF.ascomplex(y).dtype == np.complex128


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_fft_ifft_norms(zc, norm):
    both("fft", zc, norm=norm)
    both("ifft", zc, norm=norm)


@pytest.mark.parametrize("name,shape", [("fft", (4, 3000)), ("ifft", (2, 6144))])
def test_fft_at_lengths_of_the_mixed_radix_design(rng, name, shape):
    """Small CPU cases of two facade calls whose K1 launch runs the
    mixed-radix design on the card (``radix.MIXED_LINES``): traces of 3000
    samples forward and frames of 6144 samples inverse, complex64 in."""
    from webgpufft_tpu_torch.core import radix
    assert radix.lines_design(shape[1]) == "mixed"
    both(name, _cplx(rng, *shape).astype(np.complex64))


def test_fft_crop_pad_axis(zc):
    both("fft", zc, n=20)
    both("fft", zc, n=48)
    both("fft", zc, axis=0)


def test_fft_interleaved_input(zc):
    xi = np.stack([zc.real, zc.imag], -1).astype(np.float32)
    both("fft", xi)
    both("fft", np.asarray(zc.real, np.float32))
    both("fft", np.asarray(zc.real[:, :2], np.float32), interleaved=False)


def test_fftn_axes(rng):
    z = _cplx(rng, 2, 8, 12, 10)
    both("fft2", z)
    both("fftn", z)
    both("ifftn", z)
    both("fftn", z, axes=(1, 3))
    both("fftn", z, axes=(3, 1))
    both("ifft2", z, s=(16, 8))
    raises("fftn", "entries", z, s=(4,), axes=(1, 2))


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_rfft_irfft(rng, norm):
    x = rng.standard_normal((3, 32))
    both("rfft", x, norm=norm)
    both("irfft", np.fft.rfft(x, axis=-1), norm=norm)


def test_rfft_axis_and_odd(rng):
    x = rng.standard_normal((3, 32))
    both("rfft", x, axis=0)
    both("irfft", np.fft.rfft(x, axis=-1), n=31)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hfft_ihfft(rng, norm):
    a = _cplx(rng, 3, 17)
    both("hfft", a, norm=norm)
    both("hfft", a, n=31, norm=norm)
    x = rng.standard_normal((3, 32))
    both("ihfft", x, norm=norm)
    both("ihfft", x, n=20, norm=norm)


def test_rfftn_irfftn(rng):
    x = rng.standard_normal((2, 12, 16))
    both("rfft2", x)
    both("rfftn", x)
    pk = np.fft.rfft2(x)
    both("irfft2", pk)
    both("irfftn", pk, s=(12, 16), axes=(-2, -1))


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("type", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", [None, "ortho"])
@pytest.mark.parametrize("m", [15, 16])
def test_trig(rng, kind, type, norm, m):
    x = rng.standard_normal((3, m)).astype(np.float32)
    both(kind, x, type=type, norm=norm)
    both("i" + kind, x, type=type, norm=norm)


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("type", [1, 2, 3, 4])
def test_trig_norm_orthogonalize_grid(rng, kind, type):
    for m in (7, 12):
        x = rng.standard_normal((2, m)).astype(np.float32)
        for norm in (None, "backward", "forward", "ortho"):
            for o in (None, True, False):
                for pfx in ("", "i"):
                    both(pfx + kind, x, type=type, norm=norm, orthogonalize=o)


def test_trig_nd_norm_orthogonalize(rng):
    x = rng.standard_normal((3, 6, 7)).astype(np.float32)
    for norm in (None, "forward", "ortho"):
        for o in (True, False):
            both("dctn", x, norm=norm, orthogonalize=o)
            both("idstn", x, type=3, norm=norm, orthogonalize=o)


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_trig_nd(rng, kind, norm):
    x = rng.standard_normal((2, 10, 12)).astype(np.float32)
    both(kind + "n", x, norm=norm)
    both("i" + kind + "n", x, norm=norm)
    both(kind + "n", x, type=3, axes=(1, 2), norm=norm)
    both(kind + "n", x, s=(8, 16))


def test_fftn_numpy_edge_conventions(rng):
    z = _cplx(rng, 4, 6, 8)
    both("fftn", z, axes=(1, 1))
    both("fftn", z, axes=(2, 2, 1), norm="ortho")
    both("fftn", z, s=(4, 6), axes=(1, 1))
    both("ifftn", z, axes=(0, 0))
    both("fftn", z, s=(-1, 4), axes=(0, 2))
    both("rfftn", z.real, s=(-1, 4), axes=(-2, -1))
    zp = np.fft.rfftn(z.real)
    both("irfftn", zp, s=(-1, -1), axes=(1, 2))
    both("irfftn", zp, s=(6, -1), axes=(1, 2))
    raises("fft", "data points", z[0, 0], n=-1)
    raises("fft", "data points", z[0, 0], n=0)


def test_fftn_numpy_edge_conventions_more(rng):
    x = rng.standard_normal((4, 6, 8))
    z = x + 1j * rng.standard_normal((4, 6, 8))
    for fn, arr in (("fftn", z), ("rfftn", x)):
        raises(fn, "entries", arr, s=(4, 5, 6), axes=(0, 1))
        raises(fn, "bare int", arr, s=4)
    raises("irfftn", "entries", z, s=(4, 5, 6), axes=(1, 2))
    both("fftn", z, s=(4, -1), axes=(1, 1))
    both("rfftn", x, axes=(1, 1))
    both("rfftn", x, s=(3, 5), axes=(1, 1))
    both("rfftn", x, s=(-1, 5), axes=(1, 1))
    both("rfftn", x, axes=(1, 1, 2), norm="ortho")
    both("rfftn", x, axes=(1, -2))
    both("irfftn", z, axes=(1, 1))
    both("irfftn", z, s=(3, 10), axes=(1, 1))
    both("irfftn", z, s=(3, -1), axes=(1, 1))
    both("irfftn", z, axes=(0, 0, 1))
    both("fft", z[0], n=np.int64(12))
    both("fftn", z, s=(np.int64(4), np.int64(5)))
    for fn, arr in (("fftn", z[:, :, 0]), ("rfftn", x[:, :, 0]),
                    ("irfftn", z[:, :, 0])):
        raises(fn, "rank", arr, s=(2, 3, 4))


def test_trig_axis_and_n(rng):
    x = rng.standard_normal((5, 12))
    both("dct", x, axis=0)
    both("dct", x, n=8)
    both("dst", x, n=20)
    both("dct", x, norm="forward")
    raises("dct", "type", x, type=5)
    raises("dct", "norm", x, norm="bogus")


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_real(rng, mode):
    both("fftconvolve", rng.standard_normal((3, 20)),
         rng.standard_normal((1, 5)), mode=mode, axes=(1,))
    both("fftconvolve", rng.standard_normal((6, 9)),
         rng.standard_normal((3, 4)), mode)


def test_fftn_s_without_axes(rng):
    both("fftn", _cplx(rng, 2, 8, 12, 10), s=(16, 16))
    x = rng.standard_normal((2, 12, 16))
    both("rfftn", x, s=(8, 8))
    both("irfftn", np.fft.rfft2(x), s=(12, 16))


def test_fftconvolve_valid_swap_batched(rng):
    both("fftconvolve", rng.standard_normal((3, 5)),
         rng.standard_normal((1, 12)), "valid", axes=(1,))
    raises("fftconvolve", "size-1", np.zeros((3, 5)), np.zeros((2, 12)),
           "valid", axes=(1,))


def test_fftconvolve_in1_singleton_broadcast(rng):
    a = rng.standard_normal((1, 20))
    b = rng.standard_normal((5, 4))
    for mode in ("full", "same", "valid"):
        both("fftconvolve", a, b, mode, axes=(1,))
        both("fftconvolve", b, a, mode, axes=(1,))


def test_fftconvolve_complex_and_swap(rng):
    both("fftconvolve", _cplx(rng, 16), _cplx(rng, 4), "full")
    a2 = rng.standard_normal((6, 9))
    b2 = rng.standard_normal((3, 4))
    both("fftconvolve", b2, a2, "valid")
    raises("fftconvolve", "rank", a2, np.zeros(3))
    raises("fftconvolve", "size-1", np.zeros((3, 8)), np.zeros((2, 3)),
           axes=(1,))


def test_utilities():
    assert np.array_equal(TF.fftfreq(8, 0.5), JF.fftfreq(8, 0.5))
    assert np.array_equal(TF.rfftfreq(8, 0.5), JF.rfftfreq(8, 0.5))
    x = np.arange(8.0)
    both("fftshift", x, interleaved=False, tol=0)
    both("ifftshift", x, interleaved=False, tol=0)
    zi = np.stack([x, -x], -1).astype(np.float32)
    got = both("fftshift", zi, tol=0)
    assert np.array_equal(got[..., 0], np.fft.fftshift(x))
    both("fftshift", np.array([1.0, 2.0]), tol=0)
    for n in (1, 17, 100, 4097):
        assert TF.next_fast_len(n) == JF.next_fast_len(n)


def test_oaconvolve_alias(rng):
    both("oaconvolve", rng.standard_normal((2, 30)),
         rng.standard_normal((1, 7)), "same", axes=(1,))


@pytest.mark.parametrize("cfg", [(256, None, None), (128, 96, None),
                                 (256, 128, 512), (200, 100, None),
                                 (256, 96, None), (48, 30, None),
                                 (48, 30, 64), (12, 7, None)])
def test_stft_istft(rng, cfg):
    """Framing differs by design (the port frames with ``unfold``, the JAX
    package with gcd-block slices or a gather): same outputs."""
    nperseg, nov, nfft = cfg
    x = rng.standard_normal(2000).astype(np.float32)
    f, t, Z = both("stft", x, fs=8000.0, nperseg=nperseg, noverlap=nov,
                   nfft=nfft)
    t2, y = both("istft", Z, fs=8000.0, nperseg=nperseg, noverlap=nov,
                 nfft=nfft, tol=TOL_CHAIN)
    assert np.max(np.abs(y[:len(x)] - x)) < 1e-4, "istft roundtrip"


def test_stft_batched_and_custom_window(rng):
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    win = np.hamming(128).astype(np.float32)
    _, _, Z = both("stft", x, window=win, nperseg=128)
    _, y = both("istft", Z, window=win, nperseg=128, tol=TOL_CHAIN)
    assert np.max(np.abs(y[:, :1024] - x)) < 1e-4


def test_stft_validation():
    z = np.zeros(512, np.float32)
    raises("stft", "noverlap", z, nperseg=100, noverlap=100)
    raises("stft", "nfft", z, nperseg=256, nfft=128)
    raises("stft", "boundary", z, boundary="reflect")


def test_stft_unaligned_and_odd(rng):
    x = rng.standard_normal(1000).astype(np.float32)
    both("stft", x, nperseg=256, noverlap=128, boundary=None, padded=False)
    both("stft", rng.standard_normal(400).astype(np.float32), nperseg=256,
         noverlap=0)
    both("stft", rng.standard_normal(100).astype(np.float32), nperseg=9,
         noverlap=6)
    _, _, Z = both("stft", x, nperseg=128, noverlap=0)
    raises("istft", "NOLA", Z, nperseg=128, noverlap=0)


@pytest.mark.parametrize("cfg", [dict(nperseg=256),
                                 dict(nperseg=256, noverlap=192),
                                 dict(nperseg=128, nfft=256),
                                 dict(nperseg=200, noverlap=100),
                                 dict(nperseg=256, scaling="spectrum")])
def test_welch(rng, cfg):
    both("welch", rng.standard_normal(4096).astype(np.float32), fs=1000.0,
         **cfg)


def test_welch_batched_and_periodogram(rng):
    xb = rng.standard_normal((3, 2048)).astype(np.float32)
    both("welch", xb, nperseg=256)
    x = rng.standard_normal(4096).astype(np.float32)
    for cfg in (dict(), dict(window="hann"), dict(nfft=8192),
                dict(nfft=1024), dict(nfft=1024, window="hann")):
        both("periodogram", x, fs=1000.0, **cfg)
    both("periodogram", xb, nfft=1024, axis=-1)
    raises("welch", "scaling", x, nperseg=256, scaling="bogus")
    raises("welch", "shorter", np.zeros(100, np.float32), nperseg=256)


def test_csd_coherence(rng):
    t = np.arange(8192) / 1000.0
    x = (np.sin(2 * np.pi * 50 * t)
         + 0.5 * rng.standard_normal(8192)).astype(np.float32)
    y = (np.sin(2 * np.pi * 50 * t + 0.7)
         + 0.5 * rng.standard_normal(8192)).astype(np.float32)
    for cfg in (dict(nperseg=256), dict(nperseg=256, noverlap=192),
                dict(nperseg=128, nfft=256)):
        both("csd", x, y, fs=1000.0, **cfg)
    f, C = both("coherence", x, y, fs=1000.0, nperseg=256)
    assert C[np.argmin(np.abs(f - 50))] > 0.9


def _istft_tapered(Z, W, nov):
    """boundary=False keeps the tapered edges, where both packages divide
    by a nearly vanishing win^2 sum and so amplify their float32 rounding
    (the JAX package's own test allows 5e-3 there against scipy): the
    interior at the chain tolerance, the edges at 5e-3."""
    _, y = both("istft", Z, nperseg=W, noverlap=nov, boundary=False, tol=5e-3)
    _, want = JF.istft(Z, nperseg=W, noverlap=nov, boundary=False)
    h = W // 2
    assert_close_c(y[h:-h], np.asarray(want)[h:-h], TOL_CHAIN, "istft interior")


def test_istft_boundary_false_and_validation(rng):
    x = rng.standard_normal(1024).astype(np.float32)
    _, _, Z = both("stft", x, nperseg=256, noverlap=128, boundary=None)
    _istft_tapered(Z, 256, 128)
    raises("istft", "nfft", Z, nperseg=512, noverlap=256)


def test_csd_unequal_lengths(rng):
    both("csd", rng.standard_normal(4096).astype(np.float32),
         rng.standard_normal(3000).astype(np.float32), nperseg=256)


@pytest.mark.parametrize("src,num", [(100, 50), (100, 51), (100, 64),
                                     (100, 150), (100, 151), (101, 50),
                                     (101, 202)])
def test_resample(rng, src, num):
    both("resample", rng.standard_normal((3, src)).astype(np.float32), num,
         axis=-1)


@pytest.mark.parametrize("n", [64, 65])
def test_hilbert(rng, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    ya = both("hilbert", x)
    assert np.max(np.abs(ya[..., 0] - x)) < 1e-5


@pytest.mark.parametrize("cfg", [dict(), dict(nperseg=512),
                                 dict(nperseg=256, noverlap=128),
                                 dict(window="hann", nperseg=256),
                                 dict(scaling="spectrum")])
def test_spectrogram(rng, cfg):
    both("spectrogram", rng.standard_normal(4096).astype(np.float32),
         fs=1000.0, **cfg)


def test_stft_istft_non_dividing_hop(rng):
    x = rng.standard_normal(1000).astype(np.float32)
    _, _, Z = both("stft", x, nperseg=256, noverlap=56)       # hop 200
    _, y = both("istft", Z, nperseg=256, noverlap=56, tol=TOL_CHAIN)
    assert np.max(np.abs(y[256:744] - x[256:744])) < 1e-4


def test_czt_zoom_fft(rng):
    z = _cplx(rng, 3, 50)
    for m, w, a in ((50, None, 1 + 0j), (30, None, 1 + 0j),
                    (64, np.exp(-1j * 0.1), 1 + 0j),
                    (40, np.exp(-1j * 0.07), np.exp(1j * 0.3))):
        both("czt", z, m=m, w=w, a=a, tol=TOL_CHAIN)
    # decaying spirals are f32-limited in both packages (chirp tables span
    # orders of magnitude): loose bound, as in the JAX package's own test
    both("czt", z, m=25, w=0.99 * np.exp(-1j * 0.2), a=1.01, tol=2e-2)
    x = rng.standard_normal((2, 128)).astype(np.float32)
    for fn, m in ((0.4, 40), ([0.1, 0.3], 33), ([0.2, 0.8], 64)):
        both("zoom_fft", x, fn, m=m, tol=TOL_CHAIN)


def test_istft_short_signal_non_dividing_hop(rng):
    x = rng.standard_normal(456).astype(np.float32)
    _, _, Z = both("stft", x, nperseg=256, noverlap=56, boundary=None)
    _istft_tapered(Z, 256, 56)


def test_stft_welch_non_default_axis(rng):
    x = rng.standard_normal((1024, 3)).astype(np.float32)
    both("stft", x, nperseg=256, axis=0)
    both("welch", x, nperseg=256, axis=0)


def test_convolve_correlate(rng):
    a = rng.standard_normal((20,))
    b = rng.standard_normal((7,))
    a2 = rng.standard_normal((9, 8))
    b2 = rng.standard_normal((3, 5))
    zc, kc = _cplx(rng, 16), _cplx(rng, 5)
    for mode in ("full", "same", "valid"):
        both("convolve", a, b, mode)
        both("convolve", a2, b2, mode)
        both("correlate", a, b, mode)
        both("correlate", a2, b2, mode)
        both("correlate", zc, kc, mode)
        for la, lb in ((20, 7), (7, 20)):
            assert np.array_equal(TF.correlation_lags(la, lb, mode),
                                  JF.correlation_lags(la, lb, mode)), mode
    both("correlate", b, a, "valid")
    ai = rng.integers(-9, 9, 12)
    bi = rng.integers(-9, 9, 4)
    got = both("convolve", ai, bi, tol=0)      # integer inputs round exactly
    assert np.array_equal(got, np.convolve(ai, bi))
    raises("convolve", "method", a, b, method="warp")
    with pytest.raises(T.PlanError, match="mode"):
        TF.correlation_lags(3, 4, "circular")


@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolve2d(rng, mode, boundary):
    a = rng.standard_normal((9, 11))
    for kshape in ((3, 5), (2, 4)):
        k = rng.standard_normal(kshape)
        both("convolve2d", a, k, mode, boundary)
        both("correlate2d", a, k, mode, boundary)
    if boundary == "fill":
        both("convolve2d", a, rng.standard_normal((3, 3)), mode,
             fillvalue=1.5)


def test_convolve2d_edges(rng):
    a = rng.standard_normal((8, 9))
    k = rng.standard_normal((3, 4))
    zc, kc = _cplx(rng, 8, 9), _cplx(rng, 3, 4)
    both("convolve2d", zc, kc, "same", "wrap")
    both("correlate2d", zc, kc, "same", "symm")
    both("convolve2d", k, a, "valid")
    both("correlate2d", k, a, "valid")
    both("convolve2d", k, a, "same")
    raises("convolve2d", "2-D", rng.standard_normal(8), rng.standard_normal(3))
    raises("convolve2d", "boundary", a, k, boundary="mirror")
    raises("convolve2d", "valid mode", a, rng.standard_normal((3, 12)),
           "valid")


def test_upfirdn(rng):
    x = rng.standard_normal((3, 50))
    h = rng.standard_normal(13)
    for up, down in ((1, 1), (3, 1), (1, 4), (3, 2), (7, 5)):
        both("upfirdn", h, x, up, down)
    both("upfirdn", h, x, 2, 3, axis=0)
    both("upfirdn", h, _cplx(rng, 40), 2, 3)
    both("upfirdn", h + 1j * rng.standard_normal(13), x[0], 2, 1)
    for mode in ("symmetric", "reflect", "edge", "wrap"):
        both("upfirdn", h, x, 2, 3, mode=mode)
    both("upfirdn", h, x, 2, 3, mode="constant", cval=1.5)
    raises("upfirdn", "mode", h, x, mode="smooth")
    raises("upfirdn", "1-D", rng.standard_normal((3, 3)), x)


@pytest.mark.parametrize("up,down", [(2, 1), (1, 3), (3, 2), (5, 7),
                                     (160, 441)])
def test_resample_poly(rng, up, down):
    both("resample_poly", rng.standard_normal((200, 3)), up, down,
         tol=TOL_CHAIN)


def test_resample_poly_modes(rng):
    import scipy.signal as ss
    x = rng.standard_normal((4, 150)) + 2.0       # nonzero background
    for padtype in ("constant", "mean", "maximum", "minimum", "median",
                    "symmetric", "reflect", "edge", "wrap"):
        both("resample_poly", x, 2, 3, axis=1, padtype=padtype, tol=TOL_CHAIN)
    both("resample_poly", x, 3, 1, axis=1, padtype="constant", cval=1.0,
         tol=TOL_CHAIN)
    both("resample_poly", x, 2, 3, axis=1, window=ss.firwin(31, 0.4),
         tol=TOL_CHAIN)
    both("resample_poly", _cplx(rng, 120), 2, 3, tol=TOL_CHAIN)
    both("resample_poly", x, 2, 2, axis=1)
    raises("resample_poly", "cval", x, 2, 3, padtype="mean", cval=1.0)


def test_decimate(rng):
    x = rng.standard_normal((3, 240))
    for q in (2, 4, 13):
        both("decimate", x, q, ftype="fir", tol=TOL_CHAIN)
    both("decimate", x, 4, n=20, ftype="fir", zero_phase=False, tol=TOL_CHAIN)
    both("decimate", x, 3, ftype="fir", axis=0, tol=TOL_CHAIN)
    raises("decimate", "iir", x, 4)
    with pytest.raises(T.PlanError) as e:
        with TF.default_device("cpu"):
            TF.decimate(x, 4)
    assert "TPU" not in str(e.value)


@pytest.mark.parametrize("N", [None, 12, (8, 16)])
def test_hilbert2(rng, N):
    both("hilbert2", rng.standard_normal((10, 14)), N)


def test_hilbert2_batched_axes(rng):
    x = rng.standard_normal((3, 10, 14))
    both("hilbert2", x)
    both("hilbert2", x, axes=(0, 2))
    raises("hilbert2", "distinct", x, axes=(1, -2))


def test_deconvolve(rng):
    sig = rng.standard_normal(24)
    div = np.array([1.0, 0.5, -0.25])
    q, r = both("deconvolve", sig, div, tol=1e-12)
    assert np.allclose(np.convolve(div, q) + r, sig)
    both("deconvolve", np.ones(2), np.ones(5), tol=0)


def test_detrend(rng):
    x = (np.linspace(0, 5, 200) + 0.3 * rng.standard_normal(200)
         ).astype(np.float32)
    for typ in ("constant", "linear"):
        both("detrend", x, type=typ)
    xb = rng.standard_normal((3, 100)).astype(np.float32) \
        + np.arange(100, dtype=np.float32) * 0.1
    both("detrend", xb, axis=-1)
    both("detrend", xb.T, axis=0)
    both("detrend", x, bp=[50, 120])
    raises("detrend", "type", x, type="quadratic")


def test_get_window():
    for w in ("hann", "hamming", ("tukey", 0.25), ("kaiser", 8.6), 8.6):
        for fftbins in (True, False):
            both("get_window", w, 64, fftbins=fftbins, tol=0)


# ---------------------------------------------------------------- FFTLog

@pytest.mark.parametrize("mu", [0.0, 0.5, 2.0, -0.5])
@pytest.mark.parametrize("n", [64, 127])
def test_fht(rng, mu, n):
    both("fht", rng.standard_normal((3, n)), 0.08, mu)


def test_fht_offset_bias(rng):
    n, dln, mu = 96, 0.05, 1.0
    offset = TF.fhtoffset(dln, mu, initial=0.3, bias=0.25)
    assert offset == JF.fhtoffset(dln, mu, initial=0.3, bias=0.25)
    both("fht", rng.standard_normal(n), dln, mu, offset=offset, bias=0.25)


@pytest.mark.parametrize("bias", [0.0, -0.4])
def test_ifht_roundtrip(rng, bias):
    n, dln, mu = 64, 0.1, 0.5
    A = rng.standard_normal((2, n))
    got = both("ifht", A, dln, mu, bias=bias)
    back = both("fht", np.asarray(got, dtype=np.float64), dln, mu, bias=bias)
    assert_close_c(back, A, 1e-4, "fht(ifht(A))")


def test_fht_singular_transform_warns():
    with TF.default_device("cpu"):
        with pytest.warns(UserWarning, match="singular transform"):
            TF.fht(np.ones(8), 0.1, mu=0.0, bias=-1.0)
        with pytest.warns(UserWarning, match="singular inverse"):
            TF.ifht(np.ones(8), 0.1, mu=1.0, bias=2.0)


# ---------------------------------------------------------------- lombscargle

def _ls_data(n=200, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, n))
    y = np.sin(2 * np.pi * 1.7 * t) + 0.4 * rng.standard_normal(n)
    return t, y, np.linspace(0.5, 40, 300)


# the JAX package reduces over the samples with an einsum, the port with a
# broadcast multiply and a sum (never a matmul, so never TF32): the two
# float32 summation orders over 200 samples differ, and a / CC amplifies
# that where CC is small; the JAX package's own test allows 5e-4 vs scipy
TOL_LS = 2e-4


@pytest.mark.parametrize("norm", [False, True, "power", "normalize",
                                  "amplitude"])
def test_lombscargle_normalize_modes(norm):
    t, y, freqs = _ls_data()
    got = both("lombscargle", t, y, freqs, normalize=norm, tol=TOL_LS)
    if norm == "amplitude":
        assert got.shape == (freqs.size, 2)


def test_lombscargle_weights_floating_mean_precenter():
    t, y, freqs = _ls_data(seed=3)
    w = np.random.default_rng(7).uniform(0.5, 2.0, t.size)
    both("lombscargle", t, y + 2.5, freqs, weights=w, floating_mean=True,
         normalize=True, tol=TOL_LS)
    both("lombscargle", t, y, freqs, precenter=True, tol=TOL_LS)


def test_lombscargle_validation():
    t, y, freqs = _ls_data(n=16)
    raises("lombscargle", "", t, y[:-1], freqs)
    raises("lombscargle", "", t, y, [])
    raises("lombscargle", "", t, y, freqs, weights=-np.ones(16))
    raises("lombscargle", "", t, y, freqs, normalize="psd")


def test_lombscargle_is_full_f32_under_tf32_flag():
    """Design point: no matmul in the sample reductions, so the caller's
    TF32 flag cannot touch them and the facade sets no global flag."""
    import torch
    t, y, freqs = _ls_data()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with TF.default_device("cpu"):
            a = TF.lombscargle(t, y, freqs)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    with TF.default_device("cpu"):
        b = TF.lombscargle(t, y, freqs)
    assert torch.equal(a, b)


# ---------------------------------------------------------------- hermitian ND

def test_hfft2_hfftn(rng):
    z = _cplx(rng, 4, 5)
    for kw in [{}, {"s": (4, 8)}, {"norm": "ortho"}, {"norm": "forward"}]:
        both("hfft2", z, **kw)
    both("hfftn", _cplx(rng, 3, 4, 5), axes=(0, 2))


def test_ihfft2_ihfftn(rng):
    x = rng.standard_normal((6, 7))
    for kw in [{}, {"norm": "ortho"}, {"norm": "forward"}]:
        both("ihfft2", x, **kw)
    both("ihfftn", rng.standard_normal((3, 6, 7)), s=(4, 8), axes=(1, 2))


def test_hermitian_roundtrip(rng):
    x = rng.standard_normal((6, 8)).astype(np.float32)
    spec = both("ihfft2", x)
    back = both("hfft2", spec, s=x.shape)
    assert np.max(np.abs(back - x)) < 1e-4


def test_hermitian_edge_conventions(rng):
    x = rng.standard_normal((6, 7))
    z = _cplx(rng, 4, 5)
    for axes in ((1, 1), (1, -1)):
        for fn, arr in (("ihfftn", x), ("hfftn", z)):
            raises(fn, "duplicate", arr, axes=axes)
    for kw in [{"s": (-1, -1)}, {"s": (-1, 4), "axes": (0, 1)},
               {"s": (4, -1), "norm": "ortho"}]:
        both("ihfftn", x, **kw)
        both("hfftn", z, **kw)
    raises("ihfftn", "rank", x, s=(2, 3, 4))


def test_prev_fast_len_and_compat_shims():
    for n in (1, 12, 13, 17, 100, 1000, 4097):
        assert TF.prev_fast_len(n) == JF.prev_fast_len(n)
    raises("prev_fast_len", "", 0)
    with TF.set_workers(4):
        assert TF.get_workers() == 1
    with TF.set_backend("anything"):
        pass
    with TF.skip_backend("anything"):
        pass
    TF.set_global_backend("x")
    TF.register_backend("x")


def test_oracle_kwargs_shims(zc):
    """scipy.fft / numpy.fft control kwargs: accepted (positionally too),
    ``plan=`` and ``out=`` refused, as in the JAX package."""
    both("fft", zc, None, -1, None, False, 2)
    both("dct", zc.real, 2, None, -1, None, True)
    both("fft", zc, overwrite_x=True, workers=4)
    for mod in (JF, TF):
        with pytest.raises(NotImplementedError):
            mod.fft(zc, plan=object())
        with pytest.raises(NotImplementedError):
            mod.fft(zc, out=np.zeros(3))
        with pytest.raises(TypeError):
            mod.fft(zc, None, -1, None, False, 2, 3)


# ------------------------------------------------ tests/test_signal_utils.py

def _mod_signal(rng, n=64):
    t = np.arange(n)
    return (np.cos(2 * np.pi * 8 * t / n)
            * (1 + 0.5 * np.cos(2 * np.pi * 2 * t / n)) + 0.3
            + 0.2 * np.cos(2 * np.pi * 1 * t / n)
            + 0.05 * rng.standard_normal(n))


@pytest.mark.parametrize("kw", [
    {}, {"squared": True}, {"residual": None}, {"residual": "all"},
    {"bp_in": (3, 20)}, {"n_out": 32}, {"n_out": 48}, {"n_out": 128},
    {"bp_in": (3, 20), "n_out": 32},
    {"bp_in": (3, 20), "n_out": 32, "residual": "all"},
    {"bp_in": (3, 20), "n_out": 96, "residual": "all"},
    {"bp_in": (0, 20)}, {"bp_in": (-3, 20)}, {"bp_in": (None, None)},
    {"bp_in": (-32, 10)}, {"bp_in": (0, 20), "n_out": 48},
    {"bp_in": (-3, 20), "residual": "all"},
])
def test_envelope_real(rng, kw):
    both("envelope", _mod_signal(rng), **kw)


def test_envelope_odd_batch_axis(rng):
    x = rng.standard_normal(63)
    both("envelope", x)
    both("envelope", x, n_out=32)
    both("envelope", x, n_out=127)
    both("envelope", x, (0, 20))
    both("envelope", rng.standard_normal((3, 64)))
    x3 = rng.standard_normal((64, 3))
    both("envelope", x3, axis=0)
    both("envelope", x3, axis=0, residual=None)


def test_envelope_complex(rng):
    z = _cplx(rng, 64)
    for kw in [{"bp_in": (-5, 20)}, {"bp_in": (-5, 20), "n_out": 32},
               {"bp_in": (-5, 20), "n_out": 96},
               {"bp_in": (-32, 10), "residual": "all"}]:
        both("envelope", z, **kw)
    both("envelope", z, (-5, 20), residual=None)


def test_envelope_validation():
    raises("envelope", "", np.zeros(16), (5, 3))
    raises("envelope", "", np.zeros(16), (0, 100))
    raises("envelope", "", np.zeros(16), residual="bandpass")


def test_vectorstrength(rng):
    ev = rng.uniform(0, 100, 400)
    for per in [10.0, [7.5, 10.0, 13.3]]:
        # the phase of a weak resultant is ill-conditioned in float32: the
        # two packages' means differ in the last bits; 1e-4 of max|phase|
        both("vectorstrength", ev, per, tol=1e-4)
    s, p = both("vectorstrength", np.arange(20) * 4.0, 4.0, tol=1e-4)
    assert abs(float(s) - 1.0) < 1e-6
    raises("vectorstrength", "", np.zeros((2, 2)), 1.0)
    raises("vectorstrength", "", np.zeros(4), -1.0)


def test_czt_points(rng):
    both("czt_points", 9, tol=0)
    w = 0.98 * np.exp(1j * 0.1)
    both("czt_points", 7, w, 1.5, tol=0)
    raises("czt_points", "", 0)
    x = rng.standard_normal(16)
    w = 0.99 * np.exp(-1j * 2 * np.pi / 20)
    both("czt", x, 10, w, 1.1, tol=1e-4)   # a decaying spiral (see above)


@pytest.mark.parametrize("win,Wn,O", [
    ("hann", 8, 4), ("hann", 8, 5), ("hann", 8, 3), ("boxcar", 10, 0),
    ("blackman", 64, 32), ("hann", 256, 96)])
def test_cola_nola(win, Wn, O):
    assert TF.check_COLA(win, Wn, O) == JF.check_COLA(win, Wn, O)
    assert TF.check_NOLA(win, Wn, O) == JF.check_NOLA(win, Wn, O)


def test_cola_nola_array_window_and_validation():
    w = np.ones(7)
    assert TF.check_COLA(w, 7, 3) == JF.check_COLA(w, 7, 3)
    raises("check_COLA", "", "hann", 8, 8)
    raises("check_NOLA", "", "hann", 0, 0)


def test_choose_conv_method():
    for a, b in [(5, 3), (100, 10), (100000, 9000), (50, 40)]:
        assert TF.choose_conv_method(np.ones(a), np.ones(b)) == \
            JF.choose_conv_method(np.ones(a), np.ones(b)), (a, b)
    assert TF.choose_conv_method(np.arange(10), np.arange(3)) == "direct"
    method, times = TF.choose_conv_method(np.ones(256), np.ones(64),
                                          measure=True)
    assert method in ("fft", "direct") and set(times) == {"fft", "direct"}


def test_czt_zoom_classes(rng):
    x = rng.standard_normal(37)
    w = 0.995 * np.exp(-1j * 0.07)
    with TF.default_device("cpu"):
        got = to_numpy(TF.CZT(37, 11, w, 1.1)(x))
        zg = [to_numpy(TF.ZoomFFT(37, [2, 9], 23, fs=20, endpoint=e)(x))
              for e in (False, True)]
    assert_close_c(got, to_numpy(JF.CZT(37, 11, w, 1.1)(x)), 1e-4, "CZT")
    assert np.array_equal(TF.CZT(37, 11, w, 1.1).points(),
                          JF.CZT(37, 11, w, 1.1).points())
    for e, g in zip((False, True), zg):
        assert_close_c(g, to_numpy(JF.ZoomFFT(37, [2, 9], 23, fs=20,
                                              endpoint=e)(x)),
                       TOL_CHAIN, f"ZoomFFT endpoint={e}")
    for mod, err in ((JF, W.PlanError), (TF, T.PlanError)):
        with pytest.raises(err):
            mod.CZT(0)
        with pytest.raises(err):
            mod.ZoomFFT(16, [1, 2, 3])


def test_plan_tuning_reaches_the_plans(rng):
    """``plan_tuning`` knobs land in the spec of every plan the facade
    builds inside the block, nest, and are restored on exit."""
    z = _cplx(rng, 2, 16)
    cache = T.default_cache()
    with TF.default_device("cpu"):
        with TF.plan_tuning(impl="xla"):
            with TF.plan_tuning(maxSubLength=8):
                assert TF._DEFAULT_TUNING == {"impl": "xla", "maxSubLength": 8}
            assert TF._DEFAULT_TUNING == {"impl": "xla"}
            y1 = TF.fft(z)
        assert TF._DEFAULT_TUNING == {}
        y2 = TF.fft(z)
    impls = {s.tuning.impl for s in cache.specs()
             if s.plan_type == "c2c" and s.shape == (16,) and s.batch == 2}
    assert "xla" in impls and len(impls) >= 2
    assert_close_c(to_numpy(y1), to_numpy(y2), 1e-5)
