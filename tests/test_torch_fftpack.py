"""The port's legacy scipy.fftpack namespace (webgpufft_tpu_torch.fftpack and
fftpack_convolve) against the JAX package's, case by case as
tests/test_fftpack.py: same seeded numpy input through both (the port on
the CPU device), 1e-5 of max|expected|.
"""

import numpy as np
import pytest
import scipy.fftpack as fp
import torch

from webgpufft_tpu import fftpack as JP
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import fftpack as TP
from torch_port_support import assert_close_c, to_numpy

# an operator of the diff family multiplies bin k by up to (k c)^order:
# float32 rounding of the high bins is amplified alike in both packages,
# but in different summation orders
TOL_DIFF = 5e-5


def _both(name, *args, tol=1e-5, **kw):
    want = to_numpy(getattr(JP, name)(*args, **kw))
    with TF.default_device("cpu"):
        got = getattr(TP, name)(*args, **kw)
    if name not in ("rfftfreq", "fftfreq", "next_fast_len"):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = to_numpy(got)
    assert_close_c(got, want, tol, f"fftpack.{name}")
    return got


def _raises_both(name, match, *args, exc=ValueError, **kw):
    with pytest.raises(exc, match=match):
        getattr(JP, name)(*args, **kw)
    with TF.default_device("cpu"), pytest.raises(exc, match=match):
        getattr(TP, name)(*args, **kw)


@pytest.mark.parametrize("n", [7, 8, 15, 16])
def test_packed_rfft_irfft(rng, n):
    x = rng.standard_normal(n)
    pk = _both("rfft", x)
    assert_close_c(pk, fp.rfft(x), 3e-5, "vs scipy")
    back = _both("irfft", fp.rfft(x))
    assert_close_c(back, x, 3e-5, "roundtrip")


def test_packed_rfft_axis_and_n(rng):
    x = rng.standard_normal((10, 3))
    _both("rfft", x, axis=0)
    _both("irfft", fp.rfft(x, axis=0), axis=0)
    y = rng.standard_normal((3, 10))
    _both("rfft", y, n=6)
    _both("rfft", y, n=14)


def test_packed_rfftfreq():
    _both("rfftfreq", 7, 0.5, tol=0)
    _both("rfftfreq", 8, 2.0, tol=0)
    _raises_both("rfftfreq", None, 7.5, exc=TypeError)
    _raises_both("rfftfreq", None, -3)


@pytest.mark.parametrize("type", [1, 2, 3, 4])
def test_legacy_trig_scaling(rng, type):
    x = rng.standard_normal(9)
    for name in ("dct", "idct", "dst", "idst"):
        _both(name, x, type=type)
    _both("idct", x, type=type, norm="ortho")


def test_nd_shape_param(rng):
    v = rng.standard_normal((4, 6))
    _both("fftn", v, shape=(4, 4))
    _both("ifftn", v, shape=(4, 4))
    _both("idctn", v)
    _both("dstn", v, shape=(4, 4))
    _both("idstn", v)
    _both("dctn", v)
    z = v + 1j * rng.standard_normal((4, 6))
    for name in ("fft", "ifft", "fft2", "ifft2"):
        _both(name, z)


@pytest.mark.parametrize("n", [15, 16])
def test_pseudo_diff_family(rng, n):
    x = rng.standard_normal(n)
    x -= x.mean()
    for order in (0, 1, 2, 3, 4):
        _both("diff", x, order, tol=TOL_DIFF)
        _both("diff", x, order, period=3.7, tol=TOL_DIFF)
    _both("hilbert", x)
    _both("ihilbert", x)
    _both("tilbert", x, 0.9)
    _both("itilbert", x, 0.9)
    for name in ("sc_diff", "cs_diff", "cc_diff", "ss_diff"):
        _both(name, x, 0.5, 1.1)
    for a in (0.6, 1.3):
        _both("shift", x, a)
        _both("shift", x, a, period=5.0)


def test_pseudo_diff_inverses(rng):
    x = rng.standard_normal(15)
    x -= x.mean()
    with TF.default_device("cpu"):
        assert_close_c(to_numpy(TP.itilbert(TP.tilbert(x, 1.1), 1.1)), x, 1e-4)
        assert_close_c(to_numpy(TP.ihilbert(TP.hilbert(x))), x, 1e-4)
        assert_close_c(to_numpy(TP.diff(TP.diff(x, 1), -1)), x, 1e-4)


def test_legacy_shape_minus_one_and_rank_mismatch(rng):
    v = rng.standard_normal((3, 4, 6))
    _both("fftn", v, shape=(-1, 4, 6))
    _raises_both("fftn", "same length", v, shape=(4, 4))
    _raises_both("dctn", "same length", v, shape=(4, 4))
    _both("dctn", v, shape=(-1, 4), axes=(0, 2))


def test_duplicate_axes_raise_like_scipy(rng):
    v = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    for axes in ((1, 1), (1, -1)):
        _raises_both("fftn", "unique", v, axes=axes)
        _raises_both("dctn", "unique", v.real, axes=axes)
    _both("fftn", v, axes=(0, -1))
    # the guard normalizes against the COMPLEX rank for interleaved inputs
    zi = np.stack([v.real, v.imag], -1).astype(np.float32)
    _both("fft2", zi, axes=(1, -2))
    _raises_both("fft2", "unique", zi, axes=(1, -1))
    _both("fftn", zi, shape=(3, 4))
    _both("fft2", zi, shape=(-1, -1), axes=(-2, -1))
    with TF.default_device("cpu"):
        got = to_numpy(TP.fft2(torch.from_numpy(zi), shape=(-1, -1)))
    assert_close_c(got[..., 0] + 1j * got[..., 1], fp.fft2(v), 3e-5, "tensor in")


def test_packed_irfft_n_crop_pad(rng):
    x = rng.standard_normal(10)
    _both("irfft", x, n=6)
    _both("irfft", x, n=13)
    _both("irfft", rng.standard_normal((3, 10)), n=6, axis=1)


def test_multiplier_tables_are_cached(rng):
    TP._MULT_CACHE.clear()
    x = rng.standard_normal(12)
    with TF.default_device("cpu"):
        TP.tilbert(x, 0.7)
        assert len(TP._MULT_CACHE) == 1
        TP.tilbert(rng.standard_normal(12), 0.7)   # same key: no new entry
        assert len(TP._MULT_CACHE) == 1
        TP.tilbert(x, 0.8)
        assert len(TP._MULT_CACHE) == 2


def test_surface_complete():
    for name in fp.__all__:
        assert hasattr(TP, name), f"fftpack.{name} missing"
    assert sorted(TP.__all__) == sorted(JP.__all__)
    assert TP.next_fast_len(17) == JP.next_fast_len(17)
    assert np.array_equal(TP.fftfreq(8, 0.5), JP.fftfreq(8, 0.5))
    with TF.default_device("cpu"):
        assert np.array_equal(to_numpy(TP.fftshift(np.arange(8.0), interleaved=False)),
                              np.fft.fftshift(np.arange(8.0)))


# ------------------------------------------------------- fftpack.convolve

from webgpufft_tpu.fftpack import convolve as jcv      # noqa: E402
from webgpufft_tpu_torch.fftpack import convolve as tcv   # noqa: E402


def test_convolve_importable_as_submodule():
    import webgpufft_tpu_torch.fftpack.convolve as tcv2
    from webgpufft_tpu_torch import fftpack_convolve
    assert tcv2 is tcv is fftpack_convolve
    assert sorted(tcv.__all__) == sorted(jcv.__all__)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 16, 33])
@pytest.mark.parametrize("d", [0, 1, 2, 3, -1, -2, -3, -4])
def test_init_convolution_kernel(n, d):
    for zn in (None, 0, 1):
        kw = {} if zn is None else {"zero_nyquist": zn}
        ref = jcv.init_convolution_kernel(n, lambda k: 1.0 / (1.0 + k), d=d, **kw)
        got = tcv.init_convolution_kernel(n, lambda k: 1.0 / (1.0 + k), d=d, **kw)
        assert got.dtype == np.float64 and np.array_equal(got, ref)
    ref = jcv.init_convolution_kernel(6, lambda k, a: a * (k + 1),
                                      kernel_func_extra_args=(2.5,))
    got = tcv.init_convolution_kernel(6, lambda k, a: a * (k + 1),
                                      kernel_func_extra_args=(2.5,))
    assert np.array_equal(got, ref)


def _cv_both(name, *args, **kw):
    want = to_numpy(getattr(jcv, name)(*args, **kw))
    with TF.default_device("cpu"):
        got = to_numpy(getattr(tcv, name)(*args, **kw))
    assert_close_c(got, want, 1e-5, f"convolve.{name}")
    return got


@pytest.mark.parametrize("n", [4, 7, 8, 17, 32])
@pytest.mark.parametrize("swap", [False, True])
def test_convolve(rng, n, swap):
    om = jcv.init_convolution_kernel(n, lambda k: np.cos(0.3 * k))
    _cv_both("convolve", rng.standard_normal(n), om, swap_real_imag=swap)


@pytest.mark.parametrize("n", [4, 9, 16])
def test_convolve_z(rng, n):
    om_r = jcv.init_convolution_kernel(n, lambda k: 1.0 / (1.0 + k))
    om_i = jcv.init_convolution_kernel(n, lambda k: float(k), d=1)
    _cv_both("convolve_z", rng.standard_normal(n), om_r, om_i)


def test_convolve_tensor_input_and_diff_identity(rng):
    n = 16
    x = rng.standard_normal(n)
    om = tcv.init_convolution_kernel(n, lambda k: float(k), d=1)
    got = tcv.convolve(torch.from_numpy(x), om, swap_real_imag=True)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert_close_c(got.numpy(), fp.diff(x), 3e-5, "diff identity")


def test_convolve_validation():
    for cv in (jcv, tcv):
        with TF.default_device("cpu"):
            with pytest.raises(ValueError, match="same length"):
                cv.convolve(np.ones(4), np.ones(5))
            with pytest.raises(ValueError, match="same length"):
                cv.convolve(np.ones((4, 4)), np.ones(4))
            with pytest.raises(ValueError, match="same length"):
                cv.convolve_z(np.ones(4), np.ones(4), np.ones(5))
            with pytest.raises(ValueError, match="positive"):
                cv.init_convolution_kernel(0, lambda k: 1.0)
            cv.destroy_convolve_cache()
