"""The port's window zoo (webgpufft_tpu_torch.windows) against the JAX
package's (webgpufft_tpu.windows), case by case as tests/test_windows.py.

Both are host float64 tables computed by the same formulas, so they must
agree to the last bit (``array_equal``); the JAX package's own tests pin
them to scipy.
"""

import warnings

import numpy as np
import pytest

import webgpufft_tpu_torch as T
from webgpufft_tpu import PlanError as JPlanError
from webgpufft_tpu import windows as JW
from webgpufft_tpu_torch import windows as TW

PLAIN = [
    "boxcar", "triang", "parzen", "bohman", "blackman", "nuttall",
    "blackmanharris", "flattop", "bartlett", "barthann", "hamming",
    "hann", "cosine", "lanczos",
]


def _same(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float64, label
    assert got.shape == want.shape, label
    assert np.array_equal(got, want), label


def test_same_public_names():
    assert sorted(TW.__all__) == sorted(JW.__all__)
    assert T.windows is TW


@pytest.mark.parametrize("name", PLAIN)
@pytest.mark.parametrize("M", [0, 1, 2, 8, 9, 16, 17])
@pytest.mark.parametrize("sym", [True, False])
def test_plain_windows(name, M, sym):
    _same(getattr(TW, name)(M, sym=sym), getattr(JW, name)(M, sym=sym),
          (name, M, sym))


PARAMETRIC = [
    ("kaiser", (8.6,)), ("gaussian", (2.5,)), ("general_gaussian", (1.5, 3)),
    ("general_hamming", (0.7,)), ("general_cosine", ([0.4, 0.4, 0.2],)),
    ("chebwin", (80,)), ("tukey", (0.4,)), ("taylor", (5, 40, True)),
    ("exponential", (None, 2.0)),
]


@pytest.mark.parametrize("case", range(len(PARAMETRIC)))
@pytest.mark.parametrize("M", [8, 9, 16, 1])
@pytest.mark.parametrize("sym", [True, False])
def test_parametric_windows(case, M, sym):
    name, args = PARAMETRIC[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same(getattr(TW, name)(M, *args, sym), getattr(JW, name)(M, *args, sym),
              (name, M, sym))


def test_tukey_degenerate_kbd_exponential_taylor():
    _same(TW.tukey(8, 0.0), JW.tukey(8, 0.0))
    _same(TW.tukey(8, 1.5), JW.tukey(8, 1.5))
    for M in (8, 16):
        _same(TW.kaiser_bessel_derived(M, 8.6), JW.kaiser_bessel_derived(M, 8.6))
    _same(TW.exponential(9, 2.0, 1.5, sym=False),
          JW.exponential(9, 2.0, 1.5, sym=False))
    _same(TW.taylor(16, 4, 30, norm=False), JW.taylor(16, 4, 30, norm=False))


@pytest.mark.parametrize("call", [
    lambda W: W.kaiser_bessel_derived(9, 8.6),
    lambda W: W.kaiser_bessel_derived(8, 8.6, sym=False),
    lambda W: W.exponential(9, 2.0, 1.5, sym=True),
    lambda W: W.dpss(16, 9),
    lambda W: W.dpss(16, 3, 0),
    lambda W: W.dpss(16, 3, norm="bad"),
    lambda W: W.get_window("nosuchwindow", 16),
    lambda W: W.get_window(("kaiser",), 16),
    lambda W: W.get_window(("hann", 1.0), 16),
])
def test_validation_raises_in_both(call):
    with pytest.raises(JPlanError):
        call(JW)
    with pytest.raises(T.PlanError):
        call(TW)


@pytest.mark.parametrize("norm", [2, "approximate", "subsample"])
@pytest.mark.parametrize("M,NW,K", [(64, 3, 4), (33, 2.5, 3)])
def test_dpss(M, NW, K, norm):
    _same(TW.dpss(M, NW, K, norm=norm), JW.dpss(M, NW, K, norm=norm))


def test_dpss_ratios_and_singleton():
    got, rg = TW.dpss(64, 3, 4, return_ratios=True)
    want, rw = JW.dpss(64, 3, 4, return_ratios=True)
    _same(got, want)
    _same(rg, rw)
    _same(TW.dpss(64, 3), JW.dpss(64, 3))
    _same(TW.dpss(64, 3, sym=False), JW.dpss(64, 3, sym=False))


SPECS = ["hann", "hamming", "blackmanharris", ("kaiser", 8.6),
         ("tukey", 0.3), 7.2, ("chebwin", 60), ("gaussian", 2.0),
         ("exponential", None, 1.5), ("dpss", 3), "flattop",
         ("general_hamming", 0.7)]


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_get_window(spec):
    s = SPECS[spec]
    _same(TW.get_window(s, 32), JW.get_window(s, 32), s)
    _same(TW.get_window(s, 33, fftbins=False),
          JW.get_window(s, 33, fftbins=False), s)


def test_get_window_aliases():
    for alias, canon in [("han", "hann"), ("ham", "hamming"),
                         ("blk", "blackman"), ("bart", "bartlett")]:
        _same(TW.get_window(alias, 16), TW.get_window(canon, 16))
        _same(TW.get_window(alias, 16), JW.get_window(alias, 16))


def test_facade_resolution_uses_this_module():
    """fftapi.get_window (what stft/welch consume) resolves through the
    port's own zoo and returns float32 numpy as the JAX package's does."""
    from webgpufft_tpu.fftapi import get_window as j_gw
    from webgpufft_tpu_torch.fftapi import get_window as t_gw
    got, want = t_gw(("kaiser", 5.0), 24), j_gw(("kaiser", 5.0), 24)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got, TW.get_window(("kaiser", 5.0), 24).astype(np.float32))
