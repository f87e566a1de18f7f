"""The port's ShortTimeFFT (webgpufft_tpu_torch.shorttime) against the JAX
package's (webgpufft_tpu.shorttime), case by case as tests/test_shorttime.py
plus the closest_STFT_dual_window cases of tests/test_signal_utils.py.

Geometry and window tables are host float64 in both and must be equal; the
transforms get the same seeded numpy input (the port on the CPU device) and
agree at 1e-5 of max|expected|.  The JAX package's own tests pin it to
scipy.signal.ShortTimeFFT.
"""

import numpy as np
import pytest

import scipy.signal as ss

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu import fftapi as JF
from webgpufft_tpu_torch import fftapi as TF
from torch_port_support import assert_close_c, to_numpy

GAUSS = ss.windows.gaussian(8, std=2, sym=True)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _pair(win=GAUSS, hop=3, fs=10, **kw):
    return (W.ShortTimeFFT(win, hop=hop, fs=fs, **kw),
            T.ShortTimeFFT(win, hop=hop, fs=fs, **kw))


def _cmp(pair, method, *args, tol=1e-5, **kw):
    """Call ``method`` on both objects; the port's result as numpy."""
    A, B = pair
    want = to_numpy(getattr(A, method)(*args, **kw))
    with TF.default_device("cpu"):
        got = to_numpy(getattr(B, method)(*args, **kw))
    assert_close_c(got, want, tol, method)
    return got


def _raises(pair, method, *args, **kw):
    A, B = pair
    with pytest.raises(W.PlanError):
        getattr(A, method)(*args, **kw)
    with TF.default_device("cpu"), pytest.raises(T.PlanError):
        getattr(B, method)(*args, **kw)


def test_exports():
    assert T.ShortTimeFFT is TF.ShortTimeFFT
    from webgpufft_tpu_torch import shorttime
    assert shorttime.__all__ == ["ShortTimeFFT", "closest_STFT_dual_window"]
    assert TF.closest_STFT_dual_window is shorttime.closest_STFT_dual_window


@pytest.mark.parametrize("m,hop", [
    (8, 3), (8, 4), (7, 3), (9, 5), (8, 8), (16, 4), (12, 6), (5, 2)])
def test_index_algebra(m, hop):
    A, B = _pair(np.hanning(m) + 0.1, hop, 7)
    assert (A.p_min, A.k_min, A.m_num, A.m_num_mid, A.f_pts) == \
        (B.p_min, B.k_min, B.m_num, B.m_num_mid, B.f_pts)
    assert A.lower_border_end == B.lower_border_end
    for n in (20, 21, 24, 33):
        assert A.p_max(n) == B.p_max(n)
        assert A.k_max(n) == B.k_max(n)
        assert A.p_num(n) == B.p_num(n)
        assert A.upper_border_begin(n) == B.upper_border_begin(n)
        assert np.array_equal(A.t(n), B.t(n))
    assert np.array_equal(A.f, B.f)
    assert np.array_equal(A.dual_win, B.dual_win)


def test_grid_extent_and_scaling_factors():
    A, B = _pair()
    assert A.extent(50) == B.extent(50)
    assert A.extent(50, "ft", True) == B.extent(50, "ft", True)
    assert A.delta_t == B.delta_t and A.delta_f == B.delta_f and A.T == B.T
    assert A.nearest_k_p(10) == B.nearest_k_p(10)
    assert A.nearest_k_p(10, left=False) == B.nearest_k_p(10, left=False)
    assert A.invertible and B.invertible
    assert A.fac_magnitude == B.fac_magnitude and A.fac_psd == B.fac_psd
    A.scale_to("psd")
    B.scale_to("psd")
    assert np.array_equal(A.win, B.win)
    assert np.array_equal(A.dual_win, B.dual_win)
    assert A.scaling == B.scaling == "psd"


def test_stft_basic(rng):
    _cmp(_pair(), "stft", rng.standard_normal(50))


@pytest.mark.parametrize("padding", ["zeros", "edge", "even", "odd"])
def test_stft_padding(rng, padding):
    _cmp(_pair(), "stft", rng.standard_normal(50), padding=padding)


def test_stft_p0_p1_k_offset(rng):
    x = rng.standard_normal(50)
    _cmp(_pair(), "stft", x, p0=2, p1=7)
    _cmp(_pair(), "stft", x, k_offset=5)


@pytest.mark.parametrize("mode", ["twosided", "centered"])
def test_stft_modes_and_complex_input(rng, mode):
    x = rng.standard_normal(50)
    _cmp(_pair(fft_mode=mode), "stft", x)
    _cmp(_pair(fft_mode=mode), "stft", x + 1j * rng.standard_normal(50))


@pytest.mark.parametrize("sc", ["magnitude", "psd"])
def test_stft_onesided2X(rng, sc):
    _cmp(_pair(fft_mode="onesided2X", scale_to=sc), "stft",
         rng.standard_normal(50))


@pytest.mark.parametrize("ps", [None, 0, 2, -3])
def test_stft_mfft_phase_shift(rng, ps):
    _cmp(_pair(mfft=16, phase_shift=ps), "stft", rng.standard_normal(50))


def test_stft_batched_and_axis(rng):
    x = rng.standard_normal((3, 50))
    _cmp(_pair(), "stft", x)
    _cmp(_pair(), "stft", np.ascontiguousarray(x.T), axis=0)


def test_stft_detrend_and_spectrogram(rng):
    x = rng.standard_normal(50) + 3.0
    for d in ("constant", "linear"):
        _cmp(_pair(), "stft_detrend", x, d)
    y = rng.standard_normal(50)
    _cmp(_pair(), "spectrogram", x)
    _cmp(_pair(), "spectrogram", x, y)


def test_stft_validation(rng):
    x = rng.standard_normal(50)
    _raises(_pair(), "stft", x + 1j * x)                # onesided + complex
    _raises(_pair(), "stft", x, p0=-10)
    _raises(_pair(), "stft", x, padding="wrap")
    for cls, err in ((W.ShortTimeFFT, W.PlanError),
                     (T.ShortTimeFFT, T.PlanError)):
        with pytest.raises(err):
            cls(np.ones(8), hop=0, fs=1.0)
        with pytest.raises(err):
            cls(np.ones(8), hop=2, fs=1.0, mfft=4)
        with pytest.raises(err):
            cls(np.ones(8), hop=2, fs=1.0, fft_mode="onesided2X")


def test_istft_roundtrip(rng):
    x = rng.standard_normal(50)
    S = _cmp(_pair(), "stft", x)
    xr = _cmp(_pair(), "istft", S, k1=50, interleaved=True)
    assert_close_c(xr, x, 1e-4, "roundtrip")


def test_istft_complex_spectrum_input_and_crop(rng):
    x = rng.standard_normal(50)
    S = ss.ShortTimeFFT(GAUSS, hop=3, fs=10).stft(x).astype(np.complex64)
    full = _cmp(_pair(), "istft", S, k1=50)
    _cmp(_pair(), "istft", S)
    crop = _cmp(_pair(), "istft", S, k0=5, k1=40)
    assert_close_c(crop, full[5:40], 1e-6, "crop")


@pytest.mark.parametrize("mode", ["twosided", "centered"])
def test_istft_modes(rng, mode):
    x = rng.standard_normal(50)
    S = ss.ShortTimeFFT(GAUSS, hop=3, fs=10, fft_mode=mode).stft(x)
    got = _cmp(_pair(fft_mode=mode), "istft", S.astype(np.complex64), k1=50)
    assert_close_c(got[..., 0], x, 1e-4, f"{mode} re")
    assert np.max(np.abs(got[..., 1])) < 1e-4


def test_istft_batched_and_validation(rng):
    x = rng.standard_normal(50)
    X = ss.ShortTimeFFT(GAUSS, hop=3, fs=10).stft(
        np.stack([x, 2 * x])).astype(np.complex64)
    xr = _cmp(_pair(), "istft", X, k1=50)
    assert_close_c(xr[1], 2 * x, 1e-4)
    S = _cmp(_pair(), "stft", x)
    _raises(_pair(), "istft", S[:-1], interleaved=True)       # wrong f_pts
    _raises(_pair(), "istft", S, k0=-100, interleaved=True)
    _raises(_pair(), "istft", S, k1=60, interleaved=True)
    A, B = _pair()
    k_hi = B.k_min + (S.shape[-2] - 1) * B.hop + B.m_num
    _cmp((A, B), "istft", S, k0=k_hi - 5, k1=k_hi, interleaved=True)


def test_from_window(rng):
    x = rng.standard_normal(50)
    A = W.ShortTimeFFT.from_window(("kaiser", 5), 100, 16, 12)
    B = T.ShortTimeFFT.from_window(("kaiser", 5), 100, 16, 12)
    assert np.array_equal(A.win, B.win) and A.hop == B.hop
    _cmp((A, B), "stft", x)
    As = W.ShortTimeFFT.from_window("hann", 100, 16, 12, symmetric_win=True)
    Bs = T.ShortTimeFFT.from_window("hann", 100, 16, 12, symmetric_win=True)
    assert np.array_equal(As.win, Bs.win)


def test_from_dual_and_win_equals_dual(rng):
    d = ss.ShortTimeFFT(GAUSS, hop=3, fs=10).dual_win
    A, B = W.ShortTimeFFT.from_dual(d, 3, 10), T.ShortTimeFFT.from_dual(d, 3, 10)
    assert np.array_equal(A.win, B.win)
    assert np.array_equal(A.dual_win, B.dual_win)
    for sc in (None, "unitary"):
        A = W.ShortTimeFFT.from_win_equals_dual(GAUSS, 3, 10, scale_to=sc)
        B = T.ShortTimeFFT.from_win_equals_dual(GAUSS, 3, 10, scale_to=sc)
        assert np.array_equal(A.win, B.win)
        assert np.array_equal(A.dual_win, B.dual_win)
    _cmp((A, B), "stft", rng.standard_normal(50))


def test_non_invertible():
    w = np.zeros(8)
    w[:2] = 1.0
    B = T.ShortTimeFFT(w, hop=4, fs=1)
    assert not B.invertible
    with pytest.raises(T.PlanError):
        _ = B.dual_win


@pytest.mark.parametrize("m,hop,n", [(7, 3, 41), (9, 5, 37), (5, 2, 23)])
def test_istft_default_k1_odd_window(rng, m, hop, n):
    w = np.hanning(m) + 0.1
    x = rng.standard_normal(n)
    S = ss.ShortTimeFFT(w, hop=hop, fs=7).stft(x).astype(np.complex64)
    _cmp(_pair(w, hop, 7), "istft", S)


def test_short_signal_and_negative_sum_window(rng):
    _cmp(_pair(), "stft", rng.standard_normal(5))
    A, B = _pair(-GAUSS, scale_to="magnitude")
    assert A.fac_magnitude == B.fac_magnitude
    _cmp((A, B), "stft", rng.standard_normal(50))


@pytest.mark.parametrize("m,mfft,ps", [
    (3, 6, -2), (3, 6, 4), (5, 7, -3), (4, 8, 6), (5, 12, -4)])
def test_phase_shift_modulo(rng, m, mfft, ps):
    w = rng.uniform(0.2, 1.0, m)
    _cmp(_pair(w, 1, 3, fft_mode="twosided", mfft=mfft, phase_shift=ps),
         "stft", rng.standard_normal(60))


@pytest.mark.parametrize("W_,H", [(8, 3), (64, 48), (130, 2), (67, 66)])
def test_overlap_add_against_numpy(rng, W_, H):
    """Both routes of ``_overlap_add`` (gcd-block adds; ``index_add`` when
    the window spans more than 64 blocks) against a numpy loop, and framing
    (``unfold``) as its adjoint's partner: frames of the signal."""
    import torch
    nb = 5
    fr = rng.standard_normal((2, nb, W_)).astype(np.float32)
    want = np.zeros((2, (nb - 1) * H + W_))
    for p in range(nb):
        want[:, p * H:p * H + W_] += fr[:, p]
    got = TF._overlap_add(torch.from_numpy(fr), W_, H).numpy()
    assert_close_c(got, want, 1e-6, "overlap-add")
    x = rng.standard_normal((2, (nb - 1) * H + W_)).astype(np.float32)
    frames = TF._frame_segments(torch.from_numpy(x), W_, H, nb)
    assert frames.shape == (2, nb, W_)
    assert frames._base is not None        # a view: nothing copied yet
    for p in range(nb):
        assert np.array_equal(frames[:, p].numpy(), x[:, p * H:p * H + W_])


def test_closest_dual_window():
    w = ss.windows.gaussian(8, 2)
    for scaled in (True, False):
        for dd in (None, np.ones(8), ss.windows.hann(8, sym=False) + 0.1):
            g, ga = TF.closest_STFT_dual_window(w, 3, dd, scaled=scaled)
            e, ea = JF.closest_STFT_dual_window(w, 3, dd, scaled=scaled)
            assert np.array_equal(g, e) and ga == ea
    d, _ = TF.closest_STFT_dual_window(w, 3, np.ones(8))
    x = np.random.default_rng(0).standard_normal(40)
    pair = _pair(w, 3, 1, dual_win=np.asarray(d))
    S = _cmp(pair, "stft", x)
    xr = _cmp(pair, "istft", S, k1=40, interleaved=True)
    assert np.max(np.abs(xr - x)) < 1e-4
    for mod, err in ((JF, W.PlanError), (TF, T.PlanError)):
        with pytest.raises(err):
            mod.closest_STFT_dual_window(np.ones(8), 0)
        with pytest.raises(err):
            mod.closest_STFT_dual_window(np.ones(8), 3, np.ones(7))
