"""Window functions (scipy.signal.windows semantics) — host f64 tables.

Self-contained implementations of the standard window zoo, so the
framework's window tables (STFT framing, FIR design, spectral
estimation) do not depend on scipy at runtime.  Every window follows the
published formula and scipy's conventions exactly: ``sym=True`` returns
the symmetric (filter-design) window; ``sym=False`` the periodic
(spectral-analysis) one, computed as the length-(M+1) symmetric window
with the last sample dropped; M <= 1 short-circuits.  Pinned
value-for-value against scipy.signal.windows in tests/test_windows.py.

`get_window` dispatches scipy's name/alias/tuple vocabulary and is what
the rest of the framework (fftapi.get_window, firwin, welch, stft, ...)
resolves windows through.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .spec import PlanError

__all__ = [
    "boxcar", "triang", "parzen", "bohman", "blackman", "nuttall",
    "blackmanharris", "flattop", "bartlett", "barthann", "hamming",
    "kaiser", "kaiser_bessel_derived", "gaussian", "general_gaussian",
    "general_cosine", "general_hamming", "chebwin", "cosine", "hann",
    "exponential", "tukey", "taylor", "dpss", "lanczos", "get_window",
]


def _len_guards(M: int):
    """scipy's _len_guards: trivial windows for M <= 1 (and int check)."""
    if int(M) != M or M < 0:
        raise PlanError("Window length M must be a non-negative integer")
    return int(M) <= 1


def _extend(M: int, sym: bool):
    """scipy's _extend: periodic windows compute M+1 symmetric samples
    and drop the last."""
    if not sym:
        return M + 1, True
    return M, False


def _truncate(w: np.ndarray, needs_trunc: bool) -> np.ndarray:
    return w[:-1] if needs_trunc else w


def boxcar(M: int, sym: bool = True) -> np.ndarray:
    """Rectangular window."""
    if _len_guards(M):
        return np.ones(M)
    return np.ones(M)


def general_cosine(M: int, a, sym: bool = True) -> np.ndarray:
    """Generic weighted cosine-sum window: sum_k a_k cos(2 pi k n/(M-1))."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    fac = np.linspace(-np.pi, np.pi, M)
    w = np.zeros(M)
    for k, coef in enumerate(np.asarray(a, dtype=np.float64)):
        w += coef * np.cos(k * fac)
    return _truncate(w, needs_trunc)


def hann(M: int, sym: bool = True) -> np.ndarray:
    """Hann window."""
    return general_hamming(M, 0.5, sym)


def hamming(M: int, sym: bool = True) -> np.ndarray:
    """Hamming window (alpha = 0.54)."""
    return general_hamming(M, 0.54, sym)


def general_hamming(M: int, alpha: float, sym: bool = True) -> np.ndarray:
    """Generalized Hamming: alpha - (1-alpha) cos-term."""
    return general_cosine(M, [alpha, 1.0 - alpha], sym)


def blackman(M: int, sym: bool = True) -> np.ndarray:
    """Blackman window (the 'not very serious proposal' coefficients)."""
    return general_cosine(M, [0.42, 0.50, 0.08], sym)


def nuttall(M: int, sym: bool = True) -> np.ndarray:
    """Nuttall 4-term minimum-sidelobe window."""
    return general_cosine(M, [0.3635819, 0.4891775, 0.1365995,
                              0.0106411], sym)


def blackmanharris(M: int, sym: bool = True) -> np.ndarray:
    """4-term Blackman-Harris window."""
    return general_cosine(M, [0.35875, 0.48829, 0.14128, 0.01168], sym)


def flattop(M: int, sym: bool = True) -> np.ndarray:
    """Flat-top window (amplitude-accurate for tone measurement)."""
    a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
    return general_cosine(M, a, sym)


def bartlett(M: int, sym: bool = True) -> np.ndarray:
    """Bartlett (zero-ended triangular) window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M)
    w = np.where(n <= (M - 1) / 2.0, 2.0 * n / (M - 1),
                 2.0 - 2.0 * n / (M - 1))
    return _truncate(w, needs_trunc)


def triang(M: int, sym: bool = True) -> np.ndarray:
    """Triangular window (nonzero endpoints)."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(1, (M + 1) // 2 + 1)
    if M % 2 == 0:
        w = (2 * n - 1.0) / M
        w = np.r_[w, w[::-1]]
    else:
        w = 2 * n / (M + 1.0)
        w = np.r_[w, w[-2::-1]]
    return _truncate(w, needs_trunc)


def parzen(M: int, sym: bool = True) -> np.ndarray:
    """Parzen (de la Vallee Poussin) window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(-(M - 1) / 2.0, (M - 1) / 2.0 + 0.5, 1.0)
    na = np.extract(n < -(M - 1) / 4.0, n)
    nb = np.extract(abs(n) <= (M - 1) / 4.0, n)
    wa = 2 * (1 - np.abs(na) / (M / 2.0)) ** 3.0
    wb = (1 - 6 * (np.abs(nb) / (M / 2.0)) ** 2.0
          + 6 * (np.abs(nb) / (M / 2.0)) ** 3.0)
    w = np.r_[wa, wb, wa[::-1]]
    return _truncate(w, needs_trunc)


def bohman(M: int, sym: bool = True) -> np.ndarray:
    """Bohman window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    fac = np.abs(np.linspace(-1, 1, M)[1:-1])
    w = (1 - fac) * np.cos(np.pi * fac) + 1.0 / np.pi * np.sin(np.pi * fac)
    w = np.r_[0, w, 0]
    return _truncate(w, needs_trunc)


def barthann(M: int, sym: bool = True) -> np.ndarray:
    """Bartlett-Hann window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M)
    fac = np.abs(n / (M - 1.0) - 0.5)
    w = 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)
    return _truncate(w, needs_trunc)


def cosine(M: int, sym: bool = True) -> np.ndarray:
    """Cosine (half-sine) window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    w = np.sin(np.pi / M * (np.arange(0, M) + 0.5))
    return _truncate(w, needs_trunc)


def lanczos(M: int, sym: bool = True) -> np.ndarray:
    """Lanczos (sinc) window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    w = np.sinc(2 * np.arange(M) / (M - 1) - 1.0)
    return _truncate(w, needs_trunc)


def kaiser(M: int, beta: float, sym: bool = True) -> np.ndarray:
    """Kaiser window (I0 Bessel family)."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M)
    alpha = (M - 1) / 2.0
    w = (np.i0(beta * np.sqrt(1 - ((n - alpha) / alpha) ** 2.0))
         / np.i0(beta))
    return _truncate(w, needs_trunc)


def kaiser_bessel_derived(M: int, beta: float,
                          sym: bool = True) -> np.ndarray:
    """Kaiser-Bessel derived (KBD) window — MDCT analysis window.
    Even length, symmetric only (scipy's contract)."""
    if not sym:
        raise PlanError("Kaiser-Bessel Derived windows are only defined "
                        "for symmetric shapes")
    if M < 1:
        return np.array([])
    if M % 2:
        raise PlanError("Kaiser-Bessel Derived windows are only defined "
                        "for even number of points")
    kaiser_w = kaiser(M // 2 + 1, beta)
    csum = np.cumsum(kaiser_w)
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate((half, half[::-1]))


def gaussian(M: int, std: float, sym: bool = True) -> np.ndarray:
    """Gaussian window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M) - (M - 1.0) / 2.0
    sig2 = 2 * std * std
    w = np.exp(-n ** 2 / sig2)
    return _truncate(w, needs_trunc)


def general_gaussian(M: int, p: float, sig: float,
                     sym: bool = True) -> np.ndarray:
    """Generalized Gaussian: exp(-0.5 |n/sig|^(2p))."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M) - (M - 1.0) / 2.0
    w = np.exp(-0.5 * np.abs(n / sig) ** (2 * p))
    return _truncate(w, needs_trunc)


def chebwin(M: int, at: float, sym: bool = True) -> np.ndarray:
    """Dolph-Chebyshev window with ``at`` dB of sidelobe attenuation
    (frequency-domain Chebyshev construction + inverse DFT)."""
    import warnings
    if np.abs(at) < 45:
        warnings.warn("This window is not suitable for spectral analysis "
                      "for attenuation values lower than about 45dB "
                      "because the equivalent noise bandwidth of a "
                      "Chebyshev window does not grow monotonically with "
                      "increasing sidelobe attenuation when the "
                      "attenuation is smaller than about 45 dB.",
                      stacklevel=2)
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    order = M - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (np.abs(at) / 20.0)))
    k = np.r_[0:M] * 1.0
    x = beta * np.cos(np.pi * k / M)
    # Chebyshev polynomial of degree `order` evaluated piecewise
    p = np.zeros(x.shape)
    p[x > 1] = np.cosh(order * np.arccosh(x[x > 1]))
    p[x < -1] = (2 * (M % 2) - 1) * np.cosh(order * np.arccosh(-x[x < -1]))
    p[np.abs(x) <= 1] = np.cos(order * np.arccos(p[np.abs(x) <= 1] * 0
                                                 + x[np.abs(x) <= 1]))
    if M % 2:
        w = np.real(np.fft.fft(p))
        n = (M + 1) // 2
        w = w[:n]
        w = np.concatenate((w[n - 1:0:-1], w))
    else:
        p = p * np.exp(1.0j * np.pi / M * np.r_[0:M])
        w = np.real(np.fft.fft(p))
        n = M // 2 + 1
        w = np.concatenate((w[n - 1:0:-1], w[1:n]))
    w = w / max(w)
    return _truncate(w, needs_trunc)


def exponential(M: int, center: Optional[float] = None, tau: float = 1.0,
                sym: bool = True) -> np.ndarray:
    """Exponential (Poisson) window."""
    if sym and center is not None:
        raise PlanError("If sym==True, center must be None.")
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    if center is None:
        center = (M - 1) / 2
    n = np.arange(0, M)
    w = np.exp(-np.abs(n - center) / tau)
    return _truncate(w, needs_trunc)


def tukey(M: int, alpha: float = 0.5, sym: bool = True) -> np.ndarray:
    """Tukey (tapered cosine) window."""
    if _len_guards(M):
        return np.ones(M)
    if alpha <= 0:
        return np.ones(M, "d")
    if alpha >= 1.0:
        return hann(M, sym=sym)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M)
    width = int(np.floor(alpha * (M - 1) / 2.0))
    n1 = n[0:width + 1]
    n2 = n[width + 1:M - width - 1]
    n3 = n[M - width - 1:]
    w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (M - 1))))
    w2 = np.ones(n2.shape)
    w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1
                                    + 2.0 * n3 / alpha / (M - 1))))
    w = np.concatenate((w1, w2, w3))
    return _truncate(w, needs_trunc)


def taylor(M: int, nbar: int = 4, sll: float = 30,
           norm: bool = True, sym: bool = True) -> np.ndarray:
    """Taylor window (radar/antenna tapering; ``sll`` dB sidelobe
    level, ``nbar`` nearly-constant-level sidelobes)."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    B = 10 ** (sll / 20)
    A = np.arccosh(B) / np.pi
    s2 = nbar ** 2 / (A ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar)
    Fm = np.empty(nbar - 1)
    signs = np.empty_like(ma)
    signs[::2] = 1
    signs[1::2] = -1
    m2 = ma * ma
    for mi, _ in enumerate(ma):
        numer = signs[mi] * np.prod(
            1 - m2[mi] / s2 / (A ** 2 + (ma - 0.5) ** 2))
        denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) \
            * np.prod(1 - m2[mi] / m2[mi + 1:])
        Fm[mi] = numer / denom

    def W(n):
        return 1 + 2 * np.dot(
            Fm, np.cos(2 * np.pi * ma[:, None]
                       * (n - M / 2.0 + 0.5) / M))

    w = W(np.arange(M))
    if norm:
        scale = 1.0 / W((M - 1) / 2)
        w *= scale
    return _truncate(w, needs_trunc)


def dpss(M: int, NW: float, Kmax: Optional[int] = None,
         sym: bool = True, norm: Optional[str] = None,
         return_ratios: bool = False):
    """Discrete prolate spheroidal (Slepian) sequences
    (scipy.signal.windows.dpss semantics): eigenvectors of the
    tridiagonal concentration operator, sign-standardized, with the
    eigenvalue concentration ratios on request."""
    from scipy.linalg import eigh_tridiagonal
    if _len_guards(M):
        return np.ones(M)
    if norm is None:
        norm = "approximate" if Kmax is None else 2
    known_norms = (2, "approximate", "subsample")
    if norm not in known_norms:
        raise PlanError(f"norm must be one of {known_norms}")
    if Kmax is None:
        singleton = True
        Kmax = 1
    else:
        singleton = False
        Kmax = int(Kmax)
    if not 0 < Kmax <= M:
        raise PlanError("Kmax must be greater than 0 and less than M")
    if NW >= M / 2.0:
        raise PlanError("NW must be less than M/2.")
    if NW <= 0:
        raise PlanError("NW must be positive")
    M, needs_trunc = _extend(M, sym)
    W = float(NW) / M
    nidx = np.arange(M)
    d = ((M - 1 - 2 * nidx) / 2.0) ** 2 * np.cos(2 * np.pi * W)
    e = nidx[1:] * (M - nidx[1:]) / 2.0
    w, windows = eigh_tridiagonal(
        d, e, select="i", select_range=(M - Kmax, M - 1))
    w = w[::-1]
    windows = windows[:, ::-1].T
    # sign conventions: symmetric tapers positive mean; antisymmetric
    # tapers positive first lobe
    fix_even = windows[::2].sum(axis=1) < 0
    for i, f in enumerate(fix_even):
        if f:
            windows[2 * i] *= -1
    thresh = max(1e-7, 1.0 / M)
    for i, wi in enumerate(windows[1::2]):
        if wi[wi * wi > thresh][0] < 0:
            windows[2 * i + 1] *= -1
    # concentration ratios via the autocorrelation inner product
    if return_ratios:
        dpss_rxx = _fftautocorr(windows)
        r = 4 * W * np.sinc(2 * W * nidx)
        r[0] = 2 * W
        ratios = np.dot(dpss_rxx, r)
        if singleton:
            ratios = ratios[0]
    if norm != 2:
        windows /= windows.max()
        if M % 2 == 0:
            if norm == "approximate":
                correction = M ** 2 / float(M ** 2 + float(NW))
            else:
                s = np.fft.rfft(windows[0])
                shift = -(1 - 1.0 / M) * np.arange(1, M // 2 + 1)
                s[1:] *= 2 * np.exp(-1j * np.pi * shift)
                correction = M / s.real.sum()
            windows *= correction
    windows = _truncate(windows.T, needs_trunc).T
    if singleton:
        windows = windows[0]
    return (windows, ratios) if return_ratios else windows


def _fftautocorr(x: np.ndarray) -> np.ndarray:
    """Row-wise autocorrelation via rfft (host helper for dpss)."""
    N = x.shape[-1]
    use_N = 1 << int(np.ceil(np.log2(2 * N - 1)))
    x_fft = np.fft.rfft(x, use_N, axis=-1)
    cxy = np.fft.irfft(x_fft * np.conj(x_fft), n=use_N)[:, :N]
    return cxy


_WIN_ALIASES = {
    "boxcar": boxcar, "box": boxcar, "ones": boxcar, "rect": boxcar,
    "rectangular": boxcar,
    "triang": triang, "triangle": triang, "tri": triang,
    "parzen": parzen, "parz": parzen, "par": parzen,
    "bohman": bohman, "bman": bohman, "bmn": bohman,
    "blackman": blackman, "black": blackman, "blk": blackman,
    "nuttall": nuttall, "nutl": nuttall, "nut": nuttall,
    "blackmanharris": blackmanharris, "blackharr": blackmanharris,
    "bkh": blackmanharris,
    "flattop": flattop, "flat": flattop, "flt": flattop,
    "bartlett": bartlett, "bart": bartlett, "brt": bartlett,
    "barthann": barthann, "brthan": barthann, "bth": barthann,
    "hamming": hamming, "hamm": hamming, "ham": hamming,
    "hann": hann, "han": hann,
    "cosine": cosine, "halfcosine": cosine,
    "lanczos": lanczos, "sinc": lanczos,
}

_WIN_PARAM = {
    "kaiser": (kaiser, 1), "ksr": (kaiser, 1),
    "kaiser_bessel_derived": (kaiser_bessel_derived, 1),
    "kbd": (kaiser_bessel_derived, 1),
    "gaussian": (gaussian, 1), "gauss": (gaussian, 1),
    "gss": (gaussian, 1),
    "general_gaussian": (general_gaussian, 2),
    "general gaussian": (general_gaussian, 2),
    "general_gauss": (general_gaussian, 2),
    "ggs": (general_gaussian, 2),
    "general_cosine": (general_cosine, 1),
    "general cosine": (general_cosine, 1),
    "general_hamming": (general_hamming, 1),
    "general hamming": (general_hamming, 1),
    "chebwin": (chebwin, 1), "cheb": (chebwin, 1),
    "exponential": (exponential, -1), "poisson": (exponential, -1),
    "tukey": (tukey, -1), "tuk": (tukey, -1),
    "taylor": (taylor, -1), "taylorwin": (taylor, -1),
    "dpss": (dpss, -1),
}


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """scipy.signal.get_window semantics: name/alias strings,
    ``(name, *params)`` tuples, a bare float meaning kaiser beta;
    ``fftbins=True`` gives the periodic variant."""
    sym = not fftbins
    if isinstance(window, (float, int, np.floating, np.integer)) \
            and not isinstance(window, bool):
        return kaiser(int(Nx), float(window), sym)
    if isinstance(window, tuple):
        name = window[0]
        args = window[1:]
    elif isinstance(window, str):
        name = window
        args = ()
    else:
        raise PlanError(f"{window!r} is not a recognized window "
                        "specification")
    if not isinstance(name, str):
        raise PlanError("window tuple must start with a name string")
    key = name.lower()
    if key in _WIN_ALIASES:
        if args:
            raise PlanError(f"window '{name}' takes no parameters")
        return _WIN_ALIASES[key](int(Nx), sym=sym)
    if key in _WIN_PARAM:
        fn, nargs = _WIN_PARAM[key]
        if nargs >= 0 and len(args) != nargs:
            raise PlanError(f"window '{name}' needs {nargs} "
                            f"parameter(s), got {len(args)}")
        return np.asarray(fn(int(Nx), *args, sym=sym))
    raise PlanError(f"Unknown window type '{name}'")
