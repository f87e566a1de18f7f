"""scipy.fftpack-compatible legacy namespace over the plan layer.
Port of ``webgpufft_tpu/fftpack.py``.

The legacy FFT interface differs from scipy.fft in exactly the ways this
module reproduces:

- ``rfft``/``irfft`` use the PACKED real format
  ``[y0, Re1, Im1, Re2, Im2, ...]`` (n elements, not n//2+1 complex);
  ``rfftfreq`` returns the matching n-element packed frequency vector.
- ``idct``/``idst`` with ``norm=None`` are UNNORMALIZED inverses (the
  scipy.fft equivalent of ``norm="forward"`` on the inverse side).
- ``fftn``/``ifftn`` take ``shape=`` instead of ``s=``.
- The pseudo-differential operator family (``diff``, ``tilbert``/
  ``itilbert``, ``hilbert``/``ihilbert``, ``sc_diff``/``cs_diff``/
  ``cc_diff``/``ss_diff``, ``shift``) — periodic-sequence Fourier
  multipliers, computed here on the half spectrum via the plan layer's
  rfft/irfft with host-f64 multiplier tables.
- The ``convolve`` submodule (``init_convolution_kernel``/``convolve``/
  ``convolve_z``/``destroy_convolve_cache``) with scipy's packed-slot
  kernel conventions (see fftpack_convolve.py); importable as
  ``webgpufft_tpu_torch.fftpack.convolve`` like scipy's.

``overwrite_x`` is accepted and ignored everywhere (the plan layer never
mutates inputs).  ``next_fast_len`` returns the package's plan-fast
lengths, like webgpufft_tpu_torch.fft's (radix set includes 13), not
fftpack's 5-smooth sizes.

The namespace is functions, so it has nothing to construct a device into:
it follows the facade's rule.  A tensor runs where it lives; numpy input is
placed on the facade's default device (``"cuda"``, or what an enclosing
``fftapi.default_device(...)`` block names).  Results are torch tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import fftapi

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfftfreq",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "diff", "tilbert", "itilbert", "hilbert", "ihilbert",
    "sc_diff", "cs_diff", "cc_diff", "ss_diff", "shift",
    "fftfreq", "fftshift", "ifftshift", "next_fast_len",
    "convolve",
]

fftfreq = fftapi.fftfreq
fftshift = fftapi.fftshift
ifftshift = fftapi.ifftshift
next_fast_len = fftapi.next_fast_len

# scipy.fftpack.convolve is a submodule; mirror both access forms
# (attribute and `import webgpufft_tpu_torch.fftpack.convolve`)
from . import fftpack_convolve as convolve  # noqa: E402

import sys as _sys  # noqa: E402

_sys.modules[__name__ + ".convolve"] = convolve


# ------------------------------------------------------------- complex fft

def fft(x, n: Optional[int] = None, axis: int = -1, overwrite_x: bool = False):
    return fftapi.fft(x, n=n, axis=axis)


def ifft(x, n: Optional[int] = None, axis: int = -1, overwrite_x: bool = False):
    return fftapi.ifft(x, n=n, axis=axis)


def _legacy_shape(x, shape, axes):
    """Legacy shape=/axes= semantics: -1 entries keep the axis length, and
    a shape/axes rank mismatch is an error (scipy.fft instead interprets a
    short s= as 'the last len(s) axes' — legacy code relies on the raise).
    Duplicate axes raise like scipy.fftpack (the facade underneath follows
    numpy's transform-per-occurrence instead).  ALL rank logic here uses
    the COMPLEX rank: interleaved (..., 2) real inputs exclude the
    component dim (matching what the facade transforms)."""
    xshape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
    nd = len(xshape)
    if not fftapi._is_complex(x) and nd >= 2 and xshape[-1] == 2:
        nd -= 1       # the facade treats trailing-2 reals as interleaved
        xshape = xshape[:-1]
    if axes is not None and np.ndim(axes) > 0:
        t = tuple(int(a) + nd if int(a) < 0 else int(a)
                  for a in np.atleast_1d(axes))
        if len(set(t)) != len(t):
            raise ValueError("all axes must be unique")
    if shape is None:
        return None, axes
    shape = tuple(int(s) for s in np.atleast_1d(shape))
    if axes is None:
        if len(shape) != nd:
            raise ValueError(
                "when given, axes and shape arguments have to be of the "
                "same length")
        axes = tuple(range(nd))
    else:
        axes = tuple(int(a) for a in np.atleast_1d(axes))
        if len(shape) != len(axes):
            raise ValueError(
                "when given, axes and shape arguments have to be of the "
                "same length")
    resolved = tuple(xshape[a] if s == -1 else s
                     for s, a in zip(shape, axes))
    return resolved, axes


def fft2(x, shape=None, axes=(-2, -1), overwrite_x: bool = False):
    s, axes2 = _legacy_shape(x, shape, axes)
    return fftapi.fft2(x, s=s, axes=axes2)


def ifft2(x, shape=None, axes=(-2, -1), overwrite_x: bool = False):
    s, axes2 = _legacy_shape(x, shape, axes)
    return fftapi.ifft2(x, s=s, axes=axes2)


def fftn(x, shape=None, axes=None, overwrite_x: bool = False):
    s, axes2 = _legacy_shape(x, shape, axes)
    return fftapi.fftn(x, s=s, axes=axes2)


def ifftn(x, shape=None, axes=None, overwrite_x: bool = False):
    s, axes2 = _legacy_shape(x, shape, axes)
    return fftapi.ifftn(x, s=s, axes=axes2)


# ------------------------------------------------------- packed real fft

def rfft(x, n: Optional[int] = None, axis: int = -1,
         overwrite_x: bool = False):
    """Packed-format real FFT: [y0, Re1, Im1, ..., (Re_nyq)] — n entries."""
    x = fftapi._f32(x)
    half = fftapi.rfft(x, n=n, axis=axis)          # (..., n//2+1, 2)
    half = torch.movedim(half, axis if axis >= 0 else axis - 1, -2)
    m = n if n is not None else x.shape[axis]
    core = half[..., 1:, :].reshape(*half.shape[:-2], -1)  # Re1 Im1 Re2 ...
    packed = torch.cat([half[..., 0, :1], core], dim=-1)
    packed = packed[..., :m]     # even n: drop Im_nyq (zero); odd: keep Im
    return torch.movedim(packed, -1, axis)


def irfft(x, n: Optional[int] = None, axis: int = -1,
          overwrite_x: bool = False):
    """Inverse of the packed-format real FFT."""
    x = torch.movedim(fftapi._f32(x), axis, -1)
    m = int(n if n is not None else x.shape[-1])
    if x.shape[-1] > m:          # legacy n=: crop/pad the PACKED spectrum
        x = x[..., :m]
    elif x.shape[-1] < m:
        x = fftapi._zero_pad(x, -1, 0, m - x.shape[-1])
    nh = m // 2 + 1
    body = x[..., 1:]
    if m % 2 == 0:
        # even n: the packed form omits Im_nyq (it is zero); restore it
        body = fftapi._zero_pad(body, -1, 0, 1)
    body = body.reshape(*body.shape[:-1], nh - 1, 2)
    head = torch.stack([x[..., 0], torch.zeros_like(x[..., 0])], -1)[..., None, :]
    half = torch.cat([head, body], dim=-2)          # (..., nh, 2)
    y = fftapi.irfft(half, n=m, axis=-1, interleaved=True)
    return torch.movedim(y, -1, axis)


def rfftfreq(n: int, d: float = 1.0):
    """Packed-order frequencies: [0, 1, 1, 2, 2, ...] / (n*d) — n entries."""
    if not isinstance(n, (int, np.integer)):
        raise TypeError(f"n should be an integer, got {type(n).__name__}")
    if n < 0:
        raise ValueError(f"n = {n} is not valid. "
                         "n must be a nonnegative integer.")
    j = np.arange(n)
    return np.ceil(j / 2.0) / (n * d)


# ---------------------------------------------------------------- dct/dst

def dct(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None, overwrite_x: bool = False):
    return fftapi.dct(x, type=type, n=n, axis=axis, norm=norm)


def idct(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, overwrite_x: bool = False):
    # legacy norm=None inverse is UNNORMALIZED (scipy.fft norm="forward")
    return fftapi.idct(x, type=type, n=n, axis=axis,
                       norm="forward" if norm is None else norm)


def dst(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None, overwrite_x: bool = False):
    return fftapi.dst(x, type=type, n=n, axis=axis, norm=norm)


def idst(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, overwrite_x: bool = False):
    return fftapi.idst(x, type=type, n=n, axis=axis,
                       norm="forward" if norm is None else norm)


def dctn(x, type: int = 2, shape=None, axes=None,
         norm: Optional[str] = None, overwrite_x: bool = False):
    s, axes2 = _legacy_shape(x, shape, axes)
    return fftapi.dctn(x, type=type, s=s, axes=axes2, norm=norm)


def idctn(x, type: int = 2, shape=None, axes=None,
          norm: Optional[str] = None, overwrite_x: bool = False):
    s, axes2 = _legacy_shape(x, shape, axes)
    return fftapi.idctn(x, type=type, s=s, axes=axes2,
                        norm="forward" if norm is None else norm)


def dstn(x, type: int = 2, shape=None, axes=None,
         norm: Optional[str] = None, overwrite_x: bool = False):
    s, axes2 = _legacy_shape(x, shape, axes)
    return fftapi.dstn(x, type=type, s=s, axes=axes2, norm=norm)


def idstn(x, type: int = 2, shape=None, axes=None,
          norm: Optional[str] = None, overwrite_x: bool = False):
    s, axes2 = _legacy_shape(x, shape, axes)
    return fftapi.idstn(x, type=type, s=s, axes=axes2,
                        norm="forward" if norm is None else norm)


# ----------------------------------------- pseudo-differential operators

# multiplier tables cached per (n, operator, params) — scipy's fftpack
# caches its convolution kernels the same way (its _cache dicts)
_MULT_CACHE: dict = {}
_MULT_CACHE_MAX = 256


def _apply(x, mr, mi):
    """rfft -> complex multiply -> irfft along the last axis."""
    half = fftapi.rfft(x)                  # (..., n//2+1, 2)
    yr = half[..., 0] * mr - half[..., 1] * mi
    yi = half[..., 0] * mi + half[..., 1] * mr
    return fftapi.irfft(torch.stack([yr, yi], -1), n=x.shape[-1],
                        interleaved=True)


def _multiplier_apply(x, key, mfun, dc, nyquist: str = "real"):
    """y = irfft(m(w) * rfft(x)) for a periodic sequence along the last
    axis; ``mfun(w)`` maps positive angular harmonics w = 2*pi*k/period
    to complex multipliers (host f64 tables cached under ``key``),
    ``dc`` is the k=0 value.

    ``nyquist`` reproduces fftpack's per-kernel zero_nyquist flags for
    even n (probed empirically against scipy): "real" keeps
    Re(m) (imaginary kernels zero there — hilbert/tilbert family),
    "zero" drops the bin (diff does for every order), "sum" keeps
    Re(m)+Im(m) (shift applies both its cos and sin kernels there)."""
    x = fftapi._f32(x)
    n = x.shape[-1]
    ck = (n, nyquist) + key
    tab = _MULT_CACHE.get(ck)
    if tab is None:
        k = np.arange(1, n // 2 + 1, dtype=np.float64)
        m = np.asarray(mfun(k), np.complex128)
        m = np.concatenate([[complex(dc)], m])
        if n % 2 == 0:
            if nyquist == "zero":
                m[-1] = 0.0
            elif nyquist == "sum":
                m[-1] = m[-1].real + m[-1].imag
            else:
                m[-1] = m[-1].real
        if len(_MULT_CACHE) >= _MULT_CACHE_MAX:
            _MULT_CACHE.clear()
        tab = (np.asarray(m.real, np.float32), np.asarray(m.imag, np.float32))
        _MULT_CACHE[ck] = tab
    return _apply(x, fftapi._const(tab[0], x), fftapi._const(tab[1], x))


def _w(period: Optional[float]):
    p = 2 * math.pi if period is None else float(period)
    return 2 * math.pi / p


def diff(x, order: int = 1, period: Optional[float] = None):
    """order-th spectral derivative of a periodic sequence."""
    if order == 0:
        return fftapi._f32(x)
    c = _w(period)
    return _multiplier_apply(x, ("diff", order, c),
                             lambda k: (1j * c * k) ** order, 0.0,
                             nyquist="zero")


def tilbert(x, h: float, period: Optional[float] = None):
    """y_k = i*coth(k*h*2pi/period) x_k (k=0 -> 0)."""
    c = _w(period) * float(h)
    return _multiplier_apply(x, ("tilbert", c),
                             lambda k: 1j / np.tanh(c * k), 0.0)


def itilbert(x, h: float, period: Optional[float] = None):
    """y_k = -i*tanh(k*h*2pi/period) x_k (the inverse of tilbert)."""
    c = _w(period) * float(h)
    return _multiplier_apply(x, ("itilbert", c),
                             lambda k: -1j * np.tanh(c * k), 0.0)


def hilbert(x, _cache=None):
    """y_k = i*sign(k) x_k (fftpack's sign convention; k=0 -> 0)."""
    return _multiplier_apply(x, ("hilbert",),
                             lambda k: np.full(k.shape, 1j), 0.0)


def ihilbert(x):
    """y_k = -i*sign(k) x_k."""
    return _multiplier_apply(x, ("ihilbert",),
                             lambda k: np.full(k.shape, -1j), 0.0)


def sc_diff(x, a: float, b: float, period: Optional[float] = None):
    """y_k = i*sinh(k*a*c)/cosh(k*b*c) x_k (k=0 -> 0)."""
    c = _w(period)
    return _multiplier_apply(
        x, ("sc", a, b, c),
        lambda k: 1j * np.sinh(a * c * k) / np.cosh(b * c * k), 0.0)


def cs_diff(x, a: float, b: float, period: Optional[float] = None):
    """y_k = -i*cosh(k*a*c)/sinh(k*b*c) x_k (k=0 -> 0)."""
    c = _w(period)
    return _multiplier_apply(
        x, ("cs", a, b, c),
        lambda k: -1j * np.cosh(a * c * k) / np.sinh(b * c * k), 0.0)


def cc_diff(x, a: float, b: float, period: Optional[float] = None):
    """y_k = cosh(k*a*c)/cosh(k*b*c) x_k (k=0 -> x_0)."""
    c = _w(period)
    return _multiplier_apply(
        x, ("cc", a, b, c),
        lambda k: np.cosh(a * c * k) / np.cosh(b * c * k), 1.0)


def ss_diff(x, a: float, b: float, period: Optional[float] = None):
    """y_k = sinh(k*a*c)/sinh(k*b*c) x_k (k=0 -> (a/b) x_0)."""
    c = _w(period)
    return _multiplier_apply(
        x, ("ss", a, b, c),
        lambda k: np.sinh(a * c * k) / np.sinh(b * c * k),
        float(a) / float(b))


def shift(x, a: float, period: Optional[float] = None):
    """y(t) = x(t + a) for a periodic sequence: y_k = exp(i*k*a*c) x_k."""
    c = _w(period) * float(a)
    return _multiplier_apply(x, ("shift", c),
                             lambda k: np.exp(1j * c * k), 1.0,
                             nyquist="sum")
