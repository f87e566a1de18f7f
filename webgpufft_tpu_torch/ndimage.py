"""scipy.ndimage-style Fourier-domain filters on the facade's layout.

Port of ``webgpufft_tpu/ndimage.py``, the port's own copy.  These operate
on an array that is ALREADY in the Fourier domain (the output of
``fft``/``rfft``), multiplying it elementwise by the transfer function of
the named spatial filter — ``scipy.ndimage.fourier_*`` semantics, pinned
against scipy and the JAX package in tests/test_torch_ndimage.py.

Conventions:

- ``n < 0`` (default): the input is a full complex FFT; the frequency
  grid along every axis ``ax`` is ``fftfreq(shape[ax])``.
- ``n >= 0``: the input along ``axis`` comes from an rfft of length
  ``n``, so that axis uses ``arange(shape[axis]) / n``; all other axes
  keep the full-FFT grid.
- Real-valued filters (gaussian / uniform / ellipsoid) preserve the
  input's representation: a real array in, a real float32 tensor out; a
  complex / interleaved array in, interleaved (..., 2) float32 out.
  ``fourier_shift`` has a complex transfer function and always returns
  interleaved output.

All tables are computed on the host in float64 and multiplied into the
spectrum on its device (a tensor where it lives, anything else on the
facade's default device) as float32 broadcast multiplies (``fftapi._const``);
the separable filters stay separable (one rank-1 table per axis), and the
ellipsoid's non-separable radial table is made once at the filtered grid's
size.  A real input is multiplied as it is: the zero imaginary part the
JAX package carries through the multiplies would be dropped at the end.
"""

from __future__ import annotations

import numpy as np

from . import fftapi
from .core.cplx import cmul_t4, to_t4
from .spec import PlanError

__all__ = [
    "fourier_gaussian",
    "fourier_uniform",
    "fourier_ellipsoid",
    "fourier_shift",
]


def _params_per_axis(value, rank: int, name: str) -> np.ndarray:
    """Broadcast a scalar-or-sequence filter parameter to one per axis."""
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0:
        return np.full((rank,), float(arr))
    if arr.shape != (rank,):
        raise PlanError(
            f"{name} must be a scalar or a length-{rank} sequence, got "
            f"shape {tuple(arr.shape)}")
    return arr


def _prep(input, n: int, axis: int, keep_real: bool = True):
    """Coerce the input (a real one stays real when ``keep_real``),
    resolve the rfft axis, and build per-axis frequency grids.  Returns
    (x, was_real, rank, freqs); an interleaved x carries the component dim
    last."""
    if fftapi._is_complex(input):
        was_real = False
        x = fftapi.asinterleaved(input)
    else:
        x = fftapi._f32(input)
        # same trailing-dim-2 inference the rest of the facade uses
        was_real = not (x.ndim >= 2 and x.shape[-1] == 2)
        if not (was_real and keep_real):
            x = fftapi.asinterleaved(x)
    rank = x.ndim - (0 if was_real and keep_real else 1)
    if rank < 1:
        raise PlanError("fourier filters need at least one data axis")
    ax = axis + rank if axis < 0 else axis
    if not 0 <= ax < rank:
        raise PlanError(f"axis {axis} out of range for rank {rank}")
    freqs = []
    for a in range(rank):
        m = x.shape[a]
        if n >= 0 and a == ax:
            freqs.append(np.arange(m, dtype=np.float64) / max(n, 1))
        else:
            freqs.append(np.fft.fftfreq(m))
    return x, was_real, rank, freqs


def _bcast(table: np.ndarray, a: int, ndim: int) -> np.ndarray:
    """Reshape a rank-1 axis table for broadcasting over ``ndim`` dims."""
    shape = [1] * ndim
    shape[a] = table.shape[0]
    return table.reshape(shape)


def _apply_real_tables(x, tables):
    for a, t in enumerate(tables):
        x = x * fftapi._const(_bcast(t, a, x.ndim), x)
    return x


def fourier_gaussian(input, sigma, n: int = -1, axis: int = -1):
    """Multidimensional Gaussian Fourier filter
    (scipy.ndimage.fourier_gaussian): multiply the spectrum by
    ``exp(-2 pi^2 sigma_a^2 f_a^2)`` per axis."""
    x, _, rank, freqs = _prep(input, n, axis)
    sig = _params_per_axis(sigma, rank, "sigma")
    return _apply_real_tables(x, [np.exp(-2.0 * np.pi ** 2 * sig[a] ** 2 * freqs[a] ** 2)
                                  for a in range(rank)])


def fourier_uniform(input, size, n: int = -1, axis: int = -1):
    """Multidimensional uniform (box) Fourier filter
    (scipy.ndimage.fourier_uniform): multiply by ``sinc(size_a f_a)``
    per axis — the transform of a width-``size`` box."""
    x, _, rank, freqs = _prep(input, n, axis)
    siz = _params_per_axis(size, rank, "size")
    return _apply_real_tables(x, [np.sinc(siz[a] * freqs[a]) for a in range(rank)])


def fourier_ellipsoid(input, size, n: int = -1, axis: int = -1):
    """Multidimensional ellipsoid Fourier filter
    (scipy.ndimage.fourier_ellipsoid): multiply by the transform of an
    ellipsoid with diameters ``size``.  Like scipy, implemented for rank
    1 (sinc), 2 (jinc, needs scipy.special) and 3 (spherical bessel)."""
    x, was_real, rank, freqs = _prep(input, n, axis)
    siz = _params_per_axis(size, rank, "size")
    if rank == 1:
        return _apply_real_tables(x, [np.sinc(siz[0] * freqs[0])])
    if rank > 3:
        raise PlanError(
            "fourier_ellipsoid is only implemented for rank 1, 2 and 3 "
            "(matching scipy.ndimage)")
    # non-separable radial argument u = 2*pi*sqrt(sum (size_a/2 * f_a)^2)
    sq = np.zeros(tuple(len(f) for f in freqs))
    for a in range(rank):
        shape = [1] * rank
        shape[a] = len(freqs[a])
        sq = sq + (0.5 * siz[a] * freqs[a].reshape(shape)) ** 2
    u = 2.0 * np.pi * np.sqrt(sq)
    with np.errstate(invalid="ignore", divide="ignore"):
        if rank == 2:
            try:
                from scipy.special import j1
            except ImportError as e:  # pragma: no cover
                raise PlanError(
                    "rank-2 fourier_ellipsoid needs scipy for the Bessel "
                    "J1 table") from e
            table = np.where(u == 0.0, 1.0, 2.0 * j1(u) / np.where(u == 0, 1, u))
        else:
            table = np.where(
                u == 0.0, 1.0,
                3.0 * (np.sin(u) - u * np.cos(u)) / np.where(u == 0, 1, u) ** 3)
    t = fftapi._const(table, x)
    return x * (t if was_real else t[..., None])


def fourier_shift(input, shift, n: int = -1, axis: int = -1):
    """Multidimensional Fourier shift filter
    (scipy.ndimage.fourier_shift): multiply by
    ``exp(-2j pi shift_a f_a)`` per axis.  Always returns interleaved
    complex output (the transfer function is complex)."""
    x, _, rank, freqs = _prep(input, n, axis, keep_real=False)
    sh = _params_per_axis(shift, rank, "shift")
    for a in range(rank):
        t4 = to_t4(np.exp(-2j * np.pi * sh[a] * freqs[a]))  # (m, 2, 2)
        shape = [1] * rank + [2, 2]
        shape[a] = t4.shape[0]
        x = cmul_t4(x, fftapi._const(t4.reshape(shape), x))
    return x
