"""scipy.fftpack.convolve parity: packed-spectrum convolution kernels.

Port of ``webgpufft_tpu/fftpack_convolve.py``, exposed as
``webgpufft_tpu_torch.fftpack.convolve`` (attribute and importable
submodule), mirroring scipy's legacy Fortran-backed module.  The
installed scipy extension is compiled, so the packed-domain semantics
were reconstructed empirically by matrix-probing the operator:

- ``init_convolution_kernel(n, f, d, ...)`` returns the length-``n``
  packed omega table ``[om_0, a_1, b_1, a_2, b_2, ..., (om_nyq)]`` with
  the 1/n inverse-transform normalization folded in: ``om_0 = f(0)/n``
  always (no i^d at DC); for k >= 1 the pair carries i^d * f(k)/n as
  ``(t, t)`` with t = (-1)^(d/2) for even d and ``(s, -s)`` with
  s = (-1)^((d-1)/2) for odd d; the Nyquist slot (even n) takes the
  pair's leading sign and is zeroed when ``zero_nyquist`` (default
  ``d % 2``).
- ``convolve(x, omega)`` applies ``omega`` slot-wise to the packed real
  spectrum of x — the re/im slots of each bin are scaled independently
  (NOT a complex multiply).  ``swap_real_imag`` swaps the two slots of
  every pair after the multiply; DC and Nyquist are multiplied
  normally.  Combined with an odd-d omega this realizes multiplication
  by i^d f(k), which is how scipy's diff/tilbert family uses it.
- ``convolve_z(x, omega_real, omega_imag)`` is the sum of the plain
  omega_real operator and the swapped omega_imag operator (verified
  identity against scipy).

The device path is a plain function: plan rfft -> bilinear slot multiply
-> plan irfft; the slot tables are built on the host in f64.  A tensor
input runs where it lives, anything else on the facade's default device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import fftapi

__all__ = [
    "init_convolution_kernel", "convolve", "convolve_z",
    "destroy_convolve_cache",
]

def _apply(x, p, q, r, s):
    """rfft -> independent-slot bilinear multiply -> irfft (the general
    packed-kernel apply)."""
    half = fftapi.rfft(x)                  # (..., n//2+1, 2)
    re, im = half[..., 0], half[..., 1]
    out = torch.stack([p * re + q * im, r * re + s * im], -1)
    return fftapi.irfft(out, n=x.shape[-1], interleaved=True)


def destroy_convolve_cache():
    """scipy.fftpack.convolve.destroy_convolve_cache parity.  scipy clears
    its Fortran work arrays; the port keeps none (the plans live in the
    package's plan cache), so there is nothing to drop."""


def init_convolution_kernel(n: int, kernel_func: Callable, d: int = 0,
                            zero_nyquist: Optional[int] = None,
                            kernel_func_extra_args: tuple = ()):
    """Build the packed convolution kernel omega for ``convolve``
    (scipy.fftpack.convolve.init_convolution_kernel semantics: omega
    carries i^d * kernel_func(k) / n in packed slots; zero_nyquist
    defaults to ``d % 2``).  Returns a host float64 array like scipy."""
    n = int(n)
    if n < 1:
        raise ValueError("n must be a positive integer")
    d = int(d)
    # negative d is a real scipy path (integration kernels); Python's
    # floor division makes the sign formulas below match scipy there
    # too (probed d in [-4, 4], tests/test_fftpack.py)
    zn = (d % 2) if zero_nyquist is None else int(zero_nyquist)
    kmax = n // 2 if n % 2 == 0 else (n - 1) // 2
    f = np.array([float(kernel_func(k, *kernel_func_extra_args))
                  for k in range(kmax + 1)], dtype=np.float64)
    omega = np.empty(n, dtype=np.float64)
    omega[0] = f[0] / n
    if d % 2 == 0:
        a = b = ((-1.0) ** (d // 2)) * f[1:] / n
    else:
        a = ((-1.0) ** ((d - 1) // 2)) * f[1:] / n
        b = -a
    npairs = (n - 1) // 2
    omega[1:2 * npairs:2] = a[:npairs]
    omega[2:2 * npairs + 1:2] = b[:npairs]
    if n % 2 == 0:
        omega[-1] = 0.0 if zn else a[-1]
    return omega


def _slot_tables(omega: np.ndarray, n: int):
    """Packed omega (n,) -> per-half-bin (a, b) slot multipliers with
    the inverse normalization unfolded (times n), host f64."""
    nh = n // 2 + 1
    a = np.zeros(nh, dtype=np.float64)
    b = np.zeros(nh, dtype=np.float64)
    a[0] = b[0] = omega[0]
    npairs = (n - 1) // 2
    a[1:npairs + 1] = omega[1:2 * npairs:2]
    b[1:npairs + 1] = omega[2:2 * npairs + 1:2]
    if n % 2 == 0:
        a[-1] = b[-1] = omega[-1]
    return a * n, b * n


def _check_1d(name: str, x, omega):
    if getattr(x, "ndim", None) != 1 or omega.ndim != 1 \
            or x.shape[0] != omega.shape[0]:
        raise ValueError(
            f"{name} and omega must be 1-dimensional arrays of the same "
            "length")


def _bilinear(x, p, q, r, s):
    return _apply(x, *(fftapi._const(t, x) for t in (p, q, r, s)))


def _as_signal(x):
    return fftapi._f32(x)


def convolve(inout, omega, swap_real_imag: bool = False,
             overwrite_x: bool = False):
    """y = packed_irfft(omega (slot-wise) packed_rfft(x)); see the
    module docstring for the slot/swap semantics.  ``overwrite_x`` is
    accepted for signature parity and ignored (the input is never written)."""
    del overwrite_x
    omega = np.asarray(omega, dtype=np.float64)
    x = _as_signal(inout)
    _check_1d("inout", x, omega)
    n = int(omega.shape[0])
    a, b = _slot_tables(omega, n)
    nh = n // 2 + 1
    z = np.zeros(nh, dtype=np.float64)
    if not swap_real_imag:
        p, q, r, s = a, z, z, b
    else:
        # pairs swap slots; DC (and Nyquist, even n) multiply normally
        # and must stay in the real slot (their imag part is zero)
        p = z.copy()
        p[0] = a[0]
        q = b.copy()
        q[0] = 0.0
        r = a.copy()
        r[0] = 0.0
        if n % 2 == 0:
            p[-1] = a[-1]
            q[-1] = 0.0
            r[-1] = 0.0
        s = z
    return _bilinear(x, p, q, r, s)


def convolve_z(inout, omega_real, omega_imag, overwrite_x: bool = False):
    """y = convolve(x, omega_real) + convolve(x, omega_imag, swap=True)
    fused into one transform pair (scipy's convolve_z identity,
    verified empirically)."""
    del overwrite_x
    om_r = np.asarray(omega_real, dtype=np.float64)
    om_i = np.asarray(omega_imag, dtype=np.float64)
    x = _as_signal(inout)
    _check_1d("inout", x, om_r)
    _check_1d("inout", x, om_i)
    n = int(om_r.shape[0])
    ar, br = _slot_tables(om_r, n)
    ai, bi = _slot_tables(om_i, n)
    # plain(om_r): p += ar, s += br;  swapped(om_i): q += bi, r += ai
    # with DC/Nyquist of om_i folded into the real slot instead
    p = ar.copy()
    q = bi.copy()
    r = ai.copy()
    s = br
    p[0] += ai[0]
    q[0] = 0.0
    r[0] = 0.0
    if n % 2 == 0:
        p[-1] += ai[-1]
        q[-1] = 0.0
        r[-1] = 0.0
    return _bilinear(x, p, q, r, s)
