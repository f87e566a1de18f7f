"""Precomputed DFT/twiddle tables (numpy, float64 -> complex64).

Copied from ``webgpufft_tpu/core/dft.py`` so both packages build bitwise
identical tables.  All trig is computed on the host in float64 with exact
angle reduction; the device only ever sees the rounded f32 tables.
"""

from __future__ import annotations

import numpy as np


def dft_matrix(n: int, direction: str) -> np.ndarray:
    """Dense DFT matrix W[j, k] = exp(-+ 2*pi*i*j*k / n), complex64.

    out[k] = sum_j x[j] * W[j, k]  (apply as x @ W).
    """
    sign = -1.0 if direction == "forward" else 1.0
    j = np.arange(n, dtype=np.float64)
    # exact angle reduction: compute j*k mod n first to keep float64 exact
    jk = np.outer(j, j) % n
    return np.exp(sign * 2j * np.pi * jk / n).astype(np.complex64)


def ct_twiddle(n1: int, n2: int, direction: str) -> np.ndarray:
    """Cooley-Tukey inter-stage twiddle T[k1, m2] = exp(-+ 2*pi*i*k1*m2 / (n1*n2))."""
    n = n1 * n2
    sign = -1.0 if direction == "forward" else 1.0
    k1 = np.arange(n1, dtype=np.float64)
    m2 = np.arange(n2, dtype=np.float64)
    km = np.outer(k1, m2) % n
    return np.exp(sign * 2j * np.pi * km / n).astype(np.complex64)


def bluestein_chirp(n: int, direction: str) -> np.ndarray:
    """Chirp a[j] = exp(-+ i*pi*j^2 / n), complex128 (kept in f64 until use)."""
    sign = -1.0 if direction == "forward" else 1.0
    j = np.arange(n, dtype=np.float64)
    # j^2 mod 2n keeps the angle in [0, 2*pi) exactly for exact reduction
    jsq = (j * j) % (2 * n)
    return np.exp(sign * 1j * np.pi * jsq / n)


def bluestein_kernel_fft(n: int, m: int, direction: str) -> np.ndarray:
    """FFT of the wrapped Bluestein convolution kernel, scaled by 1/m.

    Kernel h[t] = exp(+- i*pi*t^2/n) placed at c[t] = h[t] (t in [0, n)) and
    c[m - t] = h[t] (t in [1, n)); the 1/m of the inverse M-FFT is folded in
    here so the device-side pipeline needs no extra normalization pass.
    Equivalent in role to the reference's on-device FFT(b) precompute
    (src/runtime/algorithms/bluestein_axis.js:126-134) but computed on host in
    float64 for accuracy.
    """
    h = np.conj(bluestein_chirp(n, direction))  # exp(+- i pi t^2 / n), sign opposite chirp
    c = np.zeros(m, dtype=np.complex128)
    c[:n] = h
    if n > 1:
        c[m - (n - 1):] = h[1:][::-1]
    return (np.fft.fft(c) / m).astype(np.complex64)


def rader_tables(p: int, direction: str):
    """Rader decomposition tables for prime p.

    Returns (perm_in, perm_out, bfft, m) where:
      - perm_in[i]  = g^i mod p           (gather indices for a[i] = x[perm_in[i]])
      - perm_out[j] = g^{-j} mod p        (scatter target bins: X[perm_out[j]] = x0 + conv[j])
      - bfft        = FFT of the wrapped b-sequence at length m, scaled 1/m
      - m           = smooth circular-convolution length (= p-1 when smooth,
                      else next smooth >= 2(p-1)-1 with wrapped kernel)

    b[i] = omega^{g^{-i} mod p}, omega = exp(-+ 2*pi*i/p)
    (reference mechanism: src/runtime/algorithms/rader_axis.js:51-74; tables
    here are host-precomputed in float64 instead of device kernels).
    """
    from ..utils.factors import primitive_root_prime, is_smooth, next_smooth_at_least

    g = primitive_root_prime(p)
    L = p - 1
    g_pows = np.ones(L, dtype=np.int64)
    for i in range(1, L):
        g_pows[i] = (g_pows[i - 1] * g) % p
    # g^{-i} = g^{L - i} (since g^L = 1)
    g_inv_pows = np.ones(L, dtype=np.int64)
    g_inv = g_pows[L - 1]  # g^{p-2} = g^{-1}
    for i in range(1, L):
        g_inv_pows[i] = (g_inv_pows[i - 1] * g_inv) % p

    sign = -1.0 if direction == "forward" else 1.0
    b = np.exp(sign * 2j * np.pi * g_inv_pows.astype(np.float64) / p)

    m = L if is_smooth(L) else next_smooth_at_least(2 * L - 1)
    if m == L:
        bfft = (np.fft.fft(b) / m).astype(np.complex64)
    else:
        # periodic kernel wrap: c[m - t] = b[(-t) mod L] = b[L - t], so the
        # tail c[m-(L-1):] is b[1:] in FORWARD order (unlike Bluestein's
        # symmetric kernel, which reverses)
        c = np.zeros(m, dtype=np.complex128)
        c[:L] = b
        c[m - (L - 1):] = b[1:]
        bfft = (np.fft.fft(c) / m).astype(np.complex64)
    return g_pows, g_inv_pows, bfft, m
