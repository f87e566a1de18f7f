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
