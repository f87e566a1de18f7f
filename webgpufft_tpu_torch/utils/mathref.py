"""numpy reference math, copied from ``webgpufft_tpu/utils/mathref.py``.

What the ported plan types need: the per-plan scale, the ND FFT oracle,
the packed r2c/c2r oracles, and the fftconv domain rule that
``spec.normalize_spec`` validates against.

Array convention: a plan with logical ``shape = [N0, N1, ...]`` operates on
arrays of shape ``(batch, N0, N1, ...)`` — logical axis d is array axis 1+d.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def normalize_scale(normalize: str, direction: str, n_total: int) -> float:
    """Per-plan scale factor."""
    if normalize == "none":
        return 1.0
    if normalize == "backward":
        return 1.0 / n_total if direction == "inverse" else 1.0
    if normalize == "unitary":
        return 1.0 / math.sqrt(n_total)
    raise ValueError(f"bad normalize {normalize!r}")


def fft_nd(x: np.ndarray, shape: Sequence[int], direction: str = "forward",
           normalize: str = "none") -> np.ndarray:
    """ND FFT over logical axes (array axes 1..rank); x is (batch, *shape)."""
    rank = len(shape)
    axes = tuple(range(x.ndim - rank, x.ndim))
    if direction == "forward":
        y = np.fft.fftn(x, axes=axes, norm=None)
    elif direction == "inverse":
        y = np.fft.ifftn(x, axes=axes, norm=None) * math.prod(shape)
    else:
        raise ValueError(f"bad direction {direction!r}")
    s = normalize_scale(normalize, direction, math.prod(shape))
    return y * s if s != 1.0 else y


# ---------------------------------------------------------------------------
# Real transforms: packing along logical axis 0 (array axis 1)
# ---------------------------------------------------------------------------

def r2c_packed(x: np.ndarray, shape: Sequence[int], normalize: str = "none") -> np.ndarray:
    """Real (batch, *shape) -> packed complex (batch, floor(N0/2)+1, N1, ...).

    Packed length = floor(N0/2)+1 along logical axis 0
    (reference: docs/API.md:203-208).
    """
    rank = len(shape)
    axes = tuple(range(1, 1 + rank))
    full = np.fft.fftn(x.astype(np.complex128), axes=axes, norm=None)
    n0 = shape[0]
    packed = full[:, : n0 // 2 + 1, ...]
    s = normalize_scale(normalize, "forward", math.prod(shape))
    return packed * s if s != 1.0 else packed


def c2r_packed(xp: np.ndarray, shape: Sequence[int], normalize: str = "none") -> np.ndarray:
    """Packed complex (batch, floor(N0/2)+1, ...) -> real (batch, *shape).

    Reconstructs the Hermitian spectrum with the reference's mirror rule
    X[N-k] = conj(X[k]) along axis 0 (src/utils/math.js:260-289).
    """
    rank = len(shape)
    n0 = shape[0]
    packed_len = n0 // 2 + 1
    assert xp.shape[1] == packed_len, (xp.shape, packed_len)
    k_max_mirror = n0 // 2 - 1 if n0 % 2 == 0 else n0 // 2
    # ND Hermitian symmetry: X[(N - k) mod N] = conj(X[k]) with the index map
    # applied on EVERY axis (axis 0 flips without wrap over the mirrored
    # range; other axes flip with wrap-around, i.e. flip + roll(1)).
    mirror = np.conj(xp[:, 1:k_max_mirror + 1, ...])[:, ::-1, ...]
    for d in range(2, xp.ndim):
        mirror = np.roll(np.flip(mirror, axis=d), 1, axis=d)
    full = np.concatenate([xp, mirror], axis=1)
    assert full.shape[1] == n0
    axes = tuple(range(1, 1 + rank))
    time = np.fft.ifftn(full, axes=axes, norm=None) * math.prod(shape)
    out = np.real(time)
    s = normalize_scale(normalize, "inverse", math.prod(shape))
    return out * s if s != 1.0 else out


def fftconv_out_shape(shape: Sequence[int], kernel_shape: Sequence[int], boundary: str):
    """(fft_shape, out_shape, out_offset) per boundary mode."""
    rank = len(shape)
    if boundary == "circular":
        return list(shape), list(shape), [0] * rank
    fft_shape = [shape[d] + kernel_shape[d] - 1 for d in range(rank)]
    if boundary == "linear-full":
        return fft_shape, list(fft_shape), [0] * rank
    if boundary == "linear-same":
        return fft_shape, list(shape), [(kernel_shape[d] - 1) // 2 for d in range(rank)]
    if boundary == "linear-valid":
        out = [shape[d] - kernel_shape[d] + 1 for d in range(rank)]
        if any(o <= 0 for o in out):
            raise ValueError("linear-valid requires kernelShape <= shape")
        return fft_shape, out, [kernel_shape[d] - 1 for d in range(rank)]
    raise ValueError(f"bad boundary {boundary!r}")
