"""numpy reference math, copied from ``webgpufft_tpu/utils/mathref.py``.

Only what the c2c slice needs: the per-plan scale, the ND FFT oracle, and
the fftconv domain rule that ``spec.normalize_spec`` validates against.

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
