"""Interleaved-real complex arithmetic helpers.

A complex tensor is float32 with a trailing component dim of size 2
(``[..., 0] = re, [..., 1] = im``), the layout of the JAX package and of
``torch.view_as_real`` on complex64.

The numpy half is copied from ``webgpufft_tpu/core/cplx.py`` (host tables);
``cmul_const`` is its torch counterpart.

1. ``to_w4``: a complex matrix W (a, c) becomes a real 4-D tensor
   W4[a, i, c, j] such that contracting (a, i) of interleaved data against it
   performs the complex matmul and yields interleaved output.
2. ``const_pair``: a complex elementwise multiplier z becomes two real
   tensors (ca, cb) with ``out = d*ca + swap(d)*cb`` where swap flips the
   component dim.
"""

from __future__ import annotations

import numpy as np
import torch


def to_w4(w: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Complex (a, c) matrix -> real (a, 2, c, 2) interleaved-matmul tensor."""
    a, c = w.shape
    out = np.empty((a, 2, c, 2), dtype=dtype)
    out[:, 0, :, 0] = w.real
    out[:, 1, :, 0] = -w.imag
    out[:, 0, :, 1] = w.imag
    out[:, 1, :, 1] = w.real
    return out


def const_pair(z: np.ndarray, dtype=np.float32):
    """Complex multiplier z (...,) -> (ca, cb) each (..., 2) real for
    ``cmul_const``."""
    ca = np.stack([z.real, z.real], axis=-1).astype(dtype)
    cb = np.stack([-z.imag, z.imag], axis=-1).astype(dtype)
    return ca, cb


def cmul_const(d: torch.Tensor, ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Multiply interleaved data d (..., 2) by a precomputed complex constant
    given as a const_pair.  out_re = dr*re - di*im; out_im = di*re + dr*im."""
    return d * ca + torch.flip(d, dims=(-1,)) * cb


def interleave(z: np.ndarray) -> np.ndarray:
    """numpy complex (...,) -> float32 (..., 2)."""
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def uninterleave(x: np.ndarray) -> np.ndarray:
    """float (..., 2) -> numpy complex128 (...,)."""
    x = np.asarray(x, dtype=np.float64)
    return x[..., 0] + 1j * x[..., 1]
