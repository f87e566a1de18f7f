"""K2, the columns kernel: c2c FFT along axis 1 of a (pre, H, L) view.

Port of ``webgpufft_tpu/core/fused_cols.py``.  L carries whatever trails
the transform axis as interleaved complex columns, so FFT along logical
axis d of an ND c2c is this kernel on the view
(batch * prod(shape[:d]), shape[d], 2 * prod(shape[d+1:])).

For H = h1 * h2 (``choose_split``; (h, 1) when there is no two-factor
split) and input row h = a + h1 * b: contract the high digit b against
DFT(h2), twiddle W_H^(a * k2), contract a against DFT(h1) with the scale
folded in, and write row k = h2 * k1 + k2.

``fused_cols`` launches the hand-written CUDA kernel
(``csrc/fused_cols.cu``) for a CUDA tensor and runs
``fused_cols_reference``, the same staging as torch einsums, for a CPU
tensor.  There is no fallback between the two.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import dft
from .. import _build
from ..utils import factors

MAX_SUB = 128
TABLE_NAMES = ("w1re", "w1im", "tre", "tim", "w2re", "w2im")


def choose_split(h: int) -> Optional[Tuple[int, int]]:
    """(h1, h2), h = h1*h2, both <= 128; h1 is the low (fast) digit.

    Two nontrivial digits are preferred even when h <= 128, as in the JAX
    package, so both packages split every length the same way.  Only
    lengths with no two-factor split (e.g. small primes) use (h, 1)."""
    two = factors.split_two_balanced(h, MAX_SUB)
    if two is not None:
        return two
    if h <= MAX_SUB and factors.is_smooth(h):
        return (h, 1)
    return None


def supports_length(h: int) -> bool:
    return choose_split(h) is not None


def cols_consts(h: int, direction: str, scale: float, prefix: str) -> Dict[str, np.ndarray]:
    """The kernel's tables, unchanged from the JAX package's ``cols_consts``."""
    h1, h2 = choose_split(h)
    w1 = dft.dft_matrix(h1, direction) * np.complex64(scale)  # stage-2 matrix
    w2 = dft.dft_matrix(h2, direction)                        # stage-1 matrix
    sign = -1.0 if direction == "forward" else 1.0
    tw = np.exp(sign * 2j * np.pi *
                (np.outer(np.arange(h1), np.arange(h2)) % h) / h)  # [h1, k2]
    return {
        f"{prefix}/w1re": np.ascontiguousarray(w1.real.astype(np.float32)),
        f"{prefix}/w1im": np.ascontiguousarray(w1.imag.astype(np.float32)),
        f"{prefix}/tre": tw.real.astype(np.float32)[:, :, None],
        f"{prefix}/tim": tw.imag.astype(np.float32)[:, :, None],
        f"{prefix}/w2re": np.ascontiguousarray(w2.real.astype(np.float32)),
        f"{prefix}/w2im": np.ascontiguousarray(w2.imag.astype(np.float32)),
    }


def fused_cols_reference(x: torch.Tensor, tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain torch version of the kernel: the same staging in f32 einsums.
    x is (pre, H, L) with L = 2 * columns; returns a new (pre, H, L)."""
    h1, h2 = tables["w1re"].shape[0], tables["w2re"].shape[0]
    pre, h, lanes = x.shape
    v = x.reshape(pre, h2, h1, lanes // 2, 2)      # [p, b, a, c]: row = a + h1*b
    xr, xi = v[..., 0], v[..., 1]
    w2re, w2im = tables["w2re"], tables["w2im"]
    # stage 1: contract b -> [p, a, k2, c]
    ur = torch.einsum("pbac,bk->pakc", xr, w2re) - torch.einsum("pbac,bk->pakc", xi, w2im)
    ui = torch.einsum("pbac,bk->pakc", xr, w2im) + torch.einsum("pbac,bk->pakc", xi, w2re)
    tre, tim = tables["tre"], tables["tim"]        # (h1, h2, 1): ride the columns
    vr = ur * tre - ui * tim
    vi = ur * tim + ui * tre
    # stage 2: contract a -> [p, k1, k2, c], row k = h2*k1 + k2
    w1re, w1im = tables["w1re"], tables["w1im"]
    yr = torch.einsum("pakc,aq->pqkc", vr, w1re) - torch.einsum("pakc,aq->pqkc", vi, w1im)
    yi = torch.einsum("pakc,aq->pqkc", vr, w1im) + torch.einsum("pakc,aq->pqkc", vi, w1re)
    return torch.stack([yr, yi], dim=-1).reshape(pre, h, lanes)


def fused_cols(x: torch.Tensor, tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """FFT along axis 1 of float32 x (pre, H, L), L even, with the tables
    of ``cols_consts`` (unprefixed names).  A CUDA tensor runs the CUDA
    kernel (and counts one launch); a CPU tensor runs
    ``fused_cols_reference``."""
    if x.device.type == "cpu":
        return fused_cols_reference(x, tables)
    if x.device.type != "cuda":
        raise ValueError(f"fused_cols: unsupported device {x.device}")
    h1, h2 = tables["w1re"].shape[0], tables["w2re"].shape[0]
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[1] != h1 * h2
            or x.shape[2] % 2 or min(x.shape) < 1 or not x.is_contiguous()):
        raise ValueError(
            f"fused_cols: x must be a contiguous float32 (pre, {h1 * h2}, L) "
            f"tensor with L even, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}")
    ptrs = _build.table_ptrs(x, tables, {
        "w1re": (h1, h1), "w1im": (h1, h1), "tre": (h1, h2, 1), "tim": (h1, h2, 1),
        "w2re": (h2, h2), "w2im": (h2, h2)}, "fused_cols")
    lib = _build.library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.wgfft_fused_cols(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0],
                                  h1, h2, x.shape[2] // 2,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_cols")
    fused_cols.launches += 1
    return y


fused_cols.launches = 0
