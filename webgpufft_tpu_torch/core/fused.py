"""K1, the fused line kernel: batched c2c FFT along the contiguous last axis.

Port of ``webgpufft_tpu/core/fused.py``.  For N = n1 * n2 (``choose_split``,
both factors in [2, 128]) and input index n = a + n1 * b:

1. stage A  — contract the high digit b against DFT(n2);
2. twiddle  — multiply by W_N^(a * k2);
3. stage B  — contract the low digit a against DFT(n1) with the normalize
              scale folded in, writing X[k] at k = n2 * k1 + k2 (natural
              order).

One read and one write of each line.  ``fused_lines`` launches the
hand-written CUDA kernel (``csrc/fused_lines.cu``) for a CUDA tensor and runs
``fused_lines_reference``, the same staging as torch einsums, for a CPU
tensor.  There is no fallback between the two.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import dft
from .. import _build
from ..utils import factors

MAX_SUB = 128  # both digits of the split; bounds the kernel's shared memory
TABLE_NAMES = ("f2re", "f2im", "twre", "twim", "f1re", "f1im")


def choose_split(n: int) -> Optional[Tuple[int, int]]:
    """(n1, n2) with n = n1*n2, both in [2, 128], balanced.  n1 is the low
    (fast) digit of the input index."""
    return factors.split_two_balanced(n, MAX_SUB)


def supports_length(n: int, tuning=None) -> bool:
    return choose_split(n) is not None


def lines_consts(n: int, direction: str, scale: float, prefix: str) -> Dict[str, np.ndarray]:
    """The kernel's tables as natural complex matrices (re/im f32 pairs),
    from the same float64 host math as the JAX package's ``fused_consts``."""
    n1, n2 = choose_split(n)
    w2 = dft.dft_matrix(n2, direction)             # complex64 (n2, n2)
    w1 = dft.dft_matrix(n1, direction)             # complex64 (n1, n1)
    tw = np.exp((-2j if direction == "forward" else 2j) * np.pi *
                (np.outer(np.arange(n1), np.arange(n2)) % n) / n)  # [a, k2]
    return {
        f"{prefix}/f2re": np.ascontiguousarray(w2.real.astype(np.float32)),
        f"{prefix}/f2im": np.ascontiguousarray(w2.imag.astype(np.float32)),
        f"{prefix}/twre": tw.real.astype(np.float32),
        f"{prefix}/twim": tw.imag.astype(np.float32),
        f"{prefix}/f1re": (w1.real * scale).astype(np.float32),
        f"{prefix}/f1im": (w1.imag * scale).astype(np.float32),
    }


def tables_from_reference(np_consts: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """This kernel's tables recovered from the JAX package's ``fused_consts``
    under ``prefix``, by reshaping and slicing only:

    - ``f2re``/``f2im`` pass through;
    - ``twre``/``twim`` invert ``const_pair`` on ``ta1``/``tb1`` (n2, 2*n1);
    - ``f1re``/``f1im`` undo the block reshape of ``g1``, whose row 2*a + i
      and column j*n1 + c hold component (i, j) of DFT(n1)[a, c] * scale.
    """
    ta1 = np_consts[f"{prefix}/ta1"]
    n2, n1 = ta1.shape[0], ta1.shape[1] // 2
    tb1 = np_consts[f"{prefix}/tb1"]
    g1 = np_consts[f"{prefix}/g1"].reshape(n1, 2, 2, n1)   # [a, i, j, c]
    return {
        f"{prefix}/f2re": np_consts[f"{prefix}/f2re"],
        f"{prefix}/f2im": np_consts[f"{prefix}/f2im"],
        f"{prefix}/twre": ta1.reshape(n2, n1, 2)[..., 0].T,
        f"{prefix}/twim": tb1.reshape(n2, n1, 2)[..., 1].T,
        f"{prefix}/f1re": g1[:, 0, 0, :],
        f"{prefix}/f1im": g1[:, 0, 1, :],
    }


def fused_lines_reference(x: torch.Tensor, tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain torch version of the kernel: the same staging in f32 einsums.
    x is interleaved (lines, N, 2); returns a new (lines, N, 2) tensor."""
    n1, n2 = tables["f1re"].shape[0], tables["f2re"].shape[0]
    lines = x.shape[0]
    v = x.reshape(lines, n2, n1, 2)                # [l, b, a]: n = a + n1*b
    xr, xi = v[..., 0], v[..., 1]
    f2re, f2im = tables["f2re"], tables["f2im"]
    # stage A: contract b -> [l, a, k2]
    ar = torch.einsum("lba,bk->lak", xr, f2re) - torch.einsum("lba,bk->lak", xi, f2im)
    ai = torch.einsum("lba,bk->lak", xr, f2im) + torch.einsum("lba,bk->lak", xi, f2re)
    twre, twim = tables["twre"], tables["twim"]
    br = ar * twre - ai * twim
    bi = ar * twim + ai * twre
    # stage B: contract a -> [l, k1, k2], flat k = n2*k1 + k2
    f1re, f1im = tables["f1re"], tables["f1im"]
    yr = torch.einsum("lak,ac->lck", br, f1re) - torch.einsum("lak,ac->lck", bi, f1im)
    yi = torch.einsum("lak,ac->lck", br, f1im) + torch.einsum("lak,ac->lck", bi, f1re)
    return torch.stack([yr, yi], dim=-1).reshape(lines, n1 * n2, 2)


def fused_lines(x: torch.Tensor, tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """FFT along axis 1 of interleaved float32 x (lines, N, 2) with the
    tables of ``lines_consts`` (unprefixed names).  A CUDA tensor runs the
    CUDA kernel (and counts one launch); a CPU tensor runs
    ``fused_lines_reference``."""
    if x.device.type == "cpu":
        return fused_lines_reference(x, tables)
    if x.device.type != "cuda":
        raise ValueError(f"fused_lines: unsupported device {x.device}")
    n1, n2 = tables["f1re"].shape[0], tables["f2re"].shape[0]
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[1] != n1 * n2
            or x.shape[2] != 2 or x.shape[0] < 1 or not x.is_contiguous()):
        raise ValueError(
            f"fused_lines: x must be a contiguous float32 (lines, {n1 * n2}, 2) "
            f"tensor, got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    ptrs = _build.table_ptrs(x, tables, {
        "f2re": (n2, n2), "f2im": (n2, n2), "twre": (n1, n2), "twim": (n1, n2),
        "f1re": (n1, n1), "f1im": (n1, n1)}, "fused_lines")
    lib = _build.library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.wgfft_fused_lines(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0],
                                   n1, n2, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_lines")
    fused_lines.launches += 1
    return y


fused_lines.launches = 0
