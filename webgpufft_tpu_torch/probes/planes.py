"""P3, K1 on re/im-split planes, and K1 in place.

Counterpart of the JAX package's Pallas probe ``benches/r26_pallas_endgame.py``:
``:102`` ``build_split`` (call ``:139``), the line FFT on planes
``(batch, 2, n2, n1)`` fed pre-split (``split_pre``) or de- and re-interleaved
inside the kernel (``split_il``), and the rebuild of the fused kernel with
``input_output_aliases={0: 0}`` in ``main`` (call ``:223``).

- ``lines_planes`` (``csrc/probes/lines_planes.cu``): K1's transform with
  input and output f32 (lines, 2, N), plane 0 the real parts.  Every global
  access is a unit-stride ``float`` per plane where K1 has one ``float2``.
  ``split_il`` needs no kernel of its own here: K1 takes interleaved I/O and
  holds ``float2`` in registers, so it *is* that variant.
- ``lines_inplace``: K1's own entry point with the output pointer equal to
  the input's.  Safe because a CTA owns whole lines and a barrier separates
  its last global read from its first global write, which holds for chains
  of two or more passes only: a one-pass chain is refused.  It counts as a
  launch of K1 (``fused.fused_lines.launches``).  The plans' wrapper
  (``core/fused.py``) stays out of place.
- ``cols_inplace``: the same for K2 (``core/fused_cols.py``): a CTA owns
  every tile it transforms, whichever design serves the view, and reads a
  tile before it writes any of it.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import _build
from ..core import fused, fused_cols, radix


def lines_planes_reference(x: torch.Tensor, tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain torch version: K1's plain version on the interleaved form of
    the planes ``x`` (lines, 2, N), split into planes again."""
    y = fused.fused_lines_reference(torch.stack(x.unbind(1), dim=-1), tables)
    return torch.stack(y.unbind(-1), dim=1)


def lines_planes(x: torch.Tensor, tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """FFT along the last axis of float32 planes ``x`` (lines, 2, N) with the
    tables of ``fused.lines_consts``.  A CUDA tensor launches the probe
    kernel (and counts one launch); a CPU tensor runs
    ``lines_planes_reference``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lines_planes: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[1] != 2 or x.shape[0] < 1
            or not x.is_contiguous()):
        raise ValueError(
            f"lines_planes: x must be a contiguous float32 (lines, 2, N) tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    if x.device.type == "cpu":
        return lines_planes_reference(x, tables)
    n = x.shape[2]
    # the probe runs the direct design at every length (radix.direct_tables)
    ptrs = _build.table_ptrs(x, radix.direct_tables(tables, n), {"cw": (n, 2), "cp": (2,)},
                             "lines_planes")
    lib = _build.library("probes")
    y = torch.empty_like(x)
    with _build.on_device(x.device):
        rc = lib.wgfft_lines_planes(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0], n,
                                    *_build.chain_arg(radix.radix_chain(n)),
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "lines_planes", "probes")
    lines_planes.launches += 1
    return y


lines_planes.launches = 0


def lines_inplace(x: torch.Tensor, tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K1 on interleaved float32 ``x`` (lines, N, 2), written over ``x``;
    returns ``x``.  A CUDA tensor launches K1 with y = x (one K1 launch); a
    CPU tensor gets K1's plain version copied into it.  Raises where K1
    cannot run in place (``radix.lines_in_place``: a one-pass chain outside
    the packed design)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lines_inplace: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 2 or x.shape[0] < 1
            or not x.is_contiguous()):
        raise ValueError(
            f"lines_inplace: x must be a contiguous float32 (lines, N, 2) tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    n = x.shape[1]
    chain = radix.lines_chain(n)
    if not radix.lines_in_place(n):
        raise ValueError(
            f"lines_inplace: N = {n} is a one-pass chain {chain} of the {radix.lines_design(n)} "
            f"design: no barrier separates its reads from its writes, so it cannot run in place")
    if x.device.type == "cpu":
        return x.copy_(fused.fused_lines_reference(x, tables))
    ptrs = _build.table_ptrs(x, tables, {"cw": (n, 2), "cp": (2,)}, "lines_inplace")
    lib = _build.library()
    with _build.on_device(x.device):
        rc = lib.wgfft_fused_lines(x.data_ptr(), x.data_ptr(), *ptrs, x.shape[0], n,
                                   *_build.chain_arg(chain), 0,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "lines_inplace")
    fused.fused_lines.launches += 1
    return x


def cols_inplace(x: torch.Tensor, tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K2 along axis 1 of interleaved float32 ``x`` (pre, H, L), written
    over ``x``; returns ``x``.  A CUDA tensor launches K2 with y = x (one K2
    launch); a CPU tensor gets K2's plain version copied into it.  Any
    height: in a one-pass chain each thread reads and writes whole columns
    of its own."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cols_inplace: unsupported device {x.device}")
    fused_cols._check_cuda(x)
    h = x.shape[1]
    if x.device.type == "cpu":
        return x.copy_(fused_cols.fused_cols_reference(x, tables))
    ptrs = _build.table_ptrs(x, tables, {"cw": (h, 2), "cp": (2,)}, "cols_inplace")
    lib = _build.library()
    with _build.on_device(x.device):
        rc = lib.wgfft_fused_cols(x.data_ptr(), x.data_ptr(), *ptrs, x.shape[0], h,
                                  x.shape[2] // 2, *_build.chain_arg(fused_cols.cols_chain(h)), 0,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "cols_inplace")
    fused_cols.fused_cols.launches += 1
    return x
