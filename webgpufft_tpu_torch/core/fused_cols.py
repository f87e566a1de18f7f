"""K2, the columns kernel: c2c FFT along axis 1 of a (pre, H, L) view.

Port of ``webgpufft_tpu/core/fused_cols.py``.  L carries whatever trails
the transform axis as interleaved complex columns, so FFT along logical
axis d of an ND c2c is this kernel on the view
(batch * prod(shape[:d]), shape[d], 2 * prod(shape[d+1:])).

``fused_cols_reference``, the plain version, keeps the JAX kernel's
two-digit staging as torch einsums.  For H = h1 * h2 (``choose_split``;
(h, 1) when there is no two-factor split) and input row h = a + h1 * b:
contract the high digit b against DFT(h2), twiddle W_H^(a * k2), contract a
against DFT(h1) with the scale folded in, and write row k = h2 * k1 + k2.

``fused_cols`` launches the hand-written CUDA kernel
(``csrc/fused_cols.cu``) for a CUDA tensor and runs the plain version for a
CPU tensor; there is no fallback between the two.  The CUDA kernel reaches
the same natural-order result by a chain of in-register radix butterflies
(``core/radix.py``) and reads only the ``cw`` and ``cp`` tables;
``fused_cols_chain_reference`` is its pass schedule on the CPU, a test aid.

Autodiff: as for K1 (``core/fused.py``).  ``FusedCols`` is the one
``torch.autograd.Function`` for both devices; its backward is the adjoint
launch of the same kernel on the same tables (same H and scale, opposite
direction), its JVP the pass on the tangent, and an extra batch dim folds
into ``pre``.  As K1, the pass is also the ``torch.library`` custom op
``torch.ops.wgfft.fused_cols(x, tables, adjoint)``, the route of a tensor
under ``torch.export`` and of ``FusedCols``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import dft, radix
from .. import _build
from ..utils import factors

MAX_SUB = 128
PLAIN_TABLE_NAMES = ("w1re", "w1im", "tre", "tim", "w2re", "w2im")
TABLE_NAMES = PLAIN_TABLE_NAMES + radix.TABLE_NAMES


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
    """The plain version's tables, unchanged from the JAX package's
    ``cols_consts``, and the CUDA kernel's (``radix.chain_consts``)."""
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
        **radix.chain_consts(h, direction, scale, prefix),
    }


def tables_from_reference(np_consts: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """This kernel's tables from the JAX package's ``cols_consts`` under
    ``prefix``: its six tables pass through, and ``cw``/``cp`` are built anew
    from what they say: H from their shapes, the scale from
    DFT(h1)[0, 0] * scale = ``w1re[0, 0]`` and the direction from the sign of
    Im W_H^1 (``tim[1, 1]``, or ``w1im[1, 1]`` when h2 = 1)."""
    out = {f"{prefix}/{k}": np_consts[f"{prefix}/{k}"] for k in PLAIN_TABLE_NAMES}
    w1re, w1im, tim = (np_consts[f"{prefix}/{k}"] for k in ("w1re", "w1im", "tim"))
    h1, h2 = w1re.shape[0], np_consts[f"{prefix}/w2re"].shape[0]
    im = tim[1, 1, 0] if h2 > 1 else w1im[1, 1]
    direction = "forward" if im < 0 else "inverse"
    out.update(radix.chain_consts(h1 * h2, direction, w1re[0, 0], prefix))
    return out


def fused_cols_reference(x: torch.Tensor, tables: Dict[str, torch.Tensor],
                         adjoint: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel: the same staging in f32 einsums.
    x is (pre, H, L) with L = 2 * columns; returns a new (pre, H, L).
    ``adjoint`` gives the conjugate transpose of the tables' transform,
    conj(F conj x), as the kernel's adjoint launch computes it."""
    h1, h2 = tables["w1re"].shape[0], tables["w2re"].shape[0]
    pre, h, lanes = x.shape
    v = x.reshape(pre, h2, h1, lanes // 2, 2)      # [p, b, a, c]: row = a + h1*b
    xr, xi = v[..., 0], v[..., 1]
    if adjoint:
        xi = -xi
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
    if adjoint:
        yi = -yi
    return torch.stack([yr, yi], dim=-1).reshape(pre, h, lanes)


def fused_cols_chain_reference(x: torch.Tensor, tables: Dict[str, torch.Tensor],
                               adjoint: bool = False) -> torch.Tensor:
    """The CUDA kernel's pass schedule on the CPU (``radix.radix_chain_reference``
    with the chain and tables the kernel gets): a test aid, on no plan path."""
    pre, h, lanes = x.shape
    y = radix.radix_chain_reference(x.reshape(pre, h, lanes // 2, 2),
                                    radix.radix_chain(h), tables, adjoint)
    return y.reshape(pre, h, lanes)


def launch_shape(h: int, cols: int) -> Tuple[int, int]:
    """``(grid, tile)``: how K2's entry point runs height ``h`` over ``cols``
    complex columns on the current CUDA device.  ``grid`` is the persistent
    grid (CTAs) of the ring design, 0 where the direct design serves the
    view; ``tile`` the columns of the design's tile.  Needs the card."""
    tile = ctypes.c_int(0)
    grid = _build.library().wgfft_fused_cols_ring(
        h, cols, *_build.chain_arg(radix.radix_chain(h)), ctypes.byref(tile))
    if grid < 0:
        raise ValueError(f"fused_cols: no design runs H = {h} over {cols} columns")
    return grid, tile.value


def _check_cuda(x: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] % 2 or min(x.shape) < 1
            or not x.is_contiguous()):
        raise ValueError(
            f"fused_cols: x must be a contiguous float32 (pre, H, L) tensor with L even, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


def _launch(x: torch.Tensor, tables: Dict[str, torch.Tensor], adjoint: bool) -> torch.Tensor:
    """One kernel launch on contiguous CUDA ``x``, counted: the only place
    that launches K2 for a plan, the op and ``FusedCols``."""
    h = x.shape[1]
    ptrs = _build.table_ptrs(x, tables, {"cw": (h, 2), "cp": (2,)}, "fused_cols")
    lib = _build.library()
    y = torch.empty_like(x)
    with _build.on_device(x.device):
        rc = lib.wgfft_fused_cols(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0], h,
                                  x.shape[2] // 2, *_build.chain_arg(radix.radix_chain(h)),
                                  int(adjoint), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_cols")
    fused_cols.launches += 1
    if fused_cols.seen is not None:
        fused_cols.seen.setdefault((*x.shape, adjoint, ptrs[0]), tables)
    return y


def _run(x: torch.Tensor, tables: Dict[str, torch.Tensor], adjoint: bool) -> torch.Tensor:
    """The pass on contiguous ``x``, outside autograd: the plain version on a
    CPU tensor, one kernel launch (counted) on a CUDA tensor."""
    if x.device.type == "cpu":
        return fused_cols_reference(x, tables, adjoint)
    return _launch(x, tables, adjoint)


def table_list(tables: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The op's table argument: ``tables`` in ``TABLE_NAMES`` order."""
    return radix.table_list(tables, TABLE_NAMES, "fused_cols")


@torch.library.custom_op("wgfft::fused_cols", mutates_args=(), device_types="cpu")
def fused_cols_op(x: torch.Tensor, tables: List[torch.Tensor], adjoint: bool) -> torch.Tensor:
    """The pass as a dispatcher op; this body is the CPU implementation,
    the plain version."""
    return fused_cols_reference(x.contiguous(), dict(zip(TABLE_NAMES, tables)), adjoint)


@fused_cols_op.register_kernel("cuda")
def _fused_cols_cuda(x, tables, adjoint):
    x = x.contiguous()
    _check_cuda(x)
    return _launch(x, dict(zip(TABLE_NAMES, tables)), adjoint)


radix.register_pass_op(fused_cols_op)


def _pass(x: torch.Tensor, tables: Dict[str, torch.Tensor], adjoint: bool) -> torch.Tensor:
    """The pass outside autograd: launched directly on a plain tensor that no
    dispatch mode sees, through the op otherwise (the fake tensors of a
    ``torch.export`` trace), so that a trace records the op and never calls
    the launch."""
    if radix.plain(x):
        return _run(x, tables, adjoint)
    return fused_cols_op(x, table_list(tables), adjoint)


class FusedCols(torch.autograd.Function):
    """``FusedCols.apply(x, tables, adjoint)``: the pass with its autodiff
    and batching rules.  ``x`` is contiguous (pre, H, L); gradients and
    tangents are made contiguous here."""

    @staticmethod
    def forward(x, tables, adjoint):
        return _pass(x.contiguous(), tables, adjoint)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.tables, ctx.adjoint = inputs

    @staticmethod
    def backward(ctx, g):
        return FusedCols.apply(g.contiguous(), ctx.tables, not ctx.adjoint), None, None

    @staticmethod
    def jvp(ctx, t, _tables, _adjoint):
        return FusedCols.apply(t.contiguous(), ctx.tables, ctx.adjoint)

    @staticmethod
    def vmap(info, in_dims, x, tables, adjoint):
        x = x.movedim(in_dims[0], 0)
        b, pre, h, lanes = x.shape
        y = FusedCols.apply(x.reshape(b * pre, h, lanes).contiguous(), tables, adjoint)
        return y.reshape(b, pre, h, lanes), 0


def fused_cols(x: torch.Tensor, tables: Dict[str, torch.Tensor],
               adjoint: bool = False) -> torch.Tensor:
    """FFT along axis 1 of float32 x (pre, H, L), L even, with the tables
    of ``cols_consts`` (unprefixed names); with ``adjoint`` the conjugate
    transpose of that transform.  A CUDA tensor runs the CUDA kernel (and
    counts one launch); a CPU tensor runs ``fused_cols_reference``.
    Differentiable: the backward of a CUDA tensor is one more launch of the
    kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_cols: unsupported device {x.device}")
    if x.device.type == "cuda":
        _check_cuda(x)
    if radix.tracked(x):
        return FusedCols.apply(x, tables, adjoint)
    return _pass(x, tables, adjoint)


fused_cols.launches = 0
# a caller's dict: while it is set, every launch enters its tables under
# (pre, H, L, adjoint, address of the first table)
fused_cols.seen = None
