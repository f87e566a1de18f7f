"""K1, the fused line kernel: batched c2c FFT along the contiguous last axis.

Port of ``webgpufft_tpu/core/fused.py``: the natural-order DFT of every line
of interleaved f32 (lines, N, 2), times the plan's scale, in one read and
one write of each line.  Eligible lengths are those of the JAX package,
N = n1 * n2 (``choose_split``, both factors in [2, 128]).

``fused_lines_reference``, the plain version, keeps the JAX kernel's
two-digit staging as torch einsums (input index n = a + n1 * b):

1. stage A  — contract the high digit b against DFT(n2);
2. twiddle  — multiply by W_N^(a * k2);
3. stage B  — contract the low digit a against DFT(n1) with the normalize
              scale folded in, writing X[k] at k = n2 * k1 + k2 (natural
              order).

``fused_lines`` launches the hand-written CUDA kernel
(``csrc/fused_lines.cu``) for a CUDA tensor and runs the plain version for a
CPU tensor; there is no fallback between the two.  The CUDA kernel reaches
the same result by a chain of in-register radix butterflies
(``core/radix.py``) and reads only the ``cw`` and ``cp`` tables; its entry
point launches the design that K1's rule gives the length
(``radix.lines_design``: the power-of-two design at 256 and 1024 to
16384, the warp design at 512, the mixed-radix design at the
lengths of ``radix.MIXED_LINES``, the packed design at the short lengths of
``radix.PACKED_LINES``, the general mixed-radix design at the lengths of
``radix.GENERAL_LINES``, the cluster design at the lengths of
``radix.CLUSTER_LINES``, the direct design elsewhere) on the chain
``radix.lines_chain``, for which ``cw`` is laid out; ``launch_report`` says
what a launch would be (the design the C rule gave the length, CTAs an SM,
SMs, grid, waves).  ``fused_lines_chain_reference`` is its pass schedule on the CPU, a
test aid.

Autodiff.  The pass is the real-linear map y = s * F x, so its VJP is
g_x = s * F^H g_y (same length and scale, opposite direction), its JVP is
the pass itself on the tangent, and an extra batch dim folds into ``lines``.
``FusedLines`` is the one ``torch.autograd.Function`` that says so on both
devices: every rule calls the ``Function`` again with the ``adjoint`` switch
set as needed, so the backward of a CUDA tensor is a launch of the same
kernel (F^H g = conj(F conj g): the adjoint launch conjugates on load and on
store and reads the same tables), double backward works, and the CPU holds
the hand-written rules against autograd through the plain version.

Dispatcher op.  The pass is also the ``torch.library`` custom op
``torch.ops.wgfft.fused_lines(x, tables, adjoint)`` (tables as a list in
``TABLE_NAMES`` order): its CUDA implementation launches the kernel, its CPU
implementation is the plain version, its fake implementation gives the
shape to ``torch.export`` and its autograd is the adjoint launch.  A tensor
under a tracing mode (``torch.export``'s fake and proxy tensors) reaches the
kernel only through the op, so an exported program records the op and
counts a launch each time it runs.  A plain tensor outside any mode
(``radix.plain``), tracked or not, launches directly: the dispatcher's
host work is paid by no plan call.  The launch counter and the ``seen`` log
live in ``_launch`` alone, which both routes reach.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import dft, radix
from .. import _build
from ..utils import factors

MAX_SUB = 128  # both digits of the split; bounds the kernel's shared memory
TABLE_NAMES = ("f2re", "f2im", "twre", "twim", "f1re", "f1im") + radix.TABLE_NAMES


def choose_split(n: int) -> Optional[Tuple[int, int]]:
    """(n1, n2) with n = n1*n2, both in [2, 128], balanced.  n1 is the low
    (fast) digit of the input index."""
    return factors.split_two_balanced(n, MAX_SUB)


def supports_length(n: int, tuning=None) -> bool:
    return choose_split(n) is not None


def lines_consts(n: int, direction: str, scale: float, prefix: str) -> Dict[str, np.ndarray]:
    """The plain version's tables as natural complex matrices (re/im f32
    pairs), from the same float64 host math as the JAX package's
    ``fused_consts``, and the CUDA kernel's (``radix.chain_consts``)."""
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
        **radix.chain_consts(n, direction, scale, prefix, radix.lines_chain(n)),
    }


def tables_from_reference(np_consts: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """This kernel's tables recovered from the JAX package's ``fused_consts``
    under ``prefix``, by reshaping and slicing only:

    - ``f2re``/``f2im`` pass through;
    - ``twre``/``twim`` invert ``const_pair`` on ``ta1``/``tb1`` (n2, 2*n1);
    - ``f1re``/``f1im`` undo the block reshape of ``g1``, whose row 2*a + i
      and column j*n1 + c hold component (i, j) of DFT(n1)[a, c] * scale;
    - ``cw``/``cp`` are built anew from what those tables say: N from their
      shapes, the scale from DFT(n1)[0, 0] * scale = ``f1re[0, 0]`` and the
      direction from the sign of Im W_N^1 = ``twim[1, 1]``.
    """
    ta1 = np_consts[f"{prefix}/ta1"]
    n2, n1 = ta1.shape[0], ta1.shape[1] // 2
    tb1 = np_consts[f"{prefix}/tb1"]
    g1 = np_consts[f"{prefix}/g1"].reshape(n1, 2, 2, n1)   # [a, i, j, c]
    twim = tb1.reshape(n2, n1, 2)[..., 1].T
    direction = "forward" if twim[1, 1] < 0 else "inverse"
    return {
        f"{prefix}/f2re": np_consts[f"{prefix}/f2re"],
        f"{prefix}/f2im": np_consts[f"{prefix}/f2im"],
        f"{prefix}/twre": ta1.reshape(n2, n1, 2)[..., 0].T,
        f"{prefix}/twim": twim,
        f"{prefix}/f1re": g1[:, 0, 0, :],
        f"{prefix}/f1im": g1[:, 0, 1, :],
        **radix.chain_consts(n1 * n2, direction, g1[0, 0, 0, 0], prefix,
                             radix.lines_chain(n1 * n2)),
    }


def fused_lines_reference(x: torch.Tensor, tables: Dict[str, torch.Tensor],
                          adjoint: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel: the same staging in f32 einsums.
    x is interleaved (lines, N, 2); returns a new (lines, N, 2) tensor.
    ``adjoint`` gives the conjugate transpose of the tables' transform,
    conj(F conj x), as the kernel's adjoint launch computes it."""
    if adjoint:
        return radix.conj_pairs(fused_lines_reference(radix.conj_pairs(x), tables))
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


def fused_lines_chain_reference(x: torch.Tensor, tables: Dict[str, torch.Tensor],
                                adjoint: bool = False) -> torch.Tensor:
    """The CUDA kernel's pass schedule on the CPU (``radix.radix_chain_reference``
    with the chain and tables the kernel gets, ``radix.lines_chain``; at a
    length of the cluster design its split over the cluster,
    ``radix.cluster_chain_reference``): a test aid, on no plan path."""
    n = x.shape[1]
    line = radix.CLUSTER_LINES.get(n)
    if line is not None:
        return radix.cluster_chain_reference(x, line.chain, line.clusters, tables, adjoint)
    return radix.radix_chain_reference(x, radix.lines_chain(n), tables, adjoint)


def _check_cuda(x: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 2 or x.shape[0] < 1
            or not x.is_contiguous()):
        raise ValueError(
            f"fused_lines: x must be a contiguous float32 (lines, N, 2) tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


def _launch(x: torch.Tensor, tables: Dict[str, torch.Tensor], adjoint: bool) -> torch.Tensor:
    """One kernel launch on contiguous CUDA ``x``, counted: the only place
    that launches K1 for a plan, the op and ``FusedLines``."""
    n = x.shape[1]
    ptrs = _build.table_ptrs(x, tables, {"cw": (n, 2), "cp": (2,)}, "fused_lines")
    lib = _build.library()
    y = torch.empty_like(x)
    with _build.on_device(x.device):
        rc = lib.wgfft_fused_lines(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0], n,
                                   *_build.chain_arg(radix.lines_chain(n)), int(adjoint),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_lines")
    fused_lines.launches += 1
    if fused_lines.seen is not None:
        fused_lines.seen.setdefault((n, x.shape[0], adjoint, ptrs[0]), tables)
    return y


class LinesLaunch(NamedTuple):
    """What K1's entry point would launch for a shape (``launch_report``)."""
    design: str      # the design the C rule gave n (DESIGNS), radix.lines_design(n)
    resident: int    # CTAs an SM holds of the kernel (the occupancy calculator)
    sms: int         # SMs of the device
    grid: int        # CTAs of the grid
    work: int        # CTAs' worth of work: the grid, unless the design loops over its lines

    @property
    def waves(self) -> float:
        """How many times the launch fills every SM with the CTAs it holds."""
        return self.work / (self.resident * self.sms)


# the name each design's kernel carries in a profiler trace, in the
# numbering of the C entry point's report (LinesDesign, csrc/lines.cuh)
KERNEL_NAMES = {"direct": "fused_lines_kernel", "pow2": "pow2_lines_kernel",
                "warp": "warp_lines_kernel", "mixed": "mixed_lines_kernel",
                "packed": "packed_lines_kernel", "general": "general_lines_kernel",
                "cluster": "cluster_kernel"}
DESIGNS = tuple(KERNEL_NAMES)


def kernel_name(n: int) -> str:
    """The name of the kernel K1 launches for length ``n`` in a profiler
    trace (the design K1's rule gives ``n``)."""
    return KERNEL_NAMES[radix.lines_design(n)]


def launch_report(n: int, lines: int) -> LinesLaunch:
    """What a launch of K1 over ``lines`` lines of ``n`` points would be on
    the current CUDA device, in the design K1's rule gives ``n`` (the C
    rule's answer, which the card tests hold to ``radix.lines_design``);
    needs the card."""
    out = (ctypes.c_longlong * 5)()
    rc = _build.library().wgfft_fused_lines_resident(
        lines, n, *_build.chain_arg(radix.lines_chain(n)), out)
    _build.check(rc, "fused_lines")
    return LinesLaunch(DESIGNS[out[4]], *out[:4])


def _run(x: torch.Tensor, tables: Dict[str, torch.Tensor], adjoint: bool) -> torch.Tensor:
    """The pass on contiguous ``x``, outside autograd: the plain version on a
    CPU tensor, one kernel launch (counted) on a CUDA tensor."""
    if x.device.type == "cpu":
        return fused_lines_reference(x, tables, adjoint)
    return _launch(x, tables, adjoint)


def table_list(tables: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The op's table argument: ``tables`` in ``TABLE_NAMES`` order."""
    return radix.table_list(tables, TABLE_NAMES, "fused_lines")


@torch.library.custom_op("wgfft::fused_lines", mutates_args=(), device_types="cpu")
def fused_lines_op(x: torch.Tensor, tables: List[torch.Tensor], adjoint: bool) -> torch.Tensor:
    """The pass as a dispatcher op; this body is the CPU implementation,
    the plain version."""
    return fused_lines_reference(x.contiguous(), dict(zip(TABLE_NAMES, tables)), adjoint)


@fused_lines_op.register_kernel("cuda")
def _fused_lines_cuda(x, tables, adjoint):
    x = x.contiguous()
    _check_cuda(x)
    return _launch(x, dict(zip(TABLE_NAMES, tables)), adjoint)


radix.register_pass_op(fused_lines_op)


def _pass(x: torch.Tensor, tables: Dict[str, torch.Tensor], adjoint: bool) -> torch.Tensor:
    """The pass outside autograd: launched directly on a plain tensor that no
    dispatch mode sees, through the op otherwise (the fake tensors of a
    ``torch.export`` trace), so that a trace records the op and never calls
    the launch."""
    if radix.plain(x):
        return _run(x, tables, adjoint)
    return fused_lines_op(x, table_list(tables), adjoint)


class FusedLines(torch.autograd.Function):
    """``FusedLines.apply(x, tables, adjoint)``: the pass with its autodiff
    and batching rules (see the module docstring).  ``x`` is contiguous
    (lines, N, 2); gradients and tangents are made contiguous here."""

    @staticmethod
    def forward(x, tables, adjoint):
        return _pass(x.contiguous(), tables, adjoint)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.tables, ctx.adjoint = inputs

    @staticmethod
    def backward(ctx, g):
        return FusedLines.apply(g.contiguous(), ctx.tables, not ctx.adjoint), None, None

    @staticmethod
    def jvp(ctx, t, _tables, _adjoint):
        return FusedLines.apply(t.contiguous(), ctx.tables, ctx.adjoint)

    @staticmethod
    def vmap(info, in_dims, x, tables, adjoint):
        x = x.movedim(in_dims[0], 0)
        b, lines, n, _ = x.shape
        y = FusedLines.apply(x.reshape(b * lines, n, 2).contiguous(), tables, adjoint)
        return y.reshape(b, lines, n, 2), 0


def fused_lines(x: torch.Tensor, tables: Dict[str, torch.Tensor],
                adjoint: bool = False) -> torch.Tensor:
    """FFT along axis 1 of interleaved float32 x (lines, N, 2) with the
    tables of ``lines_consts`` (unprefixed names); with ``adjoint`` the
    conjugate transpose of that transform.  A CUDA tensor runs the CUDA
    kernel (and counts one launch); a CPU tensor runs
    ``fused_lines_reference``.  Differentiable: the backward of a CUDA
    tensor is one more launch of the kernel.  Under ``torch.export`` the
    call is recorded as the op ``wgfft::fused_lines``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_lines: unsupported device {x.device}")
    if x.device.type == "cuda":
        _check_cuda(x)
    if radix.tracked(x):
        return FusedLines.apply(x, tables, adjoint)
    # nothing differentiates or batches through x: skip Function.apply, whose
    # host work would be paid by every call
    return _pass(x, tables, adjoint)


fused_lines.launches = 0
# a caller's dict: while it is set, every launch enters its tables under
# (N, lines, adjoint, address of the first table)
fused_lines.seen = None
