"""K2 in a design, tile or fixed-design variant the caller names; K1's
power-of-two, warp, mixed-radix and packed designs in a variant the caller
names, and its general design and the cluster design of both on a chain and
shape the caller names.

No Pallas probe stands behind this module: it launches the counterpart of
K2 (``webgpufft_tpu/core/fused_cols.py:161``) in one of its designs by name,
for the comparisons of ``chip_probes/k1_k2_ring.py`` and
``chip_probes/k2_fill_variants.py``.  The plans' entry point takes what K2's
rule picks (``csrc/cols.cuh``, ``cols_rule``; ``fused_cols.cols_rule`` is
its Python copy and ``fused_cols.launch_shape`` asks the card); here the
caller does: ``cols_variant(x, tables, design, tile=)``
(``csrc/probes/cols_variants.cu``) with ``"direct"``, the direct design (a
CTA loads its tile from global memory straight into registers, runs the
passes, stores); ``"ring"``, persistent CTAs with a ring of two stages, a
tile landing by a 3-D tensor map where its rows are 16-byte aligned and
whole (``cp.async`` otherwise), as the plans run it; ``"ring-async"``,
every tile landing row by row by ``cp.async`` (``tile`` 0: the design's own
tile, the direct design's or the ring's narrowed until two stages fit); and
``cols_fixed_variant(x, tables, name)`` (``csrc/probes/cols_fixed_variants.cu``)
with a variant of ``FIXED_VARIANTS``, K2's fixed design
(``csrc/cols_fixed.cuh``: a kernel per height, tile and cluster size, the
chain fixed at compile time, consecutive entries of radix_chain fused into
one butterfly, a tile split over a thread-block cluster with its last pass
through distributed shared memory).  ``cols_variant_slots`` and
``cols_fixed_slots`` say how many CTAs (clusters) of a variant the card
holds at once.

``lines_variant(x, tables, variant)`` (``csrc/probes/lines_variants.cu``)
launches K1 (``webgpufft_tpu/core/fused.py:223``) in one instantiation of
its power-of-two design (``csrc/lines_pow2.cuh``: one line a CTA) or its
warp design (``csrc/lines_warp.cuh``: a line in the lanes of one warp)
named in ``LINES_VARIANTS``, or of its mixed-radix design
(``csrc/lines_mixed.cuh``: lines a CTA, threads, chain; built by
``csrc/probes/lines_mixed_variants.cu`` and ``lines_mixed_variants_long.cu``)
named in ``MIXED_VARIANTS``, or of its packed design
(``csrc/lines_packed.cuh``: lanes a line, stages; built by
``csrc/probes/lines_packed_variants.cu``) named in ``PACKED_VARIANTS``, with the twiddle table of its chain
(``lines_variant_tables``), for the comparison of
``chip_probes/k1_pow2_variants.py``, ``chip_probes/k1_mixed_variants.py`` and
``chip_probes/k1_packed_variants.py``.  The plans' entry point launches the
variant K1's rule names (``radix.POW2_LINES``, ``radix.WARP_LINES``,
``radix.MIXED_LINES``, ``radix.PACKED_LINES``) and the direct design
elsewhere.

``general_cols_variant(x, tables, chain, points, tile)`` launches K2's
general design (``csrc/cols_general.cuh``) the same way through
``wgfft_general_cols``, ``general_cols_report`` says what it would be;
the plans' entry point launches the shape ``fused_cols.GENERAL_COLS``
names, fitted to the sweep of ``chip_probes/k2_general_variants.py``.
The direct design and the ring (``cols_variant``) and the fixed design
(``cols_fixed_variant``) run on ``radix_chain(H)`` at every height, so
they read ``fused_cols.direct_tables``.

``general_variant(x, tables, chain, points, lines)`` launches K1's general
design (``csrc/lines_general.cuh``: one kernel a class of points a thread,
the chain, the class and the lines a CTA run-time values) through the
plans' library's own entry point ``wgfft_general_lines``, so that no
kernel is built twice; ``general_report`` says what that launch would be.
The plans' entry point launches the shape ``radix.GENERAL_LINES`` names,
fitted to the sweep of ``chip_probes/k1_general_variants.py``.

``cluster_variant(x, tables, chain, points, tile, clusters)`` launches the
cluster design that K1 and K2 share (``csrc/cluster.cuh``: a line or a tile
split over a thread-block cluster, the first pass across it) on a (pre, H,
L) view through the plans' library's entry point ``wgfft_cluster`` (K1's
(lines, N, 2) is that view with tile 1), ``cluster_report`` says what it
would be; the plans' entry points launch the shapes ``radix.CLUSTER_LINES``
and ``fused_cols.CLUSTER_COLS`` name, fitted to the sweeps of the two
scripts with ``--cluster``.

Each wrapper runs the kernel's plain version on a CPU tensor and launches or
raises on a CUDA tensor; ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from .. import _build
from ..core import fused, fused_cols, radix

COLS_DESIGNS = {"direct": 0, "ring": 1, "ring-async": 2}


class LinesVariant(NamedTuple):
    n: int
    design: str               # "pow2" (lines_pow2.cuh) or "warp" (lines_warp.cuh)
    threads: int              # a CTA
    lanes: int                # a line: the CTA's threads in the power-of-two design
    minb: int                 # CTAs an SM asked for
    chain: Tuple[int, ...]


def _pow2(n, threads, minb, *chain):
    return LinesVariant(n, "pow2", threads, threads, minb, chain)


def _warp(n, lanes, threads, minb, *chain):
    return LinesVariant(n, "warp", threads, lanes, minb, chain)


# in the order of the switch of csrc/probes/lines_variants.cu
LINES_VARIANTS: Dict[str, LinesVariant] = {
    "8192 rule": _pow2(8192, 256, 2, 32, 16, 16),
    "8192 one CTA": _pow2(8192, 256, 1, 32, 16, 16),
    "8192 three CTAs": _pow2(8192, 256, 3, 32, 16, 16),
    "8192 four passes": _pow2(8192, 512, 2, 16, 8, 8, 8),
    "8192 radix 32 last": _pow2(8192, 256, 2, 16, 16, 32),
    "16384 rule": _pow2(16384, 512, 1, 32, 32, 16),
    "16384 four passes": _pow2(16384, 512, 1, 16, 16, 8, 8),
    "16384 four passes 1024 threads": _pow2(16384, 1024, 1, 16, 16, 8, 8),
    "4096 rule": _pow2(4096, 256, 4, 16, 16, 16),
    "4096 32 points": _pow2(4096, 128, 4, 32, 16, 8),
    "2048 rule": _pow2(2048, 128, 4, 16, 16, 8),
    "2048 32 points": _pow2(2048, 64, 8, 32, 8, 8),
    "2048 six CTAs": _pow2(2048, 128, 6, 16, 16, 8),
    "2048 eight CTAs": _pow2(2048, 128, 8, 16, 16, 8),
    "1024 warp, two passes": _warp(1024, 32, 64, 8, 32, 32),
    "1024 warp, one warp a CTA": _warp(1024, 32, 32, 16, 32, 32),
    "1024 warp, four warps a CTA": _warp(1024, 32, 128, 4, 32, 32),
    "1024 warp, three passes": _warp(1024, 32, 64, 8, 16, 8, 8),
    "1024 twelve CTAs": _pow2(1024, 64, 12, 16, 8, 8),
    "512 warp, two passes": _warp(512, 16, 64, 8, 32, 16),
    "512 warp, radix 32 last": _warp(512, 16, 64, 8, 16, 32),
    "512 warp, eight CTAs": _warp(512, 32, 64, 8, 8, 8, 8),
    "512 a line a CTA": _pow2(512, 64, 16, 8, 8, 8),
    "256 warp, two passes": _warp(256, 16, 64, 8, 16, 16),
    "256 warp, 32 points": _warp(256, 8, 64, 8, 32, 8),
    "256 warp, four warps a CTA": _warp(256, 16, 128, 4, 16, 16),
    "32 rule": _warp(32, 4, 64, 16, 8, 4),
    "32 one pass": _warp(32, 1, 64, 8, 32),
    "32 one warp a CTA": _warp(32, 4, 32, 32, 8, 4),
    "64 warp": _warp(64, 8, 64, 16, 8, 8),
    "128 warp": _warp(128, 8, 64, 8, 16, 8),
    "1024 rule": _pow2(1024, 64, 16, 16, 8, 8),
    "1024 16 16 4": _pow2(1024, 64, 12, 16, 16, 4),
    "1024 128 threads": _pow2(1024, 128, 8, 8, 8, 4, 4),
    "512 one warp a CTA": _pow2(512, 32, 24, 8, 8, 8),
    "512 rule": _warp(512, 32, 64, 6, 8, 8, 8),
    "256 warp, sixteen CTAs": _warp(256, 16, 64, 16, 16, 16),
    "256 warp, three passes": _warp(256, 32, 64, 16, 8, 8, 4),
    "256 rule": _pow2(256, 32, 32, 8, 8, 4),
    "256 warp, twelve CTAs": _warp(256, 16, 64, 12, 16, 16),
    "128 warp, twelve CTAs": _warp(128, 8, 64, 12, 16, 8),
    "128 warp, 8 points a lane": _warp(128, 16, 64, 16, 8, 4, 4),
    "128 warp, one warp a CTA": _warp(128, 8, 32, 16, 16, 8),
}


class MixedVariant(NamedTuple):
    n: int
    lines: int                # a CTA
    threads: int              # a CTA
    minb: int                 # CTAs an SM asked for
    chain: Tuple[int, ...]


def _mixed(n, lines, threads, minb, *chain):
    return MixedVariant(n, lines, threads, minb, chain)


# in the order of the switches of csrc/probes/lines_mixed_variants.cu and
# lines_mixed_variants_long.cu
MIXED_VARIANTS: Dict[str, MixedVariant] = {
    "360 rule": _mixed(360, 4, 80, 8, 20, 18),
    "360 24 15": _mixed(360, 4, 64, 8, 24, 15),
    "360 eight lines a CTA": _mixed(360, 8, 128, 6, 24, 15),
    "1000 rule": _mixed(1000, 1, 100, 10, 10, 10, 10),
    "1000 128 threads": _mixed(1000, 1, 128, 8, 10, 10, 10),
    "1000 two lines a CTA": _mixed(1000, 2, 224, 6, 10, 10, 10),
    "1352 rule": _mixed(1352, 1, 128, 8, 13, 13, 8),
    "1352 two lines a CTA": _mixed(1352, 2, 224, 4, 13, 13, 8),
    "1352 8 13 13": _mixed(1352, 1, 128, 8, 8, 13, 13),
    "1536 rule": _mixed(1536, 1, 64, 8, 8, 8, 24),
    "2079 rule": _mixed(2079, 1, 96, 4, 27, 7, 11),
    "2079 eight CTAs": _mixed(2079, 1, 96, 8, 27, 7, 11),
    "2079 27 11 7": _mixed(2079, 1, 96, 8, 27, 11, 7),
    "2310 rule": _mixed(2310, 1, 160, 3, 22, 15, 7),
    "2310 22 21 5": _mixed(2310, 1, 128, 5, 22, 21, 5),
    "2310 30 7 11": _mixed(2310, 1, 112, 5, 30, 7, 11),
    "3000 rule": _mixed(3000, 1, 100, 4, 10, 10, 30),
    "3000 30 10 10": _mixed(3000, 1, 100, 4, 30, 10, 10),
    "3000 10 30 10": _mixed(3000, 1, 100, 4, 10, 30, 10),
    "3072 rule": _mixed(3072, 1, 128, 4, 32, 4, 24),
    "3072 16 8 24": _mixed(3072, 1, 192, 3, 16, 8, 24),
    "5120 rule": _mixed(5120, 1, 320, 2, 16, 16, 20),
    "6000 rule": _mixed(6000, 1, 256, 2, 24, 25, 10),
    "6000 30 25 8": _mixed(6000, 1, 256, 2, 30, 25, 8),
    "6000 20 30 10": _mixed(6000, 1, 320, 2, 20, 30, 10),
    "6000 30 8 25": _mixed(6000, 1, 256, 2, 30, 8, 25),
    "6144 rule": _mixed(6144, 1, 256, 2, 32, 24, 8),
    "6144 24 32 8": _mixed(6144, 1, 256, 2, 24, 32, 8),
    "8232 rule": _mixed(8232, 1, 392, 2, 8, 21, 7, 7),
    "8232 28 14 21": _mixed(8232, 1, 320, 1, 28, 14, 21),
    "8232 392 threads": _mixed(8232, 1, 392, 1, 28, 14, 21),
    "9216 rule": _mixed(9216, 1, 384, 2, 32, 24, 12),
    "12288 rule": _mixed(12288, 1, 512, 1, 32, 32, 12),
    "15360 rule": _mixed(15360, 1, 512, 1, 32, 32, 15),
}


class PackedVariant(NamedTuple):
    n: int
    lanes: int                # a line (1: a whole line in one lane's registers)
    stages: int               # a warp's stages (2: the next block lands meanwhile)
    chain: Tuple[int, ...]


# in the order of csrc/probes/lines_packed_variants.cu: the packed design at
# 128 points, which its rule leaves on the direct design (faster at 8,192
# lines, slower at 196,608; PERF.md), for a rule by line count
PACKED_VARIANTS: Dict[str, PackedVariant] = {
    "128 lanes 8 stages 2": PackedVariant(128, 8, 2, (16, 8)),
    "128 lanes 8 stages 1": PackedVariant(128, 8, 1, (16, 8)),
}

_TABLES = ((LINES_VARIANTS, "wgfft_lines_variant"), (MIXED_VARIANTS, "wgfft_mixed_variant"),
           (PACKED_VARIANTS, "wgfft_packed_variant"))


def _entry(variant: str):
    """(the variant's record, the probes library's entry point, its index)."""
    for table, entry in _TABLES:
        if variant in table:
            return table[variant], entry, list(table).index(variant)
    raise ValueError(f"lines_variant: variant must be one of "
                     f"{sorted(n for table, _ in _TABLES for n in table)}, got {variant!r}")


def lines_variant_tables(variant: str, direction: str, scale: float,
                         device="cpu") -> Dict[str, torch.Tensor]:
    """The ``cw`` and ``cp`` tables ``variant`` reads: ``cw`` laid out for
    its chain, ``cp`` K1's."""
    v = _entry(variant)[0]
    return {k.rsplit("/", 1)[1]: torch.as_tensor(t, device=device)
            for k, t in radix.chain_consts(v.n, direction, scale, "p", v.chain).items()}


def lines_variant(x: torch.Tensor, tables: Dict[str, torch.Tensor], variant: str,
                  adjoint: bool = False, inplace: bool = False) -> torch.Tensor:
    """K1's transform (its adjoint with ``adjoint``) of interleaved float32
    ``x`` (lines, N, 2) in the ``variant`` of ``LINES_VARIANTS``,
    ``MIXED_VARIANTS`` or ``PACKED_VARIANTS``, whose N must be x's, with the
    variant's tables (``lines_variant_tables``); with ``inplace`` written
    over ``x``.  A CUDA tensor launches the probe kernel (and counts one
    launch); a CPU tensor runs the variant's chain through
    ``radix.radix_chain_reference`` (a packed variant through
    ``radix.packed_lines_reference``, its block-staged layout)."""
    v, entry, index = _entry(variant)
    n, chain = v.n, v.chain
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lines_variant: unsupported device {x.device}")
    fused._check_cuda(x)
    if x.shape[1] != n:
        raise ValueError(f"lines_variant: {variant!r} runs N = {n}, x has N = {x.shape[1]}")
    if x.device.type == "cpu":
        if isinstance(v, PackedVariant):
            y = radix.packed_lines_reference(x, chain, tables, adjoint, v.lanes)
        else:
            y = radix.radix_chain_reference(x, chain, tables, adjoint)
        return x.copy_(y) if inplace else y
    ptrs = _build.table_ptrs(x, tables, {"cw": (n, 2), "cp": (2,)}, "lines_variant")
    lib = _build.library("probes")
    y = x if inplace else torch.empty_like(x)
    with _build.on_device(x.device):
        rc = getattr(lib, entry)(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0], n, index,
                                 int(adjoint), None, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"lines_variant {variant}", "probes")
    lines_variant.launches += 1
    return y


def lines_variant_resident(variant: str) -> int:
    """CTAs an SM of the current CUDA device holds of ``variant``'s kernel
    (the CUDA occupancy calculator); needs the card."""
    v, entry, index = _entry(variant)
    ctas = ctypes.c_int(0)
    rc = getattr(_build.library("probes"), entry)(
        None, None, None, None, 1, v.n, index, 0,
        ctypes.cast(ctypes.pointer(ctas), ctypes.POINTER(ctypes.c_int)), None)
    _build.check(rc, f"lines_variant {variant}", "probes")
    return ctas.value


lines_variant.launches = 0


def general_variant(x: torch.Tensor, tables: Dict[str, torch.Tensor], chain: Tuple[int, ...],
                    points: int, lines: int, adjoint: bool = False,
                    inplace: bool = False) -> torch.Tensor:
    """K1's transform (its adjoint with ``adjoint``) of interleaved float32
    ``x`` (lines, N, 2) in the general design (``csrc/lines_general.cuh``)
    on any ``chain`` of two to four passes of ``radix.GENERAL_RADICES`` that
    multiplies to N, in the class of ``points`` (the most points a thread
    holds: a class of ``radix.GENERAL_CLASSES``) with ``lines`` lines a CTA, whatever K1's rule says
    of N, with ``tables`` laid out for the chain (``radix.chain_consts``);
    with ``inplace`` written over ``x``: the variants of
    ``chip_probes/k1_general_variants.py``.  A CUDA tensor launches the
    kernel of the plans' library (and counts one launch here, none in
    ``fused_lines``) or raises where the design cannot run that shape; a
    CPU tensor runs the chain through ``radix.radix_chain_reference``."""
    n = x.shape[1]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"general_variant: unsupported device {x.device}")
    fused._check_cuda(x)
    if (not 2 <= len(chain) <= 4 or math.prod(chain) != n
            or radix.general_threads(n, chain, points, lines) is None
            or any(r not in radix.GENERAL_RADICES for r in chain)):
        raise ValueError(f"general_variant: the general design does not run N = {n} on "
                         f"{tuple(chain)} at {points} points a thread, {lines} lines a CTA")
    if x.device.type == "cpu":
        y = radix.radix_chain_reference(x, chain, tables, adjoint)
        return x.copy_(y) if inplace else y
    ptrs = _build.table_ptrs(x, tables, {"cw": (n, 2), "cp": (2,)}, "general_variant")
    y = x if inplace else torch.empty_like(x)
    with _build.on_device(x.device):
        rc = _build.library().wgfft_general_lines(
            x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0], n, *_build.chain_arg(tuple(chain)),
            points, lines, int(adjoint), None, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"general_variant {tuple(chain)} points {points} lines {lines}")
    general_variant.launches += 1
    return y


general_variant.launches = 0


class GeneralReport(NamedTuple):
    """What a launch of the general design would be (``general_report``)."""
    resident: int    # CTAs an SM holds of the kernel
    sms: int
    grid: int
    threads: int     # a CTA


def general_report(n: int, count: int, chain: Tuple[int, ...], points: int,
                   lines: int) -> GeneralReport:
    """What ``general_variant`` would launch for ``count`` lines of ``n``
    on the current CUDA device; needs the card."""
    out = (ctypes.c_longlong * 5)()
    rc = _build.library().wgfft_general_lines(None, None, None, None, count, n,
                                              *_build.chain_arg(tuple(chain)), points, lines,
                                              0, out, None)
    _build.check(rc, f"general_variant {tuple(chain)} points {points} lines {lines}")
    return GeneralReport(out[0], out[1], out[2], out[4])


def general_cols_variant(x: torch.Tensor, tables: Dict[str, torch.Tensor],
                         chain: Tuple[int, ...], points: int, tile: int, adjoint: bool = False,
                         inplace: bool = False) -> torch.Tensor:
    """K2's transform (its adjoint with ``adjoint``) along axis 1 of
    interleaved float32 ``x`` (pre, H, L) in the general design
    (``csrc/cols_general.cuh``) on any ``chain`` of two to four passes of
    ``radix.GENERAL_RADICES`` that multiplies to H, in the class of
    ``points`` with tiles of ``tile`` columns, whatever K2's rule says of H,
    with ``tables`` laid out for the chain (``radix.chain_consts``); with
    ``inplace`` written over ``x``: the variants of
    ``chip_probes/k2_general_variants.py``.  A CUDA tensor launches the
    kernel of the plans' library (and counts one launch here, none in
    ``fused_cols``) or raises where the design cannot run that shape; a CPU
    tensor runs the chain through ``radix.radix_chain_reference``."""
    pre, h, lanes = x.shape
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"general_cols_variant: unsupported device {x.device}")
    fused_cols._check_cuda(x)
    if fused_cols.general_cols_threads(h, tuple(chain), points, tile) is None:
        raise ValueError(f"general_cols_variant: the general design does not run H = {h} on "
                         f"{tuple(chain)} at {points} points a thread, tiles of {tile}")
    if x.device.type == "cpu":
        y = radix.radix_chain_reference(x.reshape(pre, h, lanes // 2, 2), chain, tables,
                                        adjoint).reshape(pre, h, lanes)
        return x.copy_(y) if inplace else y
    ptrs = _build.table_ptrs(x, tables, {"cw": (h, 2), "cp": (2,)}, "general_cols_variant")
    y = x if inplace else torch.empty_like(x)
    with _build.on_device(x.device):
        rc = _build.library().wgfft_general_cols(
            x.data_ptr(), y.data_ptr(), *ptrs, pre, h, lanes // 2,
            *_build.chain_arg(tuple(chain)), points, tile, int(adjoint), None,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"general_cols_variant {tuple(chain)} points {points} tile {tile}")
    general_cols_variant.launches += 1
    return y


general_cols_variant.launches = 0


def general_cols_report(pre: int, h: int, cols: int, chain: Tuple[int, ...], points: int,
                        tile: int) -> GeneralReport:
    """What ``general_cols_variant`` would launch for a (pre, h, 2 * cols)
    view on the current CUDA device; needs the card."""
    out = (ctypes.c_longlong * 4)()
    rc = _build.library().wgfft_general_cols(None, None, None, None, pre, h, cols,
                                             *_build.chain_arg(tuple(chain)), points, tile, 0,
                                             out, None)
    _build.check(rc, f"general_cols_variant {tuple(chain)} points {points} tile {tile}")
    return GeneralReport(out[0], out[1], out[2], out[3])


def cluster_variant(x: torch.Tensor, tables: Dict[str, torch.Tensor], chain: Tuple[int, ...],
                    points: int, tile: int, clusters: int, adjoint: bool = False,
                    inplace: bool = False) -> torch.Tensor:
    """The transform (its adjoint with ``adjoint``) along axis 1 of
    interleaved float32 ``x`` (pre, H, L) in the cluster design
    (``csrc/cluster.cuh``) on any ``chain`` of two to four passes of
    ``radix.GENERAL_RADICES`` that multiplies to H, its first radix across
    a cluster of ``clusters`` CTAs, in the class of ``points`` with tiles of
    ``tile`` columns, whatever K1's or K2's rule says of H, with ``tables``
    laid out for the chain (``radix.chain_consts``); with ``inplace``
    written over ``x``.  K1's (lines, N, 2) is the view (lines, N, 2) with
    tile 1: the variants of ``chip_probes/k1_general_variants.py`` and
    ``k2_general_variants.py`` with ``--cluster``.  A CUDA tensor launches
    the kernel of the plans' library (and counts one launch here, none in
    ``fused_lines`` or ``fused_cols``) or raises where the design cannot run
    that shape; a CPU tensor runs ``radix.cluster_chain_reference``."""
    pre, h, lanes = x.shape
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cluster_variant: unsupported device {x.device}")
    fused_cols._check_cuda(x)
    if radix.cluster_plan(h, tuple(chain), points, tile, clusters) is None:
        raise ValueError(f"cluster_variant: the cluster design does not run H = {h} on "
                         f"{tuple(chain)} at {points} points a thread, tiles of {tile}, "
                         f"{clusters} CTAs a cluster")
    if x.device.type == "cpu":
        y = radix.cluster_chain_reference(x.reshape(pre, h, lanes // 2, 2), chain, clusters,
                                          tables, adjoint).reshape(pre, h, lanes)
        return x.copy_(y) if inplace else y
    ptrs = _build.table_ptrs(x, tables, {"cw": (h, 2), "cp": (2,)}, "cluster_variant")
    y = x if inplace else torch.empty_like(x)
    with _build.on_device(x.device):
        rc = _build.library().wgfft_cluster(
            x.data_ptr(), y.data_ptr(), *ptrs, pre, h, lanes // 2,
            *_build.chain_arg(tuple(chain)), points, tile, clusters, int(adjoint), None,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"cluster_variant {tuple(chain)} points {points} tile {tile} "
                     f"clusters {clusters}")
    cluster_variant.launches += 1
    return y


cluster_variant.launches = 0


def fewest_passes(n: int, radices: Sequence[int], least: int = 2) -> List[Tuple[int, ...]]:
    """Every multiset (sorted, widest first) of the fewest ``radices`` that
    multiply to n in ``least`` to four passes."""
    for passes in range(least, 5):
        found = []

        def rec(rem, k, top, pre):
            if k == 0:
                if rem == 1:
                    found.append(tuple(pre))
                return
            for r in radices:
                if r <= top and rem % r == 0:
                    rec(rem // r, k - 1, r, pre + [r])
        rec(n, passes, max(radices), [])
        if found:
            return found
    return []


def cluster_candidates(h: int, tiles: Sequence[int] = (1,)) -> List[tuple]:
    """The cluster design's variants of height (length) ``h``: (name,
    chain, points, tile, clusters).  Chains: the two multisets of the fewest
    passes of ``radix.GENERAL_RADICES`` whose widest radix is the least
    (then whose narrowest is the most), each with every distinct radix first
    (the pass across the cluster) and the rest widest first; every cluster
    size of ``radix.CLUSTER_SIZES`` the first radix holds (two classes a CTA
    at least); every tile of ``tiles``; in the least class of
    ``radix.CLUSTER_CLASSES`` whose radices, threads and shared memory hold
    it, and the widest class too where that is another.  K1 sweeps tile 1,
    K2 several."""
    sets = sorted(fewest_passes(h, radix.GENERAL_RADICES), key=lambda s: (max(s), -min(s)))[:2]
    out = []
    for chain in sets:
        for first in dict.fromkeys(chain):
            rest = list(chain)
            rest.remove(first)
            order = (first, *sorted(rest, reverse=True))
            for clusters in radix.CLUSTER_SIZES:
                for tile in tiles:
                    held = [e for e in radix.CLUSTER_CLASSES
                            if radix.cluster_plan(h, order, e, tile, clusters)]
                    for e in dict.fromkeys(held[:1] + held[-1:]):
                        name = f"{'x'.join(map(str, order))} E{e} T{tile} C{clusters}"
                        out.append((name, order, e, tile, clusters))
    return out


class ClusterReport(NamedTuple):
    """What a launch of the cluster design would be (``cluster_report``)."""
    resident: int    # CTAs an SM holds of the kernel
    sms: int
    clusters: int    # clusters the device holds at once
    grid: int        # CTAs
    threads: int     # a CTA
    shared: int      # bytes a CTA


def cluster_report(pre: int, h: int, cols: int, chain: Tuple[int, ...], points: int, tile: int,
                   clusters: int) -> ClusterReport:
    """What ``cluster_variant`` would launch for a (pre, h, 2 * cols) view
    on the current CUDA device; needs the card."""
    out = (ctypes.c_longlong * 6)()
    rc = _build.library().wgfft_cluster(None, None, None, None, pre, h, cols,
                                        *_build.chain_arg(tuple(chain)), points, tile, clusters,
                                        0, out, None)
    _build.check(rc, f"cluster_variant {tuple(chain)} points {points} tile {tile} "
                     f"clusters {clusters}")
    return ClusterReport(*out)


def _cols_call(x, tables, design, adjoint, tile, slots, y):
    """One call of the probes' K2 entry point for the direct design and the
    ring (on ``radix_chain(H)``, ``cw`` laid out anew for it where K2's
    chain differs); returns its rc."""
    h = x.shape[1]
    ptrs = _build.table_ptrs(x, fused_cols.direct_tables(tables, h), {"cw": (h, 2), "cp": (2,)},
                             "cols_variant")
    with _build.on_device(x.device):
        return _build.library("probes").wgfft_cols_variant(
            x.data_ptr(), 0 if y is None else y.data_ptr(), *ptrs, x.shape[0], h,
            x.shape[2] // 2, *_build.chain_arg(radix.radix_chain(h)), int(adjoint),
            COLS_DESIGNS[design], tile, slots, torch.cuda.current_stream().cuda_stream)


def _cols_check(x, design, table, what):
    if design not in table:
        raise ValueError(f"{what}: design must be one of {sorted(table)}, got {design!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    fused_cols._check_cuda(x)


def _slots_arg(slots):
    return ctypes.cast(ctypes.pointer(slots), ctypes.POINTER(ctypes.c_int))


def cols_variant(x: torch.Tensor, tables: Dict[str, torch.Tensor], design: str,
                 adjoint: bool = False, tile: int = 0, inplace: bool = False) -> torch.Tensor:
    """K2's transform (its adjoint with ``adjoint``) along axis 1 of
    interleaved float32 ``x`` (pre, H, L) in ``design`` (``COLS_DESIGNS``)
    with tiles of ``tile`` columns (0: the design's own); with ``inplace``
    written over ``x``.  A CUDA tensor launches the probe kernel (and counts
    one launch) or raises where that variant does not exist; a CPU tensor
    runs ``fused_cols.fused_cols_reference``."""
    _cols_check(x, design, COLS_DESIGNS, "cols_variant")
    if x.device.type == "cpu":
        y = fused_cols.fused_cols_reference(x, tables, adjoint)
        return x.copy_(y) if inplace else y
    y = x if inplace else torch.empty_like(x)
    rc = _cols_call(x, tables, design, adjoint, tile, None, y)
    _build.check(rc, f"cols_variant {design} tile {tile}", "probes")
    cols_variant.launches += 1
    return y


def cols_variant_slots(x: torch.Tensor, tables: Dict[str, torch.Tensor], design: str,
                       tile: int = 0) -> int:
    """How many CTAs of the kernel ``cols_variant`` launches for ``x`` the
    current CUDA device holds at once (the occupancy calculator); launches
    nothing.  Needs the card."""
    _cols_check(x, design, COLS_DESIGNS, "cols_variant")
    slots = ctypes.c_int(0)
    rc = _cols_call(x, tables, design, False, tile, _slots_arg(slots), None)
    _build.check(rc, f"cols_variant {design} tile {tile}", "probes")
    return slots.value


class FixedVariant(NamedTuple):
    h: int
    tile: int                 # columns a tile
    cluster: int              # CTAs a tile (1: no cluster)
    threads: int              # a CTA
    minb: int                 # CTAs an SM asked for
    passes: Tuple[Tuple[int, ...], ...]   # radix_chain's entries, fused where grouped
    cross: int                # the last pass's radix across the cluster (0: none)


# in the order of the switch of csrc/probes/cols_fixed_variants.cu
FIXED_VARIANTS: Dict[str, FixedVariant] = {
    "1024 tile 4 16-8-8": FixedVariant(1024, 4, 1, 256, 4, ((16,), (8,), (8,)), 0),
    "1024 tile 8 16-8-8": FixedVariant(1024, 8, 1, 512, 2, ((16,), (8,), (8,)), 0),
    "1024 tile 4 cluster 2 16-8 + 8": FixedVariant(1024, 4, 2, 128, 8, ((16,), (8,)), 8),
    "1024 tile 8 cluster 2 16-8 + 8": FixedVariant(1024, 8, 2, 256, 4, ((16,), (8,)), 8),
    "1024 tile 8 cluster 4 16-8 + 8": FixedVariant(1024, 8, 4, 128, 8, ((16,), (8,)), 8),
    "1024 tile 16 cluster 8 16-8 + 8": FixedVariant(1024, 16, 8, 128, 8, ((16,), (8,)), 8),
    "2048 tile 2 16-16-8": FixedVariant(2048, 2, 1, 256, 4, ((16,), (16,), (8,)), 0),
    "2048 tile 4 16-16-8": FixedVariant(2048, 4, 1, 512, 2, ((16,), (16,), (8,)), 0),
    "2048 tile 4 cluster 2 16-16 + 8": FixedVariant(2048, 4, 2, 256, 4, ((16,), (16,)), 8),
    "2048 tile 4 cluster 4 16-16 + 8": FixedVariant(2048, 4, 4, 128, 8, ((16,), (16,)), 8),
    "2048 tile 8 cluster 4 16-16 + 8": FixedVariant(2048, 8, 4, 256, 4, ((16,), (16,)), 8),
    "2048 tile 2 cluster 2 16-16 + 8": FixedVariant(2048, 2, 2, 128, 8, ((16,), (16,)), 8),
    "4096 tile 4 cluster 2 16-16 + 16": FixedVariant(4096, 4, 2, 512, 2, ((16,), (16,)), 16),
    "4096 tile 4 cluster 4 16-16 + 16": FixedVariant(4096, 4, 4, 256, 4, ((16,), (16,)), 16),
    "4096 tile 2 cluster 2 16-16 + 16": FixedVariant(4096, 2, 2, 256, 4, ((16,), (16,)), 16),
    "4096 tile 4 cluster 8 16-16 + 16": FixedVariant(4096, 4, 8, 128, 8, ((16,), (16,)), 16),
    "8192 tile 4 cluster 4 16-8-8 + 8": FixedVariant(8192, 4, 4, 512, 2, ((16,), (8,), (8,)), 8),
    "8192 tile 4 cluster 8 16-8-8 + 8": FixedVariant(8192, 4, 8, 256, 4, ((16,), (8,), (8,)), 8),
    "8192 tile 2 cluster 4 16-8-8 + 8": FixedVariant(8192, 2, 4, 256, 4, ((16,), (8,), (8,)), 8),
    "16384 tile 4 cluster 8 16-16-8 + 8": FixedVariant(16384, 4, 8, 512, 2, ((16,), (16,), (8,)), 8),
    "16384 tile 2 cluster 8 16-16-8 + 8": FixedVariant(16384, 2, 8, 256, 4, ((16,), (16,), (8,)), 8),
    "16384 tile 4 cluster 4 16-16-8 + 8": FixedVariant(16384, 4, 4, 512, 1, ((16,), (16,), (8,)), 8),
    "16384 tile 8 cluster 8 16-16-8 + 8": FixedVariant(16384, 8, 8, 512, 1, ((16,), (16,), (8,)), 8),
    "1352 tile 4 13-13-8": FixedVariant(1352, 4, 1, 256, 3, ((13,), (13,), (8,)), 0),
    "1352 tile 2 13-13-8": FixedVariant(1352, 2, 1, 128, 6, ((13,), (13,), (8,)), 0),
    "1352 tile 4 cluster 2 13-13 + 8": FixedVariant(1352, 4, 2, 256, 4, ((13,), (13,)), 8),
    "1352 tile 8 cluster 4 13-13 + 8": FixedVariant(1352, 8, 4, 256, 4, ((13,), (13,)), 8),
    "1352 tile 4 cluster 4 13-13 + 8": FixedVariant(1352, 4, 4, 128, 8, ((13,), (13,)), 8),
    "2310 tile 4 11-7-5x3x2": FixedVariant(2310, 4, 1, 448, 1, ((11,), (7,), (5, 3, 2)), 0),
    "2310 tile 2 cluster 2 11-7-5x3 + 2": FixedVariant(2310, 2, 2, 128, 5, ((11,), (7,), (5, 3)), 2),
    "2310 tile 1 11-7-5x3x2": FixedVariant(2310, 1, 1, 128, 5, ((11,), (7,), (5, 3, 2)), 0),
    "2310 tile 4 cluster 2 11-7-5x3 + 2": FixedVariant(2310, 4, 2, 256, 2, ((11,), (7,), (5, 3)), 2),
    "2310 tile 2 11-7-5x3-2": FixedVariant(2310, 2, 1, 224, 3, ((11,), (7,), (5, 3), (2,)), 0),
    "2310 tile 2 11-7-5-3-2": FixedVariant(2310, 2, 1, 224, 3, ((11,), (7,), (5,), (3,), (2,)), 0),
    "360 tile 16 8-5x3-3": FixedVariant(360, 16, 1, 384, 2, ((8,), (5, 3), (3,)), 0),
    "360 tile 16 8-5-3x3": FixedVariant(360, 16, 1, 384, 2, ((8,), (5,), (3, 3)), 0),
    "360 tile 8 8-5x3-3": FixedVariant(360, 8, 1, 192, 4, ((8,), (5, 3), (3,)), 0),
    "360 tile 16 8-5-3-3": FixedVariant(360, 16, 1, 384, 2, ((8,), (5,), (3,), (3,)), 0),
    "64 tile 16 8-8": FixedVariant(64, 16, 1, 128, 8, ((8,), (8,)), 0),
    "128 tile 8 16-8": FixedVariant(128, 8, 1, 64, 16, ((16,), (8,)), 0),
    "128 tile 16 16-8": FixedVariant(128, 16, 1, 128, 8, ((16,), (8,)), 0),
    "128 tile 32 16-8": FixedVariant(128, 32, 1, 256, 4, ((16,), (8,)), 0),
    "256 tile 8 16-16": FixedVariant(256, 8, 1, 128, 8, ((16,), (16,)), 0),
    "256 tile 16 16-16": FixedVariant(256, 16, 1, 256, 4, ((16,), (16,)), 0),
    "256 tile 32 16-16": FixedVariant(256, 32, 1, 512, 2, ((16,), (16,)), 0),
    "512 tile 4 8-8-8": FixedVariant(512, 4, 1, 128, 8, ((8,), (8,), (8,)), 0),
    "512 tile 8 8-8-8": FixedVariant(512, 8, 1, 256, 4, ((8,), (8,), (8,)), 0),
    "512 tile 16 8-8-8": FixedVariant(512, 16, 1, 512, 2, ((8,), (8,), (8,)), 0),
    "2310 tile 1 cluster 2 11-7-5x3 + 2": FixedVariant(2310, 1, 2, 128, 8, ((11,), (7,), (5, 3)), 2),
    "2310 tile 1 11-7-5x3x2 96 threads": FixedVariant(2310, 1, 1, 96, 8, ((11,), (7,), (5, 3, 2)), 0),
}


def _fixed_call(x, tables, variant, adjoint, slots, y):
    h = x.shape[1]
    ptrs = _build.table_ptrs(x, fused_cols.direct_tables(tables, h), {"cw": (h, 2), "cp": (2,)},
                             "cols_fixed_variant")
    with _build.on_device(x.device):
        return _build.library("probes").wgfft_cols_fixed(
            x.data_ptr(), 0 if y is None else y.data_ptr(), *ptrs, x.shape[0], h,
            x.shape[2] // 2, list(FIXED_VARIANTS).index(variant), int(adjoint), slots,
            torch.cuda.current_stream().cuda_stream)


def cols_fixed_variant(x: torch.Tensor, tables: Dict[str, torch.Tensor], variant: str,
                       adjoint: bool = False, inplace: bool = False) -> torch.Tensor:
    """K2's transform (its adjoint with ``adjoint``) of ``x`` (pre, H, L) in
    the fixed design's ``variant`` of ``FIXED_VARIANTS`` (whose height must
    be x's), with K2's tables (``cw`` of ``radix_chain(H)``); with
    ``inplace`` written over ``x``.  A CUDA tensor launches the probe kernel
    (and counts one launch); a CPU tensor runs
    ``fused_cols.fused_cols_reference``."""
    _cols_check(x, variant, FIXED_VARIANTS, "cols_fixed_variant")
    if x.shape[1] != FIXED_VARIANTS[variant].h:
        raise ValueError(f"cols_fixed_variant: {variant!r} runs H = "
                         f"{FIXED_VARIANTS[variant].h}, x has H = {x.shape[1]}")
    if x.device.type == "cpu":
        y = fused_cols.fused_cols_reference(x, tables, adjoint)
        return x.copy_(y) if inplace else y
    y = x if inplace else torch.empty_like(x)
    rc = _fixed_call(x, tables, variant, adjoint, None, y)
    _build.check(rc, f"cols_fixed_variant {variant}", "probes")
    cols_fixed_variant.launches += 1
    return y


def cols_fixed_slots(x: torch.Tensor, tables: Dict[str, torch.Tensor], variant: str) -> int:
    """How many CTAs (clusters, for a cluster of 2 or more) of ``variant``'s
    kernel the current CUDA device holds at once; launches nothing.  Needs
    the card."""
    _cols_check(x, variant, FIXED_VARIANTS, "cols_fixed_variant")
    slots = ctypes.c_int(0)
    rc = _fixed_call(x, tables, variant, False, _slots_arg(slots), None)
    _build.check(rc, f"cols_fixed_variant {variant}", "probes")
    return slots.value


cols_variant.launches = 0
cols_fixed_variant.launches = 0
