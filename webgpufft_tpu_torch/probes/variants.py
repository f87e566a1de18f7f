"""K2 in a design the caller names, the direct one or the ring; K1's
power-of-two, warp and mixed-radix designs in a variant the caller names.

No Pallas probe stands behind this module: it launches the counterpart of
K2 (``webgpufft_tpu/core/fused_cols.py:161``) in one of its designs by name,
for the one-run comparison of ``chip_probes/k1_k2_ring.py``.  The plans'
entry point picks the design by tile (``csrc/cols.cuh``, ``cols_design``;
``fused_cols.launch_shape`` says which it takes); here the caller does:
``cols_variant(x, tables, design)`` (``csrc/probes/cols_variants.cu``) with
``"direct"``, the direct design (a CTA loads its tile from global memory
straight into registers, runs the passes, stores; the only place it is still
launched where the ring serves a view); ``"ring"``, persistent CTAs with a
ring of two stages, a tile landing by a 3-D tensor map where its rows are
16-byte aligned and whole (``cp.async`` otherwise), as the plans run it;
``"ring-async"``, every tile landing row by row by ``cp.async``.

The ring designs take any chain of two or more passes whose tile fits two
stages, smaller tiles too.

``lines_variant(x, tables, variant)`` (``csrc/probes/lines_variants.cu``)
launches K1 (``webgpufft_tpu/core/fused.py:223``) in one instantiation of
its power-of-two design (``csrc/lines_pow2.cuh``: one line a CTA) or its
warp design (``csrc/lines_warp.cuh``: a line in the lanes of one warp)
named in ``LINES_VARIANTS``, or of its mixed-radix design
(``csrc/lines_mixed.cuh``: lines a CTA, threads, chain; built by
``csrc/probes/lines_mixed_variants.cu`` and ``lines_mixed_variants_long.cu``)
named in ``MIXED_VARIANTS``, with the twiddle table of its chain
(``lines_variant_tables``), for the comparison of
``chip_probes/k1_pow2_variants.py`` and ``chip_probes/k1_mixed_variants.py``.
The plans' entry point launches the variant K1's rule names
(``radix.POW2_LINES``, ``radix.WARP_LINES``, ``radix.MIXED_LINES``) and the
direct design elsewhere.

Each wrapper runs the kernel's plain version on a CPU tensor and launches or
raises on a CUDA tensor; ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
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


def _entry(variant: str):
    """(the variant's record, the probes library's entry point, its index)."""
    for table, entry in ((LINES_VARIANTS, "wgfft_lines_variant"),
                         (MIXED_VARIANTS, "wgfft_mixed_variant")):
        if variant in table:
            return table[variant], entry, list(table).index(variant)
    raise ValueError(f"lines_variant: variant must be one of "
                     f"{sorted(LINES_VARIANTS) + sorted(MIXED_VARIANTS)}, got {variant!r}")


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
    ``x`` (lines, N, 2) in the ``variant`` of ``LINES_VARIANTS`` or
    ``MIXED_VARIANTS``, whose N must be x's, with the variant's tables
    (``lines_variant_tables``); with ``inplace`` written over ``x``.  A CUDA
    tensor launches the probe kernel (and counts one launch); a CPU tensor
    runs the variant's chain through ``radix.radix_chain_reference``."""
    v, entry, index = _entry(variant)
    n, chain = v.n, v.chain
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lines_variant: unsupported device {x.device}")
    fused._check_cuda(x)
    if x.shape[1] != n:
        raise ValueError(f"lines_variant: {variant!r} runs N = {n}, x has N = {x.shape[1]}")
    if x.device.type == "cpu":
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


def cols_variant(x: torch.Tensor, tables: Dict[str, torch.Tensor], design: str,
                 adjoint: bool = False) -> torch.Tensor:
    """K2's transform (its adjoint with ``adjoint``) along axis 1 of
    interleaved float32 ``x`` (pre, H, L) in ``design``.  A CUDA tensor
    launches the probe kernel (and counts one launch); a CPU tensor runs
    ``fused_cols.fused_cols_reference``."""
    if design not in COLS_DESIGNS:
        raise ValueError(f"cols_variant: design must be one of {sorted(COLS_DESIGNS)}, "
                         f"got {design!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cols_variant: unsupported device {x.device}")
    fused_cols._check_cuda(x)
    if x.device.type == "cpu":
        return fused_cols.fused_cols_reference(x, tables, adjoint)
    h = x.shape[1]
    ptrs = _build.table_ptrs(x, tables, {"cw": (h, 2), "cp": (2,)}, "cols_variant")
    lib = _build.library("probes")
    y = torch.empty_like(x)
    with _build.on_device(x.device):
        rc = lib.wgfft_cols_variant(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0], h,
                                    x.shape[2] // 2, *_build.chain_arg(radix.radix_chain(h)),
                                    int(adjoint), COLS_DESIGNS[design],
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"cols_variant {design}", "probes")
    cols_variant.launches += 1
    return y


cols_variant.launches = 0
