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
(``core/radix.py``) and reads only the ``cw`` and ``cp`` tables (laid out
for ``cols_chain(H)``: the general or the cluster design's chain where
``GENERAL_COLS`` or ``CLUSTER_COLS`` names H, ``radix.radix_chain(H)`` at
every other height);
``fused_cols_chain_reference`` is its pass schedule on the CPU, a test aid.

Which of K2's five designs a view runs is K2's rule, ``cols_rule`` here
and ``cols_rule`` in ``csrc/cols.cuh``: the fixed design
(``csrc/cols_fixed.cuh``, a kernel per height, tile and cluster size) for
the heights and column counts of ``FIXED_COLS``, the general design
(``csrc/cols_general.cuh``, a run-time chain of two to four passes, a
kernel per class of points a thread) for the heights of ``GENERAL_COLS``,
read from that header's table, the cluster design (``csrc/cluster.cuh``,
shared with K1: the general design's passes on a tile split over a
thread-block cluster) for the heights of ``CLUSTER_COLS``, read from that
header, else the direct design or the ring by the tile alone.  ``launch_shape`` asks the card's copy and raises where the
two disagree.

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
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import dft, radix
from .. import _build
from ..utils import factors

MAX_SUB = 128
CUDA_ERROR_INVALID_VALUE = 1
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
        **radix.chain_consts(h, direction, scale, prefix, cols_chain(h)),
    }


def tables_from_reference(np_consts: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """This kernel's tables from the JAX package's ``cols_consts`` under
    ``prefix``: its six tables pass through, and ``cw``/``cp`` are built anew
    (``cw`` for ``cols_chain``) from what they say: H from their shapes, the scale from
    DFT(h1)[0, 0] * scale = ``w1re[0, 0]`` and the direction from the sign of
    Im W_H^1 (``tim[1, 1]``, or ``w1im[1, 1]`` when h2 = 1)."""
    out = {f"{prefix}/{k}": np_consts[f"{prefix}/{k}"] for k in PLAIN_TABLE_NAMES}
    w1re, w1im, tim = (np_consts[f"{prefix}/{k}"] for k in ("w1re", "w1im", "tim"))
    h1, h2 = w1re.shape[0], np_consts[f"{prefix}/w2re"].shape[0]
    im = tim[1, 1, 0] if h2 > 1 else w1im[1, 1]
    direction = "forward" if im < 0 else "inverse"
    out.update(radix.chain_consts(h1 * h2, direction, w1re[0, 0], prefix, cols_chain(h1 * h2)))
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
    with the chain and tables the kernel gets; at a height of the cluster
    design its split over the cluster of the view's entry,
    ``radix.cluster_chain_reference``): a test aid, on no plan path."""
    pre, h, lanes = x.shape
    entry = next((g for g in CLUSTER_COLS
                  if g.h == h and g.least <= pre * (lanes // 2) <= g.most), None)
    if entry is not None:
        y = radix.cluster_chain_reference(x.reshape(pre, h, lanes // 2, 2), entry.chain,
                                          entry.clusters, tables, adjoint)
    else:
        y = radix.radix_chain_reference(x.reshape(pre, h, lanes // 2, 2),
                                        cols_chain(h), tables, adjoint)
    return y.reshape(pre, h, lanes)


# K2's designs, as the C entry point numbers them (csrc/cols.cuh, ColsDesign)
DESIGNS = ("direct", "ring", "ring-async", "fixed", "general", "cluster")
RING_MIN_POINTS = 8192   # kRingMinPoints (csrc/stage.cuh)
RING_MIN_COLS = 4        # kRingMinCols (csrc/cols.cuh)
MAX_TILE_ELEMS = 16384   # kMaxTileElems (csrc/cols.cuh)
SHARED_BYTES = 232448    # kRingShared (csrc/stage.cuh): the most a CTA may opt in to
RING_BAR_BYTES = 128     # kRingBarBytes
H100_SMS = 132


class FixedCols(NamedTuple):
    """An entry of K2's rule for its fixed design (``kFixedCols``,
    csrc/cols_fixed.cuh, and case i of the switch of csrc/cols_fixed.cu):
    height ``h`` in tiles of ``tile`` columns split over ``cluster`` CTAs
    of ``threads`` threads, for views of ``least`` to ``most`` columns in
    all (pre * cols).  ``passes`` groups radix_chain(h)'s entries into the
    kernel's passes (a group is one butterfly); with a cluster, ``cross``
    is the last entry, the pass across the cluster."""
    h: int
    tile: int
    cluster: int
    threads: int
    least: int
    most: int
    passes: Tuple[Tuple[int, ...], ...]
    cross: int = 0

    @property
    def chain(self) -> Tuple[int, ...]:
        return tuple(r for g in self.passes for r in g) + ((self.cross,) if self.cross else ())


# the rule's entries, in the order of kFixedCols and of the switch of
# csrc/cols_fixed.cu
ALL_COLUMNS = radix.ALL_COLUMNS   # kAllColumns: an entry with no upper end
FIXED_COLS = (
    FixedCols(64, 16, 1, 128, 1, ALL_COLUMNS, ((8,), (8,)), 0),
    FixedCols(128, 32, 1, 256, 1, ALL_COLUMNS, ((16,), (8,)), 0),
    FixedCols(256, 8, 1, 128, 1, 1024, ((16,), (16,)), 0),
    FixedCols(256, 32, 1, 512, 1025, ALL_COLUMNS, ((16,), (16,)), 0),
    FixedCols(360, 16, 1, 384, 1, ALL_COLUMNS, ((8,), (5,), (3, 3)), 0),
    FixedCols(512, 8, 1, 256, 1, ALL_COLUMNS, ((8,), (8,), (8,)), 0),
    FixedCols(1024, 8, 1, 512, 1, ALL_COLUMNS, ((16,), (8,), (8,)), 0),
    FixedCols(1352, 4, 4, 128, 1, ALL_COLUMNS, ((13,), (13,)), 8),
    FixedCols(2048, 4, 4, 128, 1, 128, ((16,), (16,)), 8),
    FixedCols(2048, 8, 4, 256, 129, ALL_COLUMNS, ((16,), (16,)), 8),
    FixedCols(2310, 1, 1, 128, 1, ALL_COLUMNS, ((11,), (7,), (5, 3, 2)), 0),
    FixedCols(4096, 4, 8, 128, 1, ALL_COLUMNS, ((16,), (16,)), 16),
    FixedCols(8192, 4, 8, 256, 1, ALL_COLUMNS, ((16,), (8,), (8,)), 8),
    FixedCols(16384, 8, 8, 512, 1, 128, ((16,), (16,), (8,)), 8),
    FixedCols(16384, 4, 8, 512, 129, ALL_COLUMNS, ((16,), (16,), (8,)), 8),
)


class GeneralCols(NamedTuple):
    """An entry of K2's rule for its general design (``WGFFT_GENERAL_COLS``,
    csrc/cols_general.cuh): height ``h`` for views of ``least`` to ``most``
    columns in all (pre * cols), in the class of ``points`` (the most points
    a thread holds) with tiles of ``tile`` columns, on ``chain``."""
    h: int
    least: int
    most: int
    points: int
    tile: int
    chain: Tuple[int, ...]


GENERAL_HEADER = _build.CSRC / "cols_general.cuh"


def read_general_cols(text: str) -> Tuple[GeneralCols, ...]:
    """The entries of ``WGFFT_GENERAL_COLS(X)`` in the text of
    csrc/cols_general.cuh, in order: the one copy of the general design's
    table, which the C rule compiles and this module reads."""
    return tuple(GeneralCols(*v[:5], tuple(v[5:]))
                 for v in radix.read_table(text, "WGFFT_GENERAL_COLS"))


# the general design's entries, in the order of kGeneralCols
GENERAL_COLS = read_general_cols(GENERAL_HEADER.read_text())
_GENERAL_CHAINS = {g.h: g.chain for g in GENERAL_COLS}


class ClusterCols(NamedTuple):
    """An entry of K2's rule for its cluster design (``WGFFT_CLUSTER_COLS``,
    csrc/cluster.cuh): height ``h`` for views of ``least`` to ``most``
    columns in all (pre * cols), in the class of ``points`` with tiles of
    ``tile`` columns split over ``clusters`` CTAs, on ``chain`` (its first
    radix across the cluster)."""
    h: int
    least: int
    most: int
    points: int
    tile: int
    clusters: int
    chain: Tuple[int, ...]


# the cluster design's entries, in the order of kClusterCols: read from
# csrc/cluster.cuh, which chip_probes/k2_general_variants.py --cluster --fit
# writes
CLUSTER_COLS = tuple(ClusterCols(*e[:6], tuple(e[6:])) for e in radix.read_table(
    radix.CLUSTER_HEADER.read_text(), "WGFFT_CLUSTER_COLS"))
_CLUSTER_CHAINS = {g.h: g.chain for g in CLUSTER_COLS}
GENERAL_MAX_TILE = 64        # general_cols::kMaxTile
GENERAL_MAX_SHARED = 227 << 10


def cols_chain(h: int) -> Tuple[int, ...]:
    """K2's chain for height ``h``: the general or the cluster design's
    where ``GENERAL_COLS`` or ``CLUSTER_COLS`` names ``h``,
    ``radix.radix_chain(h)`` (the direct design's, the ring's and the fixed
    design's) everywhere else.  K2's ``cw`` table is laid out for this
    chain."""
    return _GENERAL_CHAINS.get(h) or _CLUSTER_CHAINS.get(h) or radix.radix_chain(h)


def general_cols_shared(h: int, chain, tile: int) -> int:
    """Bytes of shared memory a CTA of the general design takes for
    ``chain`` down a tile of ``tile`` columns: the exchanges' buffers (two,
    one for a chain of two passes) of the longest exchange's rows, one row
    of padding in every ns * R rows after a pass of even radix R where the
    tile is narrower than 16 columns (the C ``make_plan``)."""
    pitch, ns = h, 1
    for r in chain[:-1]:
        if tile < 16 and r % 2 == 0:
            pitch = max(pitch, h + (h - 1) // (ns * r))
        ns *= r
    return (2 if len(chain) > 2 else 1) * pitch * tile * 8


def general_cols_threads(h: int, chain, points: int, tile: int) -> Optional[int]:
    """Threads a CTA of the general design takes for ``chain`` down a tile
    of ``tile`` columns with at most ``points`` points a thread: enough that
    every pass's butterflies fit in points // R rounds; None where the C
    ``make_plan`` refuses the shape (no class, a radix outside the class's,
    not two to four passes multiplying to ``h``, a tile that is no power of
    two up to 64, too many threads for the class, over 227 KB of shared
    memory)."""
    least, most = radix.GENERAL_CLASSES.get(points, (points + 1, 0))
    if (not 2 <= len(chain) <= 4 or int(np.prod(chain)) != h
            or any(r not in radix.GENERAL_RADICES or not least <= r <= points for r in chain)
            or not 1 <= tile <= GENERAL_MAX_TILE or tile & (tile - 1)
            or general_cols_shared(h, chain, tile) > GENERAL_MAX_SHARED):
        return None
    threads = max(-(-(tile * (h // r)) // (points // r)) for r in chain)
    return threads if threads <= most else None


def direct_tables(tables: Dict[str, torch.Tensor], h: int) -> Dict[str, torch.Tensor]:
    """K2's tables for height ``h`` (``cols_consts``, ``cw`` laid out for
    ``cols_chain(h)``) with ``cw`` laid out for ``radix.radix_chain(h)``
    instead, for the probes that run the direct design, the ring or the
    fixed design at any height: ``tables`` itself where the two chains
    agree, else a copy whose ``cw`` is built for the direction that
    ``cp``'s sign gives, on ``cw``'s device."""
    if cols_chain(h) == radix.radix_chain(h):
        return tables
    direction = "forward" if float(tables["cp"][1]) < 0 else "inverse"
    return {**tables, "cw": radix._direct_twiddles(h, direction, str(tables["cw"].device))}


class ColsLaunch(NamedTuple):
    """What K2's entry point launches for a view: ``design`` (one of
    ``DESIGNS``), ``tile`` (columns a tile), ``cluster`` (CTAs a tile, 1
    where no cluster splits a tile), ``units`` (tiles), ``grid`` (CTAs
    launched) and ``threads`` (a CTA)."""
    design: str
    tile: int
    cluster: int
    units: int
    grid: int
    threads: int


def _stage_points(points: int) -> int:
    return (points + points // 16 + 15) // 16 * 16


def _ring_fits(points: int) -> bool:
    return RING_BAR_BYTES + 2 * _stage_points(points) * 8 <= SHARED_BYTES


def _per_thread(e: int, r: int) -> int:
    return max(e // r, 1)


def _threads_needed(chain, n: int, e: int, units: int) -> int:
    t = 1
    for r in chain:
        per = _per_thread(e, r)
        t = max(t, -(-(units * (n // r)) // per))
    return t


def _tile_direct(chain, h: int, cols: int) -> int:
    tc = 16 if len(chain) > 1 else 32
    while tc > 1 and h * tc > MAX_TILE_ELEMS:
        tc >>= 1
    while tc > 1 and tc // 2 >= cols:
        tc >>= 1
    return tc


def _tile_ring(chain, h: int, cols: int) -> int:
    tc = _tile_direct(chain, h, cols)
    while tc > 1 and not _ring_fits(h * tc):
        tc >>= 1
    return tc if len(chain) >= 2 and _ring_fits(h * tc) else 0


def _shape(need) -> Optional[Tuple[int, int]]:
    """(points a thread, threads) of ``cols_shape`` / ``cluster_shape``:
    the least of 8, 16, 32 points a thread whose threads fit 512 (1024 as
    the last resort); None where none does."""
    e, t = 8, need(8)
    while t > 512 and e < 32:
        e *= 2
        t = need(e)
    return None if t > 1024 else (e, (t + 31) // 32 * 32)


def _plan(chain, h: int, pre: int, cols: int, design: str, tile: int) -> Optional[ColsLaunch]:
    """``cols_plan`` of csrc/cols.cuh: the direct design or the ring with
    tiles of ``tile`` columns (0: the design's own), or None where it does
    not exist.  ``grid`` is the units (the ring's persistent grid is the
    rule's)."""
    if pre < 1 or cols < 1 or tile < 0 or tile & (tile - 1) or design not in DESIGNS[:3]:
        return None
    ring = design != "direct"
    tc = tile or (_tile_ring(chain, h, cols) if ring else _tile_direct(chain, h, cols))
    if ring and (len(chain) < 2 or not _ring_fits(h * tc)):
        return None
    if not ring and len(chain) > 1 and h * tc * 8 > SHARED_BYTES:
        return None
    shape = None if tc < 1 else _shape(lambda e: _threads_needed(chain, h, e, tc))
    if shape is None:
        return None
    units = pre * -(-cols // tc)
    if units > 0x7fffffff:
        return None
    return ColsLaunch(design, tc, 1, units, units, shape[1])


def _design(chain, h: int, cols: int) -> str:
    """The direct design or the ring, chosen by the tile alone (``cols_design``)."""
    old = _tile_direct(chain, h, cols)
    tc = _tile_ring(chain, h, cols)
    return ("ring" if h * old >= RING_MIN_POINTS and tc > 0 and tc >= min(old, RING_MIN_COLS)
            else "direct")


def cols_rule(pre: int, h: int, cols: int, sms: int = H100_SMS) -> ColsLaunch:
    """K2's rule, the Python copy of ``cols_rule`` in csrc/cols.cuh: what the
    entry point launches for a (pre, h, cols) view on a device of ``sms``
    SMs.  A height of ``FIXED_COLS`` whose view's columns in all (pre *
    cols) fall in an entry's range runs that entry of the fixed design;
    every other view the direct design or the ring at its own tile, the
    ring on one CTA an SM.  A height of ``GENERAL_COLS`` runs the entry
    whose range holds pre * cols in the general design, one of
    ``CLUSTER_COLS`` in the cluster design.  Raises ValueError for a view
    the rule does not cover."""
    chain = radix.radix_chain(h)
    if sms < 1 or pre < 1 or cols < 1:
        raise ValueError(f"fused_cols: no design runs ({pre}, {h}, {2 * cols})")
    for f in FIXED_COLS:
        if f.h != h:
            continue
        if f.chain != chain:
            raise ValueError(f"fused_cols: the fixed entry of H = {h} runs {f.chain}")
        if f.least <= pre * cols <= f.most:
            units = pre * -(-cols // f.tile)
            if units * f.cluster > 0x7fffffff:
                raise ValueError(f"fused_cols: no design runs ({pre}, {h}, {2 * cols})")
            return ColsLaunch("fixed", f.tile, f.cluster, units, units * f.cluster, f.threads)
    for g in GENERAL_COLS:
        if g.h != h or not g.least <= pre * cols <= g.most:
            continue
        threads = general_cols_threads(h, g.chain, g.points, g.tile)
        units = pre * -(-cols // g.tile)
        if threads is None or units > 0x7fffffff:
            raise ValueError(f"fused_cols: no design runs ({pre}, {h}, {2 * cols})")
        return ColsLaunch("general", g.tile, 1, units, units, threads)
    if h in _GENERAL_CHAINS:
        raise ValueError(f"fused_cols: no entry of the general design holds ({pre}, {h}, "
                         f"{2 * cols})")
    for g in CLUSTER_COLS:
        if g.h != h or not g.least <= pre * cols <= g.most:
            continue
        shape = radix.cluster_plan(h, g.chain, g.points, g.tile, g.clusters)
        units = pre * -(-cols // g.tile)
        if shape is None or units * g.clusters > 0x7fffffff:
            raise ValueError(f"fused_cols: no design runs ({pre}, {h}, {2 * cols})")
        return ColsLaunch("cluster", g.tile, g.clusters, units, units * g.clusters, shape[0])
    if h in _CLUSTER_CHAINS:
        raise ValueError(f"fused_cols: no entry of the cluster design holds ({pre}, {h}, "
                         f"{2 * cols})")
    design = _design(chain, h, cols)
    plan = _plan(chain, h, pre, cols, design, 0)
    if plan is None:
        raise ValueError(f"fused_cols: no design runs ({pre}, {h}, {2 * cols})")
    if design == "ring":
        plan = plan._replace(grid=min(plan.units, sms))
    return plan


def launch_shape(pre: int, h: int, cols: int) -> Tuple[ColsLaunch, int]:
    """``(launch, resident)`` for a (pre, h, cols) view on the current CUDA
    device: the C entry point's rule (``wgfft_fused_cols_plan``) and how many
    CTAs (clusters, where a cluster splits a tile) of its kernel the device holds
    at once.  Raises RuntimeError where the C rule and ``cols_rule``
    disagree, ValueError for a view no design runs.  Needs the card."""
    out = (ctypes.c_longlong * 7)()
    rc = _build.library().wgfft_fused_cols_plan(
        pre, h, cols, *_build.chain_arg(cols_chain(h)), 0, out)
    if rc == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"fused_cols: no design runs ({pre}, {h}, {2 * cols})")
    _build.check(rc, "fused_cols plan")
    got = ColsLaunch(DESIGNS[out[0]], *out[1:6])
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    want = cols_rule(pre, h, cols, sms)
    if got != want:
        raise RuntimeError(f"fused_cols: K2's rule in C gives {got} for ({pre}, {h}, {2 * cols}) "
                           f"on {sms} SMs, its Python copy {want}")
    return got, out[6]


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
                                  x.shape[2] // 2, *_build.chain_arg(cols_chain(h)),
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
