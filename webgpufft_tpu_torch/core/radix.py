"""Host side of the radix-chain FFT that K1 and K2 run inside a CTA.

Both CUDA kernels (``csrc/fused_lines.cu``, ``csrc/fused_cols.cu``, sharing
``csrc/radix.cuh``) compute a length-N DFT as a Stockham autosort chain of
in-register butterflies, N = r_0 * r_1 * ... * r_{P-1} with every r_p in
``KERNEL_RADICES`` (``factors.SUPPORTED_RADICES`` and 16).  Pass p, with ns = r_0 * ... * r_{p-1}
(ns = 1 for the first pass), R = r_p and m = N / R, does for every
j in [0, m):

    k      = j mod ns
    v[r]   = in[j + r * m]                      r = 0 .. R-1
    v[r]  *= W_N^(r * k * N / (ns * R))         r = 1 .. R-1 (none when ns = 1)
    v      = DFT_R(v)
    out[(j - k) * R + k + r * ns] = v[r]

and the last pass leaves natural order.  The twiddles of all passes are one
table of N - 1 roots of unity laid out in the order the passes read them
(``chain_twiddles``), so neighbouring threads read neighbouring entries.

This module builds what the kernels need beyond the plain versions' tables
(``chain_consts``: the twiddle table and a two-float parameter table
holding the scale and the direction's sign), chooses the chain
(``radix_chain``; K1's own rule ``lines_chain``), and models the pass
schedule on the CPU with the same index maps, tables and butterfly algebra
as the CUDA code (``radix_chain_reference``): a test aid that no plan path
calls.

K1 has five designs (``csrc/fused_lines.cu``).  The lengths of
``POW2_LINES`` (256, 1024, 2048, 4096, 8192, 16384) run the power-of-two
design (``csrc/lines_pow2.cu``, a kernel per length, one line a CTA) on
three passes, the first of radix 32 at 8192 and 16384, 8 * 8 * 4 at 256;
the length of ``WARP_LINES`` (512) runs the warp design
(``csrc/lines_warp.cu``, a kernel per length, a line in the lanes of one
warp); the lengths of ``MIXED_LINES`` run the mixed-radix design
(``csrc/lines_mixed.cu``, a kernel per length, two to four passes of
radices up to 32, the composite ones, 6 to 30, each one butterfly in
registers: ``MIXED_RADICES``); the lengths of ``PACKED_LINES`` (128 points
or less) run the packed design (``csrc/lines_packed.cu``, a kernel per
length, a warp's lines landed in shared memory as one contiguous block and
run there, on ``radix_chain(n)``: ``packed_lines_reference`` models its
block-staged layout); every other length runs the direct design on
``radix_chain(n)``.  The C entry point holds the same tables
(``kPow2Lines``, ``kWarpLines``, ``kMixedLines``, ``kPackedLines``,
``csrc/lines.cuh``) and refuses any other chain at those lengths, so K1's
``cw`` table is laid out for ``lines_chain(n)``.  K2 runs ``radix_chain`` at
every height.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import factors

MAX_LENGTH = 16384   # 128 * 128: the longest line a CTA holds in shared memory
MAX_PASSES = 16      # room in the kernels' chain argument
TABLE_NAMES = ("cw", "cp")
# what the kernels have a butterfly for: the supported set and 16 = 4 * 4
KERNEL_RADICES = factors.SUPPORTED_RADICES + (16,)
# K1's rule: N -> the chain of the power-of-two design (csrc/lines_pow2.cu);
# the lengths where it ran fastest on the H100 (PERF.md): 1024, 2048 and
# 4096 on radix_chain's own chain (the same cw table), 8192 and 16384 in
# three passes where radix_chain takes four, 256 in three (8 * 8 * 4, 8
# points a thread) where radix_chain takes two
POW2_LINES = {256: (8, 8, 4), 1024: (16, 8, 8), 2048: (16, 16, 8), 4096: (16, 16, 16),
              8192: (32, 16, 16), 16384: (32, 32, 16)}
# and N -> the chain of the warp design (csrc/lines_warp.cu), where it ran
# fastest: 512, on radix_chain's own chain (32, its other length until the
# packed design, runs that design now)
WARP_LINES = {512: (8, 8, 8)}
# and N -> the chain of the mixed-radix design (csrc/lines_mixed.cu): the
# lengths that are not powers of two where its sweep on the H100 ran faster
# than the direct design (PERF.md), each in two to four passes where
# radix_chain takes three to five (1352 in radix_chain's own three)
MIXED_LINES = {360: (20, 18), 1000: (10, 10, 10), 1352: (13, 13, 8), 1536: (8, 8, 24),
               2079: (27, 7, 11), 2310: (22, 15, 7), 3000: (10, 10, 30), 3072: (32, 4, 24),
               5120: (16, 16, 20), 6000: (24, 25, 10), 6144: (32, 24, 8), 8232: (8, 21, 7, 7),
               9216: (32, 24, 12), 12288: (32, 32, 12), 15360: (32, 32, 15)}
# and N -> the chain of the packed design (csrc/lines_packed.cu): the short
# lengths where its sweep on the H100 ran faster than the direct design at
# both line counts (PERF.md), each on radix_chain's own chain (the same cw
# table)
PACKED_LINES = {4: (4,), 6: (3, 2), 8: (8,), 9: (3, 3), 10: (5, 2), 12: (4, 3), 14: (7, 2),
                15: (5, 3), 16: (16,), 18: (3, 3, 2), 20: (5, 4), 21: (7, 3), 22: (11, 2),
                24: (8, 3), 25: (5, 5), 26: (13, 2), 27: (3, 3, 3), 28: (7, 4), 30: (5, 3, 2),
                32: (8, 4), 33: (11, 3), 35: (7, 5), 36: (4, 3, 3), 39: (13, 3), 40: (8, 5),
                42: (7, 3, 2), 44: (11, 4), 45: (5, 3, 3), 48: (16, 3), 49: (7, 7),
                50: (5, 5, 2), 52: (13, 4), 54: (3, 3, 3, 2), 55: (11, 5), 56: (8, 7),
                60: (5, 4, 3), 63: (7, 3, 3), 64: (8, 8), 65: (13, 5), 66: (11, 3, 2),
                70: (7, 5, 2), 72: (8, 3, 3), 75: (5, 5, 3), 77: (11, 7), 78: (13, 3, 2),
                80: (16, 5), 81: (3, 3, 3, 3), 84: (7, 4, 3), 88: (11, 8), 90: (5, 3, 3, 2),
                91: (13, 7), 98: (7, 7, 2), 99: (11, 3, 3), 100: (5, 5, 4), 104: (13, 8),
                105: (7, 5, 3), 110: (11, 5, 2), 112: (16, 7), 117: (13, 3, 3), 121: (11, 11),
                125: (5, 5, 5), 126: (7, 3, 3, 2)}
# the composite radices the mixed-radix design has a butterfly for (R = A * B,
# lines_mixed.cuh), beside KERNEL_RADICES and 32
MIXED_RADICES = (6, 9, 10, 12, 14, 15, 18, 20, 21, 22, 24, 25, 26, 27, 28, 30)


@lru_cache(maxsize=None)
def radix_chain(n: int) -> Tuple[int, ...]:
    """The radices of the passes for length ``n``, largest first; their
    product is ``n``.

    The odd primes come from ``factors.factorize_supported_radices``.  The
    power of two 2^a is spread over ceil(a / 4) passes as evenly as it goes,
    in radices up to 16 (2^8 = 16 * 16, 2^10 = 16 * 8 * 8, 2^5 = 8 * 4): an
    inner pass costs a trip through shared memory and two barriers whatever
    its radix, so fewer, wider passes win as long as a butterfly's points fit
    a thread's registers."""
    greedy = factors.factorize_supported_radices(n)
    if not greedy or n < 2:
        raise ValueError(f"radix_chain: {n} is not a product of {KERNEL_RADICES}")
    chain = [r for r in greedy if r % 2]
    a = (n // math.prod(chain)).bit_length() - 1
    passes = -(-a // 4)
    chain += [1 << (a // passes + (i < a % passes)) for i in range(passes)]
    chain.sort(reverse=True)
    if len(chain) > MAX_PASSES:
        raise ValueError(f"radix_chain: {n} needs {len(chain)} passes, over {MAX_PASSES}")
    return tuple(chain)


_DESIGNS = {"pow2": POW2_LINES, "warp": WARP_LINES, "mixed": MIXED_LINES,
            "packed": PACKED_LINES}


def lines_chain(n: int) -> Tuple[int, ...]:
    """K1's chain for length ``n``: the power-of-two, the warp, the
    mixed-radix or the packed design's where ``POW2_LINES``, ``WARP_LINES``,
    ``MIXED_LINES`` or ``PACKED_LINES`` names ``n``, ``radix_chain(n)`` (the
    direct design's) everywhere else.  K1's ``cw`` table is laid out for this
    chain."""
    return next((table[n] for table in _DESIGNS.values() if n in table), None) or radix_chain(n)


def lines_design(n: int) -> str:
    """The design K1's entry point launches for length ``n``: ``"pow2"``,
    ``"warp"``, ``"mixed"``, ``"packed"`` or ``"direct"``."""
    return next((name for name, table in _DESIGNS.items() if n in table), "direct")


def lines_in_place(n: int) -> bool:
    """May K1 run length ``n`` in place (y = x)?  At every length of the
    packed design, whose warps read their whole block before they write it
    back, and wherever the chain has two passes or more (a barrier after the
    first pass separates the last read from the first write); a one-pass
    chain of the other designs is refused."""
    return n in PACKED_LINES or len(lines_chain(n)) > 1


def roots_table(n: int, direction: str) -> np.ndarray:
    """The n-th roots of unity W^j = exp(-+ 2*pi*i*j/n), j in [0, n), as
    float32 (n, 2) pairs, rounded once from float64."""
    sign = -1.0 if direction == "forward" else 1.0
    # cos and sin of a real angle: a complex exp divides a complex by n and
    # lands a quarter turn of n = 8232 at 2.8e-16 where cos gives 6.1e-17
    ang = sign * 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def chain_twiddles(n: int, direction: str, radices: Sequence[int]) -> np.ndarray:
    """The roots table gathered into pass order, float32 (n, 2).

    Pass p (ns, R) owns entries [ns - 1, ns * R - 1): entry
    ns - 1 + (r - 1) * ns + k is W^(r * k * n / (ns * R)) for r in [1, R),
    k in [0, ns).  The passes' blocks tile [0, n - 1); the last entry is 1."""
    roots = roots_table(n, direction)
    index = np.zeros(n, dtype=np.int64)
    ns = 1
    for radix in radices:
        step = n // (ns * radix)
        r = np.arange(1, radix)[:, None]
        k = np.arange(ns)[None, :]
        index[ns - 1:ns * radix - 1] = (r * k * step).reshape(-1)
        ns *= radix
    if ns != n:
        raise ValueError(f"chain_twiddles: radices {tuple(radices)} do not multiply to {n}")
    return np.ascontiguousarray(roots[index])


def chain_consts(n: int, direction: str, scale: float, prefix: str,
                 chain: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
    """What the CUDA kernels read, from n, direction and scale alone:
    ``cw`` the twiddles (n, 2) in the order of ``chain`` (default
    ``radix_chain(n)``, K2's and K1's direct design's), and ``cp`` =
    [scale, sign] with sign -1 for forward and +1 for inverse."""
    sign = -1.0 if direction == "forward" else 1.0
    return {
        f"{prefix}/cw": chain_twiddles(n, direction, chain or radix_chain(n)),
        f"{prefix}/cp": np.array([scale, sign], dtype=np.float32),
    }


@lru_cache(maxsize=None)
def _direct_twiddles(n: int, direction: str, device: str) -> torch.Tensor:
    return torch.as_tensor(chain_twiddles(n, direction, radix_chain(n)), device=device)


def direct_tables(tables: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """K1's tables for length ``n`` (``fused.lines_consts``, laid out for
    ``lines_chain(n)``) with ``cw`` laid out for the direct design's chain
    ``radix_chain(n)`` instead, for the probes that run that design at any
    length: ``tables`` itself where the two chains agree, else a copy whose
    ``cw`` is built for the direction that ``cp``'s sign gives, on ``cw``'s
    device."""
    if lines_chain(n) == radix_chain(n):
        return tables
    direction = "forward" if float(tables["cp"][1]) < 0 else "inverse"
    return {**tables, "cw": _direct_twiddles(n, direction, str(tables["cw"].device))}


# ---------------------------------------------------------------------------
# the CPU model of the kernels' pass schedule
# ---------------------------------------------------------------------------

def _muli(v: torch.Tensor, s: float) -> torch.Tensor:
    """v * (i * s) on (..., 2) pairs."""
    return torch.stack([-s * v[..., 1], s * v[..., 0]], dim=-1)


def _butterfly2(v, s):
    return [v[0] + v[1], v[0] - v[1]]


def _butterfly4(v, s):
    t0, t1 = v[0] + v[2], v[0] - v[2]
    t2, t3 = v[1] + v[3], _muli(v[1] - v[3], s)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def _butterfly8(v, s):
    h = float(np.float32(math.sqrt(0.5)))
    e = _butterfly4([v[0], v[2], v[4], v[6]], s)
    o = _butterfly4([v[1], v[3], v[5], v[7]], s)
    x, y = o[1][..., 0], o[1][..., 1]
    o[1] = torch.stack([h * (x - s * y), h * (s * x + y)], dim=-1)
    o[2] = _muli(o[2], s)
    x, y = o[3][..., 0], o[3][..., 1]
    o[3] = torch.stack([h * (-x - s * y), h * (s * x - y)], dim=-1)
    return [e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)]


def _rot(v, c, si):
    """v * (c + i * si) on (..., 2) pairs."""
    x, y = v[..., 0], v[..., 1]
    return torch.stack([x * c - y * si, x * si + y * c], dim=-1)


def _butterfly16(v, s):
    """16 = 4 x 4: radix-4 on the residue classes of r mod 4, rotation of
    G_b[d] by w16^(b d), radix-4 across the classes; X[d + 4 c]."""
    h = float(np.float32(math.sqrt(0.5)))
    c1 = float(np.float32(math.cos(math.pi / 8)))
    s1 = float(np.float32(math.sin(math.pi / 8)))
    g = [_butterfly4([v[b], v[b + 4], v[b + 8], v[b + 12]], s) for b in range(4)]
    g[1][1] = _rot(g[1][1], c1, s * s1)
    g[1][2] = _rot(g[1][2], h, s * h)
    g[1][3] = _rot(g[1][3], s1, s * c1)
    g[2][1] = _rot(g[2][1], h, s * h)
    g[2][2] = _muli(g[2][2], s)
    g[2][3] = _rot(g[2][3], -h, s * h)
    g[3][1] = _rot(g[3][1], s1, s * c1)
    g[3][2] = _rot(g[3][2], -h, s * h)
    g[3][3] = _rot(g[3][3], -c1, -s * s1)
    out = [None] * 16
    for d in range(4):
        t = _butterfly4([g[0][d], g[1][d], g[2][d], g[3][d]], s)
        for c in range(4):
            out[d + 4 * c] = t[c]
    return out


def _f32(a: float) -> float:
    """``a`` rounded to float32, as a Python float (the CUDA literals)."""
    return float(np.float32(a))


def _butterfly32(v, s):
    """32 = 2 x 16: radix-16 on the even and odd points, the odd half
    rotated by w32^q, one radix-2 layer; X[q], X[q + 16] = E[q] +- w32^q O[q]."""
    e = _butterfly16(v[0::2], s)
    o = _butterfly16(v[1::2], s)
    for q in range(1, 16):
        if q == 8:
            o[q] = _muli(o[q], s)
        else:
            ang = math.pi * q / 16
            o[q] = _rot(o[q], _f32(math.cos(ang)), s * _f32(math.sin(ang)))
    return [e[q] + o[q] for q in range(16)] + [e[q] - o[q] for q in range(16)]


def _butterfly_odd(v, s):
    """Odd prime R: pairs a_k = v[k] + v[R-k], b_k = v[k] - v[R-k];
    X[q], X[R-q] = m_q +- i*s*n_q with m_q = v[0] + sum cos(2 pi q k / R) a_k
    and n_q = sum sin(2 pi q k / R) b_k."""
    radix = len(v)
    half = (radix - 1) // 2
    ang = 2.0 * np.pi * np.arange(radix) / radix
    # f32 values as Python floats: a numpy scalar cannot multiply a CUDA tensor
    cos = np.cos(ang).astype(np.float32).tolist()
    sin = np.sin(ang).astype(np.float32).tolist()
    a = [None] + [v[k] + v[radix - k] for k in range(1, half + 1)]
    b = [None] + [v[k] - v[radix - k] for k in range(1, half + 1)]
    out = [None] * radix
    out[0] = v[0] + sum(a[1:])
    for q in range(1, half + 1):
        m = v[0] + sum(cos[(q * k) % radix] * a[k] for k in range(1, half + 1))
        n = _muli(sum(sin[(q * k) % radix] * b[k] for k in range(1, half + 1)), s)
        out[q], out[radix - q] = m + n, m - n
    return out


def _turn(m: int, r: int):
    """cos and sin of 2 pi m / r rounded to float32, as Python floats (the
    constants of the mixed-radix design's composite butterflies)."""
    return _f32(math.cos(2.0 * math.pi * m / r)), _f32(math.sin(2.0 * math.pi * m / r))


def _rotate(v, m: int, r: int, s: float):
    """v * w^m with w = exp(s 2 pi i / r): quarter turns exactly, every other
    root by its float32 cos and sin (``mixed::rotate``)."""
    if 4 * m == r:
        return _muli(v, s)
    if 2 * m == r:
        return -v
    if 4 * m == 3 * r:
        return _muli(v, -s)
    c, si = _turn(m, r)
    return _rot(v, c, s * si)


def _first_factor(r: int) -> int:
    """A of a composite radix R = A * B: the power of two in R where R is
    even, else its least prime factor (``mixed::first_factor``)."""
    return r & -r if r % 2 == 0 else next(p for p in (3, 5, 7) if r % p == 0)


def _butterfly_composite(v, s):
    """Composite R = A * B (the mixed-radix design's ``Dft``): with
    n = B * n1 + n2, B DFTs of A points on the classes n2, G[n2][k1] rotated
    by w_R^(n2 k1), then A DFTs of B points across the classes;
    X[k1 + A * k2]."""
    radix = len(v)
    a = _first_factor(radix)
    b = radix // a
    g = [_butterfly(v[n2::b], s) for n2 in range(b)]
    for n2 in range(1, b):
        for k1 in range(1, a):
            g[n2][k1] = _rotate(g[n2][k1], n2 * k1, radix, s)
    out = [None] * radix
    for k1 in range(a):
        t = _butterfly([g[n2][k1] for n2 in range(b)], s)
        for k2 in range(b):
            out[k1 + a * k2] = t[k2]
    return out


_BUTTERFLIES = {2: _butterfly2, 4: _butterfly4, 8: _butterfly8, 16: _butterfly16,
                32: _butterfly32, **{r: _butterfly_composite for r in MIXED_RADICES}}


def _butterfly(v, s):
    """The R-point butterfly of the kernels for R = len(v)."""
    return _BUTTERFLIES.get(len(v), _butterfly_odd)(v, s)


def conj_pairs(x: torch.Tensor) -> torch.Tensor:
    """The complex conjugate of (..., 2) pairs, a new tensor."""
    return torch.stack([x[..., 0], -x[..., 1]], dim=-1)


def tracked(x: torch.Tensor) -> bool:
    """Does anything differentiate or batch through ``x`` right now: reverse
    mode (``x`` requires grad under grad mode), forward mode (a dual level is
    open) or a ``torch.func`` transform?  When not, a kernel wrapper may skip
    ``torch.autograd.Function.apply`` and launch directly."""
    return ((x.requires_grad and torch.is_grad_enabled())
            or torch._C._are_functorch_transforms_active()
            or torch.autograd.forward_ad._current_level >= 0)


def plain(x: torch.Tensor) -> bool:
    """May a kernel wrapper launch on ``x`` directly, without the dispatcher:
    is it a plain tensor that no tracing mode sees (no fake or functional
    tensor, no dispatch mode on the stack, as under ``torch.export``)?"""
    return type(x) is torch.Tensor and torch._C._len_torch_dispatch_stack() == 0


def table_list(tables: Dict[str, torch.Tensor], names: Sequence[str],
               kernel: str) -> List[torch.Tensor]:
    """A pass op's table argument: ``tables`` in the order of ``names``."""
    for name in names:
        if name not in tables:
            raise ValueError(f"{kernel}: missing table {name!r}")
    return [tables[name] for name in names]


def register_pass_op(op) -> None:
    """The fake implementation and the autograd of a pass op (K1, K2): the
    output is a new contiguous tensor of x's shape, and the backward is the
    op's adjoint launch on the same tables (the pass is y = s F x, so
    g_x = s F^H g_y)."""
    op.register_fake(
        lambda x, tables, adjoint: torch.empty_like(x, memory_format=torch.contiguous_format))

    def setup_context(ctx, inputs, output):
        _, ctx.tables, ctx.adjoint = inputs

    def backward(ctx, g):
        return op(g.contiguous(), ctx.tables, not ctx.adjoint), [None] * len(ctx.tables), None

    op.register_autograd(backward, setup_context=setup_context)


def packed_pitch(n: int, radices: Sequence[int], lanes: int) -> int:
    """Points a line of ``n`` takes in a stage of the packed design
    (``Shape::P`` of ``csrc/lines_packed.cuh``): with ``lanes`` > 1 its
    exchanges' extent (one point of padding in every ns * R after a pass of
    even radix R, the last pass in natural order), with one lane a line n
    (the passes run in registers); for odd n that alone (no radix is even,
    so it is n), else the least pitch from there up that is 2 mod 4 (one
    lane a line) or ``lanes`` mod 2 ``lanes``."""
    extent, ns = n, 1
    for r in radices[:-1] if lanes > 1 else ():
        if r % 2 == 0:
            extent = max(extent, n + (n - 1) // (ns * r))
        ns *= r
    if n % 2:
        return extent
    modulus, want = (4, 2) if lanes == 1 else (2 * lanes, lanes)
    return next(p for p in range(extent, extent + modulus) if p % modulus == want)


def packed_lines_reference(x: torch.Tensor, radices: Sequence[int],
                           tables: Dict[str, torch.Tensor], adjoint: bool = False,
                           lanes: int = 1, wide: bool = True) -> torch.Tensor:
    """The packed design's block-staged schedule in plain torch, along axis 1
    of float32 ``x`` (lines, N, 2): the lines in blocks of B = 32 / ``lanes``
    (the last block ragged); point q of a block landed in its stage at
    (q // N) * P + q % N (``packed_pitch``), as the 16-byte copies of
    ``csrc/lines_packed.cuh`` land it where ``wide`` (point 2c + 1 beside
    point 2c, the last point of an odd count alone) and the 8-byte copies
    otherwise; what no copy lands is NaN (the dead lines of the last block,
    the padding); the chain (``radix_chain_reference``) on every line of
    every stage, written back in natural order; and the live points copied
    out by the same map.  Returns a new tensor of x's shape."""
    lines, n = x.shape[0], x.shape[1]
    block = 32 // lanes
    pitch = packed_pitch(n, radices, lanes)
    blocks = -(-lines // block)
    g = torch.arange(lines * n, device=x.device)
    b, q = g // (block * n), g % (block * n)             # block, point in it
    live = torch.clamp(lines - b * block, max=block) * n   # points of its block

    def at(i):
        return (i // n) * pitch + i % n

    if wide:
        pair = q - q % 2
        tail = (live % 2 == 1) & (q == live - 1)
        dst = torch.where(tail, at(q), at(pair) + q % 2)
    else:
        dst = at(q)
    dst = dst + b * block * pitch
    stage = torch.full((blocks * block * pitch, 2), float("nan"), device=x.device)
    stage[dst] = x.reshape(-1, 2)
    grid = stage.view(blocks * block, pitch, 2)
    grid[:, :n] = radix_chain_reference(grid[:, :n], radices, tables, adjoint)
    return stage[dst].reshape(x.shape)


def radix_chain_reference(x: torch.Tensor, radices: Sequence[int],
                          tables: Dict[str, torch.Tensor],
                          adjoint: bool = False, stop: Optional[int] = None) -> torch.Tensor:
    """The kernels' pass schedule in plain torch, along axis 1 of float32
    ``x`` (units, N, ..., 2): the same passes, index maps, twiddle table
    (``cw``) and butterfly algebra, the scale (``cp[0]``) applied in the
    last pass.  ``adjoint`` conjugates on the first load and the last store,
    as the kernels' adjoint launch does.  ``stop`` cuts the chain after that
    many passes (0 .. len(radices)) and returns what the next pass would
    read, unscaled unless every pass ran.  Returns a new tensor of x's
    shape."""
    n = x.shape[1]
    if math.prod(radices) != n:
        raise ValueError(f"radix_chain_reference: radices {tuple(radices)} do not multiply to {n}")
    tw = tables["cw"]
    scale, s = float(tables["cp"][0]), float(tables["cp"][1])
    ride = (1,) * (x.dim() - 3) + (2,)            # broadcast over what trails axis 1
    cur = conj_pairs(x) if adjoint else x
    if stop is None:
        stop = len(radices)
    if not 0 <= stop <= len(radices):
        raise ValueError(f"radix_chain_reference: stop {stop} outside [0, {len(radices)}]")
    if stop < len(radices):
        scale = 1.0
    ns = 1
    for radix in radices[:stop]:
        m = n // radix
        # butterfly j = q * ns + k reads points j + r * m (a slice a radix
        # r), twiddled by W^(r * k * n / (ns * radix)) (entry
        # ns - 1 + (r - 1) * ns + k, the same for every q), and writes its
        # output r to (q * radix + r) * ns + k: plain slices and views, so
        # that no gather or scatter runs
        v = [cur[:, r * m:(r + 1) * m] for r in range(radix)]
        if ns > 1:
            for r in range(1, radix):
                row = tw[ns - 1 + (r - 1) * ns:ns - 1 + r * ns]
                w = row.repeat(m // ns, 1).reshape(1, m, *ride)
                wr, wi = w[..., 0], w[..., 1]
                vr, vi = v[r][..., 0], v[r][..., 1]
                v[r] = torch.stack([vr * wr - vi * wi, vr * wi + vi * wr], dim=-1)
        v = _butterfly(v, s)
        out = torch.empty(cur.shape, dtype=cur.dtype, device=cur.device)
        groups = out.view(out.shape[0], m // ns, radix, ns, *out.shape[2:])
        for r in range(radix):
            groups[:, :, r] = v[r].reshape(v[r].shape[0], m // ns, ns, *v[r].shape[2:])
        cur = out
        ns *= radix
    return (conj_pairs(cur) if adjoint else cur) * scale
