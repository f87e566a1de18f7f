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
(``radix_chain``), and models the pass schedule on the CPU with the same
index maps, tables and butterfly algebra as the CUDA code
(``radix_chain_reference``): a test aid that no plan path calls.
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


def roots_table(n: int, direction: str) -> np.ndarray:
    """The n-th roots of unity W^j = exp(-+ 2*pi*i*j/n), j in [0, n), as
    float32 (n, 2) pairs, rounded once from float64."""
    sign = -1.0 if direction == "forward" else 1.0
    w = np.exp(sign * 2j * np.pi * np.arange(n, dtype=np.float64) / n)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


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


def chain_consts(n: int, direction: str, scale: float, prefix: str) -> Dict[str, np.ndarray]:
    """What the CUDA kernels read, from n, direction and scale alone:
    ``cw`` the pass-ordered twiddles (n, 2), and ``cp`` = [scale, sign]
    with sign -1 for forward and +1 for inverse."""
    sign = -1.0 if direction == "forward" else 1.0
    return {
        f"{prefix}/cw": chain_twiddles(n, direction, radix_chain(n)),
        f"{prefix}/cp": np.array([scale, sign], dtype=np.float32),
    }


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


_BUTTERFLIES = {2: _butterfly2, 4: _butterfly4, 8: _butterfly8, 16: _butterfly16}


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
        j = torch.arange(m, device=x.device)
        k = j % ns
        v = [cur[:, j + r * m] for r in range(radix)]
        if ns > 1:
            for r in range(1, radix):
                w = tw[ns - 1 + (r - 1) * ns + k].reshape(1, m, *ride)
                wr, wi = w[..., 0], w[..., 1]
                vr, vi = v[r][..., 0], v[r][..., 1]
                v[r] = torch.stack([vr * wr - vi * wi, vr * wi + vi * wr], dim=-1)
        v = _BUTTERFLIES.get(radix, _butterfly_odd)(v, s)
        out = torch.empty_like(cur)
        j0 = (j - k) * radix + k
        for r in range(radix):
            out[:, j0 + r * ns] = v[r]
        cur = out
        ns *= radix
    return (conj_pairs(cur) if adjoint else cur) * scale
