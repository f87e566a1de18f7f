"""Non-uniform FFT (NUFFT) on torch tensors, finufft-style API.

Port of ``webgpufft_tpu/nufft.py``: types 1, 2 and 3 in one, two and three
dimensions with Gaussian gridding (Dutt-Rokhlin; parameters per Greengard &
Lee 2004), the same parameters (``_msp_for``, ``_grid_params``, ``_SIGMA``)
and the same CMCL mode order:

- type 1 (nonuniform -> uniform):  f_k     = sum_j c_j e^{isign i k x_j}
- type 2 (uniform -> nonuniform):  c_j     = sum_k f_k e^{isign i k x_j}
- type 3 (nonuniform -> nonuniform): f_k   = sum_j c_j e^{isign i s_k x_j}

with modes k = -(N//2) .. (N-1)//2 and points x in radians (any real values;
wrapped into [0, 2pi)).  Type 3 takes arbitrary real source locations x_j
AND target frequencies s_k.  Default isign follows finufft: +1 for types 1
and 3, -1 for type 2.

Algorithm (type 1): spread each point onto a 2x-oversampled fine grid
through a truncated periodized Gaussian (2*Msp taps per dim), run the
fine-grid FFT through the facade (``fftapi.fft``/``fftn``, unscaled: K1 on
the last axis and K2 on the others for a CUDA tensor), then deconvolve by
the Gaussian's transform.  Type 2 is the transpose; type 3 (Lee & Greengard
2005) reduces to type 2 on a rescaled grid, as in the JAX package.

Spreading is ``index_add`` along the flat grid axis with int64 indices (a
scatter-add with atomics on the card; out of place, so autograd and the
``torch.func`` transforms see it), interpolation a gather and a sum over
the taps.  Indices wrap with ``torch.remainder`` (the sign of the divisor,
as ``jnp.mod``).  Modes leave and enter the fine grid through
``index_select`` / ``index_copy`` per axis with the CMCL bins as an int64
index on the grid's device.

Chunking.  The tap tensor is built per chunk of points so that B * chunk *
taps stays under ``_CHUNK_TAP_ELEMS`` = 2^26 elements: a chunk's transient
(the f32 strength products, the int64 indices and the f32 weights, about 20
bytes per element, and the per-axis products) stays near 2 GB, under 3% of
an 80 GB card, while a chunk carries about a gigabyte of traffic, far more
than the host's few dozen launches per chunk cost.  A 3-D call at eps = 1e-6
has 16^3 = 4096 taps per point, so 16384 points per chunk.  The JAX
package's bound (its 2^22-element operand bound and a 32-chunk unroll limit
under ``jit``) is a TPU fact the port does not carry.  Chunking changes only
the order of the sums.

Accuracy.  The device computes in f32.  Concrete points (numpy, or a tensor
nothing differentiates through) get their integer base index floor(x/h) and
O(h) residual per axis on the host in float64; the taps are rebuilt on the
device from that pair, so position information survives the f32 store.
Points that ``radix.tracked`` reports take the device-f32 split, so
gradients reach the points through the Gaussian taps (phase accuracy then
~N * 6e-8 relative).  Everything is differentiable in c (linear) and, on the
tracked path, in the point locations.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import fftapi
from .core import cplx, radix
from .spec import PlanError

__all__ = ["nufft1d1", "nufft1d2", "nufft2d1", "nufft2d2",
           "nufft3d1", "nufft3d2", "nufft1d3", "nufft2d3", "nufft3d3"]

_SIGMA = 2          # fine-grid oversampling factor
_CHUNK_TAP_ELEMS = 1 << 26   # bound on B * m_chunk * taps elements (module docstring)


def _msp_for(eps: float) -> int:
    """Taps-per-side from the requested tolerance (measured convergence:
    Msp 4/6/8/10/12 -> 1e-4/2e-6/3e-8/5e-10/7e-12 in f64)."""
    eps = float(eps)
    if not 0 < eps < 1:
        raise PlanError(f"eps must be in (0, 1), got {eps}")
    return max(4, min(14, int(math.ceil(-math.log10(eps))) + 2))


def _grid_params(n: int, msp: int) -> Tuple[int, float, float]:
    """(Mr, h, tau) for n modes: fine grid size (plan-fast), spacing,
    Gaussian variance parameter (Greengard-Lee), with tau from the
    EFFECTIVE oversampling mr/n."""
    if n < 2:
        raise PlanError(f"n_modes must be >= 2, got {n}")
    mr = fftapi.next_fast_len(max(_SIGMA * n, 2 * msp + 2))
    h = 2.0 * math.pi / mr
    sig = mr / n
    tau = math.pi * msp / (n * n) / (sig * (sig - 0.5))
    return mr, h, tau


def _n_modes_tuple(n_modes, rank: int) -> Tuple[int, ...]:
    if np.ndim(n_modes) == 0:
        if rank > 1:
            raise PlanError(
                f"n_modes must be a sequence of {rank} ints, got {n_modes!r}")
        ns = (int(n_modes),)
    else:
        ns = tuple(int(v) for v in n_modes)
    if len(ns) != rank:
        raise PlanError(
            f"n_modes must have {rank} entries, got {len(ns)}")
    return ns


def _check_isign(isign: int) -> int:
    if isign not in (1, -1):
        raise PlanError(f"isign must be +1 or -1, got {isign!r}")
    return isign


def _check_grid(mrs) -> int:
    """Total fine-grid cells, held to the int32 index space of the JAX
    package so both refuse the same geometries."""
    total = int(np.prod([int(m) for m in mrs], dtype=np.int64))
    if total >= 2 ** 31:
        raise PlanError(
            f"fine grid of {total} cells exceeds the int32 index space; "
            "reduce n_modes (the 2x-oversampled grid must stay below 2^31 "
            "cells)")
    return total


def _as_points(x):
    """1-D point array wrapped into [0, 2pi).  A tracked tensor wraps on its
    device in its own dtype before any downcast; anything else stays on the
    host in float64 (the wrap and later the taps keep full position
    information)."""
    if isinstance(x, torch.Tensor) and radix.tracked(x):
        if x.ndim != 1:
            raise PlanError(
                f"points must be a 1-D array, got shape {tuple(x.shape)}")
        return torch.remainder(x, 2.0 * math.pi).to(torch.float32)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    xn = np.asarray(x, np.float64)
    if xn.ndim != 1:
        raise PlanError(f"points must be a 1-D array, got shape {xn.shape}")
    return np.mod(xn, 2.0 * math.pi)


def _as_strengths(c, m: int, device) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Interleaved (B, M, 2) strengths from (..., M) complex/interleaved
    input; returns (tensor, leading batch shape)."""
    ci = fftapi.asinterleaved(c, device=device)
    if tuple(ci.shape[-2:]) == (m, 2):
        lead = tuple(ci.shape[:-2])
        b = math.prod(lead)
        return ci.reshape(b, m, 2), lead
    raise PlanError(
        f"strengths must have trailing length {m} (one per point); got "
        f"shape {tuple(np.shape(c))}")


def _as_modes(f, rank: int, device):
    """Interleaved (B, n1..nd, 2) uniform modes from (..., n1..nd)
    complex/interleaved input; returns (tensor, mode dims, lead shape)."""
    fi = fftapi.asinterleaved(f, device=device)
    if fi.ndim < rank + 1:
        raise PlanError(
            f"uniform modes must have at least {rank} mode axes; got "
            f"shape {tuple(np.shape(f))}")
    ns = tuple(int(d) for d in fi.shape[-rank - 1:-1])
    lead = tuple(fi.shape[:-rank - 1])
    return fi.reshape(-1, *ns, 2), ns, lead


def _base_residual(x, h: float, device):
    """Per-point fine-grid base index m0 = floor(x/h) (int64) and residual
    r = x - h*m0 (f32) on ``device``, for all points at once.  Host points
    compute in f64 (the residual is O(h), so its f32 store costs ~6e-8*h
    absolute position error, N-independent); tracked points compute on
    their device in f32."""
    if isinstance(x, np.ndarray):
        m0 = np.floor(x / h).astype(np.int64)
        r = (x - h * m0).astype(np.float32)
        return torch.as_tensor(m0, device=device), torch.as_tensor(r, device=device)
    m0 = torch.floor(x / float(np.float32(h))).to(torch.int64)
    r = x - float(np.float32(h)) * m0.to(torch.float32)
    return m0, r


def _taps_from_base(m0, r, h: float, tau: float, msp: int, mr: int):
    """(indices, weights) of the 2*Msp periodized Gaussian taps from a
    base-index/residual pair: idx (mc, 2*Msp) int64 mod Mr, w (mc, 2*Msp)
    f32, built on the device (t = h*j - r, so every quantity is O(h) and
    f32-exact to ~1e-7 relative).  The single tap-kernel definition, shared
    with the distributed layer."""
    offs = torch.arange(-msp + 1, msp + 1, dtype=torch.int64, device=r.device)
    idx = torch.remainder(m0[:, None] + offs[None, :], mr)
    t = float(np.float32(h)) * offs.to(torch.float32)[None, :] - r[:, None]
    w = torch.exp(-(t * t) / float(np.float32(4.0 * tau)))
    return idx, w


def _combine_sep_taps(per_axis, mrs):
    """Combine per-axis (idx, w) taps into flattened separable taps:
    linear row-major indices (mc, T) and weight products (mc, T)."""
    (lin, w) = per_axis[0]
    for (i2, w2), mr in zip(per_axis[1:], mrs[1:]):
        m = lin.shape[0]
        lin = (lin[:, :, None] * mr + i2[:, None, :]).reshape(m, -1)
        w = (w[:, :, None] * w2[:, None, :]).reshape(m, -1)
    return lin, w


def _sep_taps_from_base(m0s, rs, hs, taus, msp: int, mrs, s=0, e=None):
    """Flattened separable taps for the point slice [s:e) from per-axis
    (m0, r) pairs: linear fine-grid indices (mc, T) with T = (2*Msp)^rank
    into the row-major (mr1*..*mrd) grid, and the weight products (mc, T).
    Called per point chunk so the O(M*T) tap tensor never materializes
    whole."""
    per_axis = [
        _taps_from_base(m0[s:e], r[s:e], h, tau, msp, mr)
        for m0, r, h, tau, mr in zip(m0s, rs, hs, taus, mrs)]
    return _combine_sep_taps(per_axis, mrs)


def _point_step(b: int, m: int, t: int) -> int:
    """Point-axis chunk length bounding the (B, step, T) tap tensor to
    ~_CHUNK_TAP_ELEMS elements."""
    if not m:
        return 1
    return max(1, min(m, _CHUNK_TAP_ELEMS // max(1, b * t)))


def _spread_taps(ci: torch.Tensor, taps_fn, t: int, total: int) -> torch.Tensor:
    """Scatter-add strengths onto the flat fine grid: (B, M, 2) ->
    (B, total, 2), chunked over points with taps built per chunk by
    ``taps_fn(s, e) -> (lin, w)`` (shared with the distributed layer)."""
    b, m, _ = ci.shape
    step = _point_step(b, m, t)
    grid = torch.zeros(b, total, 2, dtype=torch.float32, device=ci.device)
    for s in range(0, m, step):
        e = min(m, s + step)
        lin, w = taps_fn(s, e)
        vals = ci[:, s:e, None, :] * w[None, :, :, None]
        grid = grid.index_add(1, lin.reshape(-1), vals.reshape(b, -1, 2))
    return grid


def _interp_taps(grid_flat: torch.Tensor, taps_fn, m: int, t: int) -> torch.Tensor:
    """Gather-and-sum fine-grid values at the points: (B, total, 2) ->
    (B, M, 2), taps built per chunk by ``taps_fn(s, e)``."""
    b = grid_flat.shape[0]
    step = _point_step(b, m, t)
    outs = []
    for s in range(0, m, step):
        e = min(m, s + step)
        lin, w = taps_fn(s, e)
        vals = grid_flat[:, lin]                 # (B, mc, T, 2)
        outs.append((vals * w[None, :, :, None]).sum(dim=2))
    if not outs:
        return grid_flat.new_zeros(b, 0, 2)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _bases(points, hs, device):
    """Per-axis (m0, r) device pairs of the points, once per call."""
    pairs = [_base_residual(p, h, device) for p, h in zip(points, hs)]
    return [m0 for m0, _ in pairs], [r for _, r in pairs]


def _spread(ci: torch.Tensor, points, hs, taus, msp: int, mrs,
            total: int) -> torch.Tensor:
    m0s, rs = _bases(points, hs, ci.device)
    return _spread_taps(
        ci, lambda s, e: _sep_taps_from_base(m0s, rs, hs, taus, msp, mrs, s, e),
        (2 * msp) ** len(mrs), total)


def _interp(grid_flat: torch.Tensor, points, hs, taus, msp: int,
            mrs) -> torch.Tensor:
    m0s, rs = _bases(points, hs, grid_flat.device)
    return _interp_taps(
        grid_flat,
        lambda s, e: _sep_taps_from_base(m0s, rs, hs, taus, msp, mrs, s, e),
        points[0].shape[0], (2 * msp) ** len(mrs))


def _mode_slice(mr: int, n: int) -> np.ndarray:
    """Fine-grid bins of the output modes -(n//2)..(n-1)//2 (CMCL)."""
    k = np.arange(-(n // 2), (n + 1) // 2)
    return np.mod(k, mr).astype(np.int64)


def _deconv_1d(n: int, h: float, tau: float) -> np.ndarray:
    k = np.arange(-(n // 2), (n + 1) // 2, dtype=np.float64)
    return (h / (2.0 * math.sqrt(math.pi * tau))
            * np.exp(k * k * tau)).astype(np.float32)


def _fine_dft(grid_i: torch.Tensor, isign: int, axes=None):
    """Unscaled fine-grid DFT with the e^{isign * i k h m} convention:
    facade ifft (norm='forward', unscaled) realizes e^{+...}, fft
    (norm=None, unscaled) e^{-...}; rank > 1 via the ND entry points."""
    pos = fftapi.ifftn if axes else fftapi.ifft
    neg = fftapi.fftn if axes else fftapi.fft
    kw = {"axes": axes} if axes else {}
    if isign >= 0:
        return pos(grid_i, norm="forward", interleaved=True, **kw)
    return neg(grid_i, interleaved=True, **kw)


# ------------------------------------------------------------ generic ND

def _mode_index(mr: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """The CMCL bins of one axis as an int64 index on ``like``'s device."""
    return torch.as_tensor(_mode_slice(mr, n), device=like.device)


def _deconv_nd(ns, hs, taus, like: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian deconvolution weights (*ns,) on ``like``'s
    device: the per-axis f32 vectors of the host, multiplied in f32 in the
    JAX package's order."""
    rank = len(ns)
    dec = None
    for i, (n, h, tau) in enumerate(zip(ns, hs, taus)):
        d = fftapi._const(_deconv_1d(n, h, tau), like)
        d = d.reshape((1,) * i + (-1,) + (1,) * (rank - 1 - i))
        dec = d if dec is None else dec * d
    return dec


def _modes_from_grid(grid, ns, mrs, hs, taus, isign: int):
    """Flat fine grid (B, total, 2) -> deconvolved CMCL modes
    (B, *ns, 2): fine-grid DFT, mode extraction, Gaussian deconvolution
    (the type-1 tail after spreading; shared with the distributed layer)."""
    b = grid.shape[0]
    rank = len(ns)
    grid = grid.reshape(b, *mrs, 2)
    out = _fine_dft(grid, isign, axes=tuple(range(1, rank + 1))
                    if rank > 1 else None)
    for d, (mr, n) in enumerate(zip(mrs, ns)):
        out = out.index_select(1 + d, _mode_index(mr, n, out))
    return out * _deconv_nd(ns, hs, taus, out)[None, ..., None]


def _grid_from_modes(fb, ns, mrs, hs, taus, isign: int):
    """Deconvolved CMCL modes (B, *ns, 2) -> flat fine grid (B, total, 2)
    (the type-2 head before interpolation; shared with the distributed
    layer)."""
    rank = len(ns)
    fine = fb * _deconv_nd(ns, hs, taus, fb)[None, ..., None]
    for d in reversed(range(rank)):
        shape = list(fine.shape)
        shape[1 + d] = mrs[d]
        fine = fine.new_zeros(shape).index_copy(1 + d, _mode_index(mrs[d], ns[d], fine), fine)
    grid = _fine_dft(fine, isign, axes=tuple(range(1, rank + 1))
                     if rank > 1 else None)
    return grid.reshape(fb.shape[0], -1, 2)


def _geometry(ns, eps: float):
    """(msp, mrs, hs, taus, total) for a mode-grid geometry."""
    msp = _msp_for(eps)
    params = [_grid_params(n, msp) for n in ns]
    mrs = [p[0] for p in params]
    hs = [p[1] for p in params]
    taus = [p[2] for p in params]
    return msp, mrs, hs, taus, _check_grid(mrs)


def _type1(points, c, ns, eps: float, isign: int, device):
    _check_isign(isign)
    msp, mrs, hs, taus, total = _geometry(ns, eps)
    ci, lead = _as_strengths(c, points[0].shape[0], device)
    grid = _spread(ci, points, hs, taus, msp, mrs, total)
    out = _modes_from_grid(grid, ns, mrs, hs, taus, isign)
    return out.reshape(*lead, *ns, 2)


def _type2(points, f, rank: int, eps: float, isign: int, device):
    _check_isign(isign)
    fb, ns, lead = _as_modes(f, rank, device)
    msp, mrs, hs, taus, _ = _geometry(ns, eps)
    grid = _grid_from_modes(fb, ns, mrs, hs, taus, isign)
    out = _interp(grid, points, hs, taus, msp, mrs)
    return out.reshape(*lead, points[0].shape[0], 2), ns


def _points_nd(*coords):
    pts = [_as_points(p) for p in coords]
    if not all(p.shape == pts[0].shape for p in pts[1:]):
        raise PlanError(
            "point coordinate arrays must have the same number of points")
    return pts


# -------------------------------------------------------------- type 3

def _free_coords(coords, what: str):
    """Host-f64 1-D coordinate arrays for type 3 (no wrapping: source
    locations and target frequencies are free reals).  Type-3 geometry
    (grid sizes) depends on the coordinate RANGES, so tracked coordinates
    are refused; strengths may still be tracked."""
    out = []
    for p in coords:
        if isinstance(p, torch.Tensor):
            if radix.tracked(p):
                raise PlanError(
                    f"type-3 {what} must be concrete (the fine-grid geometry "
                    "depends on their numeric range); only the strengths may "
                    "be traced")
            p = p.detach().cpu().numpy()
        pn = np.asarray(p, np.float64)
        if pn.ndim != 1:
            raise PlanError(
                f"{what} must be 1-D arrays, got shape {pn.shape}")
        out.append(pn)
    if not all(p.shape == out[0].shape for p in out[1:]):
        raise PlanError(
            f"{what} coordinate arrays must have the same length")
    if out[0].size == 0:
        raise PlanError(f"{what} must be non-empty")
    return out


def _phase_rot(angle: np.ndarray, like: torch.Tensor, factor=1.0) -> torch.Tensor:
    """(..., 2, 2) rotation tensor for cmul_t4 on ``like``'s device:
    multiply interleaved data by factor * e^{i angle} (host-f64 trig, f32
    storage)."""
    return fftapi._const(cplx.to_t4(np.asarray(factor, np.float64)
                                    * np.exp(1j * np.asarray(angle))), like)


def _type3_setup(xs, ss, eps: float):
    """Host-side type-3 geometry (isign-independent): per-axis fine-grid
    params (nfs, hs, taus), rescaled source coordinates ``us``, inner
    type-2 point coordinates ``thetas``, and the phase/deconvolution
    vectors (multiplied by isign at application).  Shared by the
    single-device path and the distributed builder."""
    msp = _msp_for(eps)
    nfs, hs, taus = [], [], []
    us, thetas = [], []
    pre_angle = np.zeros(xs[0].shape[0], np.float64)
    post_angle = np.zeros(ss[0].shape[0], np.float64)
    deconv = np.ones(ss[0].shape[0], np.float64)
    for x, s in zip(xs, ss):
        xc = (x.max() + x.min()) / 2.0
        sc = (s.max() + s.min()) / 2.0
        hx = max(np.abs(x - xc).max(), 1e-9)    # source half-extent X
        sx = max(np.abs(s - sc).max(), 1e-9)    # target half-extent S
        # e^{i omega u} is NOT 2pi-periodic in u for real omega, so the
        # spread must never wrap: sources map into [pi - A, pi + A] with
        # an Msp-tap margin A = pi - msp*h on each side.  A depends on h
        # which depends on nf which depends on A: fixed-point passes settle
        # it (nf only grows through next_fast_len).
        amp = math.pi
        for _ in range(3):
            wband = max(sx * hx / amp, 1.0)     # inner bandwidth W
            n_band = max(int(math.ceil(2.0 * wband)) + 1, 2)
            nf = fftapi.next_fast_len(max(_SIGMA * n_band, 4 * msp + 2))
            h = 2.0 * math.pi / nf
            amp = max(math.pi - msp * h, math.pi / 2.0)
        gam = amp / hx                          # x' -> u scale
        omega = (s - sc) / gam                  # scaled target freqs
        sig = nf / n_band
        tau = math.pi * msp / (n_band * n_band) / (sig * (sig - 0.5))
        nfs.append(nf)
        hs.append(h)
        taus.append(tau)
        us.append((x - xc) * gam + math.pi)     # in [pi-A, pi+A]
        thetas.append(np.mod(omega * h, 2.0 * math.pi))
        pre_angle += sc * (x - xc)
        # e^{isign i theta*c0} (natural->CMCL index shift of the inner
        # type 2) and e^{-isign i pi*omega} (source center shift): they
        # cancel exactly when nf is even
        post_angle += omega * (h * (nf // 2) - math.pi) + s * xc
        deconv *= (h / (2.0 * math.sqrt(math.pi * tau))
                   * np.exp(omega * omega * tau))
    return (msp, nfs, hs, taus, us, thetas, pre_angle, post_angle, deconv)


def _type3(xs, c, ss, eps: float, isign: int, device):
    """Generic ND type 3 (Lee & Greengard 2005, reduction to type 2):
    center and rescale sources into [0, 2pi) and targets into fine-grid
    'point' coordinates, Gaussian-spread the (pre-phased) strengths onto
    a fine grid, evaluate the grid's trig sum at the scaled targets via
    the type-2 core, then deconvolve by the spreading Gaussian at the
    REAL target frequencies and restore the centering phases."""
    _check_isign(isign)
    rank = len(xs)
    ci, lead = _as_strengths(c, xs[0].shape[0], device)
    (msp, nfs, hs, taus, us, thetas,
     pre_angle, post_angle, deconv) = _type3_setup(xs, ss, eps)

    cc = cplx.cmul_t4(ci, _phase_rot(isign * pre_angle, ci))
    grid = _spread(cc, us, hs, taus, msp, nfs, _check_grid(nfs))
    # the natural-order fine grid read as CMCL modes represents
    # coefficients of e^{isign i (m - nf//2) theta}; the index shift is
    # folded into post_angle above
    grid = grid.reshape(cc.shape[0], *nfs, 2)
    inner, _ = _type2(thetas, grid, rank, eps, isign, grid.device)
    out = cplx.cmul_t4(inner, _phase_rot(isign * post_angle, inner, deconv))
    return out.reshape(*lead, ss[0].shape[0], 2)


def nufft1d3(x, c, s, *, eps: float = 1e-6, isign: int = 1):
    """Type-3 1-D NUFFT: f_k = sum_j c_j e^{isign i s_k x_j} at arbitrary
    real target frequencies ``s`` from arbitrary real source locations
    ``x`` (M,) with strengths ``c`` (..., M) complex or interleaved.
    Returns interleaved (..., K, 2).  Coordinates must not be tracked
    (the fine-grid geometry depends on their ranges)."""
    device = fftapi._device_of(x, c, s)
    return _type3(_free_coords([x], "source locations"), c,
                  _free_coords([s], "target frequencies"), eps, isign, device)


def nufft2d3(x, y, c, s, t, *, eps: float = 1e-6, isign: int = 1):
    """Type-3 2-D NUFFT: f_k = sum_j c_j e^{isign i (s_k x_j + t_k y_j)}
    at K arbitrary target frequency pairs (s, t)."""
    device = fftapi._device_of(x, y, c, s, t)
    return _type3(_free_coords([x, y], "source locations"), c,
                  _free_coords([s, t], "target frequencies"), eps, isign, device)


def nufft3d3(x, y, z, c, s, t, u, *, eps: float = 1e-6, isign: int = 1):
    """Type-3 3-D NUFFT: f_k = sum_j c_j e^{isign i (s_k x_j + t_k y_j +
    u_k z_j)} at K arbitrary target frequency triples (s, t, u)."""
    device = fftapi._device_of(x, y, z, c, s, t, u)
    return _type3(_free_coords([x, y, z], "source locations"), c,
                  _free_coords([s, t, u], "target frequencies"), eps, isign, device)


# ------------------------------------------------------------------ 1-D

def nufft1d1(x, c, n_modes: int, *, eps: float = 1e-6, isign: int = 1):
    """Type-1 1-D NUFFT: f_k = sum_j c_j e^{isign i k x_j} for
    k = -(N//2)..(N-1)//2.  ``x`` (M,) radians; ``c`` (..., M) complex or
    interleaved.  Returns interleaved (..., N, 2)."""
    return _type1(_points_nd(x), c, _n_modes_tuple(n_modes, 1),
                  eps, isign, fftapi._device_of(x, c))


def nufft1d2(x, f, *, eps: float = 1e-6, isign: int = -1):
    """Type-2 1-D NUFFT: c_j = sum_k f_k e^{isign i k x_j}.  ``f``
    (..., N) complex/interleaved uniform modes in CMCL order; returns
    interleaved (..., M, 2) values at the M points ``x``."""
    out, _ = _type2(_points_nd(x), f, 1, eps, isign, fftapi._device_of(x, f))
    return out


# ------------------------------------------------------------------ 2-D

def nufft2d1(x, y, c, n_modes, *, eps: float = 1e-6, isign: int = 1):
    """Type-1 2-D NUFFT onto an (N1, N2) mode grid (CMCL order per
    axis): f_{k1,k2} = sum_j c_j e^{isign i (k1 x_j + k2 y_j)}."""
    return _type1(_points_nd(x, y), c, _n_modes_tuple(n_modes, 2),
                  eps, isign, fftapi._device_of(x, y, c))


def nufft2d2(x, y, f, *, eps: float = 1e-6, isign: int = -1):
    """Type-2 2-D NUFFT: values at (x_j, y_j) of the (..., N1, N2)
    uniform-mode array ``f``: c_j = sum_{k1,k2} f e^{isign i (k1 x + k2 y)}."""
    out, _ = _type2(_points_nd(x, y), f, 2, eps, isign, fftapi._device_of(x, y, f))
    return out


# ------------------------------------------------------------------ 3-D

def nufft3d1(x, y, z, c, n_modes, *, eps: float = 1e-6, isign: int = 1):
    """Type-1 3-D NUFFT onto an (N1, N2, N3) mode grid (CMCL order per
    axis): f_{k1,k2,k3} = sum_j c_j e^{isign i (k1 x_j + k2 y_j + k3 z_j)}.
    Each point spreads (2*Msp)^3 separable Gaussian taps, chunked over
    points (``_CHUNK_TAP_ELEMS``)."""
    return _type1(_points_nd(x, y, z), c, _n_modes_tuple(n_modes, 3),
                  eps, isign, fftapi._device_of(x, y, z, c))


def nufft3d2(x, y, z, f, *, eps: float = 1e-6, isign: int = -1):
    """Type-2 3-D NUFFT: values at the points of the (..., N1, N2, N3)
    uniform-mode array ``f``."""
    out, _ = _type2(_points_nd(x, y, z), f, 3, eps, isign,
                    fftapi._device_of(x, y, z, f))
    return out
