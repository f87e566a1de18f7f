"""scipy.signal B-spline toolbox: smoothing IIR filters with
mirror-symmetric boundaries, spline coefficient prefilters, and spline
evaluation.

Port of ``webgpufft_tpu/splines.py``, the port's own copy.  The boundary
initial conditions are host float64 table math (truncated
geometric/damped-cosine sums over the concrete signal — the published
mirror-condition formulas), dotted with the signal on its device in full
float32 (``core.precision.full_f32``); the forward/backward recursions run
through filtering.lfilter / filtering.sosfilt (the IIR routes of
``filtering._iir_scan``); the 2-D FIR helper runs through the plan layer's
FFT convolution.  Spline evaluation is a pointwise 4-tap gather with int64
indices on the device.

Data stays on its device between the passes (the JAX package rounds the
intermediate through float64 numpy, which holds float32 values exactly, so
the results are the same).  Semantics pinned against scipy.signal and the
JAX package in tests/test_torch_splines.py, including the two distinct
boundary-sum conventions scipy ships (the symiirorder* truncated sums vs
cspline1d's full-signal smoothing sums) and the half-sample-symmetric
padding of sepfir2d.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fftapi
from .core.precision import full_f32
from .spec import PlanError
from .fftapi import fftconvolve
from .filtering import lfilter, sosfilt

__all__ = [
    "gauss_spline", "cspline1d", "qspline1d", "cspline2d", "qspline2d",
    "cspline1d_eval", "qspline1d_eval", "spline_filter", "sepfir2d",
    "symiirorder1", "symiirorder2",
]


def _single(signal) -> bool:
    """Is the caller's data single precision (float32 / complex64)?"""
    if isinstance(signal, torch.Tensor):
        return signal.dtype in (torch.float32, torch.complex64)
    return np.asarray(signal).dtype in (np.float32, np.complex64)


def _default_precision(signal, precision: float) -> float:
    if 0.0 <= precision < 1.0 and precision > 0.0:
        return float(precision)
    return 1e-6 if _single(signal) else 1e-11


def _dot(x, table: np.ndarray):
    """x (..., m) against a host float64 table of m weights, on x's
    device in full float32."""
    with full_f32():
        return x @ fftapi._const(table, x)


# -------------------------------------------------- symmetric IIR filters

def _sym1_ic(x, z1: float, precision: float):
    """Mirror-symmetric starting value for the causal first-order section
    1/(1 - z1 z^-1): y[0] = x[0] + z1 * sum_k z1^k x[k], the sum
    truncated once |z1|^k < precision (scipy's convergence contract:
    the tail must decay within the signal length)."""
    K = x.shape[-1]
    M = int(math.floor(math.log(precision) / math.log(abs(z1)))) + 1
    if M >= K:
        raise PlanError("Sum to find symmetric boundary conditions did "
                        "not converge (signal too short for |z1| and "
                        "precision)")
    return x[..., 0] + z1 * _dot(x[..., :M], z1 ** np.arange(M, dtype=np.float64))


def _flip(x):
    return torch.flip(x, (-1,))


def symiirorder1(signal, c0: float, z1: float, precision: float = -1.0):
    """Smoothing IIR c0 / ((1 - z1 z^-1)(1 - z1 z)) with mirror-symmetric
    boundaries (scipy.signal.symiirorder1 semantics): a causal first-order
    recursion, then an anticausal one over the reversed output, both on
    the device; boundary values from the truncated mirror sums."""
    if abs(z1) >= 1:
        raise PlanError("|z1| must be less than 1.0")
    prec = _default_precision(signal, precision)
    x = fftapi._f32(signal)
    if x.ndim > 2:
        raise PlanError("Input must be 1D or 2D")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    y0 = _sym1_ic(x, z1, prec)
    y1_tail, _ = lfilter([1.0], [1.0, -z1], x[:, 1:],
                         zi=(z1 * y0)[:, None])
    y1 = torch.cat([y0[:, None], y1_tail], -1)
    out_last = (-c0 / (z1 - 1.0)) * y1[:, -1]
    out_rev, _ = lfilter([c0], [1.0, -z1], _flip(y1[:, :-1]),
                         zi=(z1 * out_last)[:, None])
    out = torch.cat([_flip(out_rev), out_last[:, None]], -1)
    return out[0] if squeeze else out


def _hc(k, cs: float, rho: float, omega: float):
    """Causal response of one second-order section:
    cs rho^k sin(omega (k+1)) / sin(omega), zero for k < 0."""
    k = np.asarray(k, dtype=np.float64)
    return np.where(k > -1, cs / math.sin(omega) * rho ** k
                    * np.sin(omega * (k + 1)), 0.0)


def _hs(k, cs: float, rho: float, omega: float):
    """Full symmetric (two-pass) response at lag k: the damped cosine
    c0 rho^|k| (cos(omega |k|) + gamma sin(omega |k|))."""
    c0 = (cs * cs * (1 + rho * rho) / (1 - rho * rho)
          / (1 - 2 * rho * rho * math.cos(2 * omega) + rho ** 4))
    gamma = (1 - rho * rho) / (1 + rho * rho) / math.tan(omega)
    ak = np.abs(np.asarray(k, dtype=np.float64))
    return c0 * rho ** ak * (np.cos(omega * ak) + gamma * np.sin(omega * ak))


def _sym2_run(x, r: float, omega: float, ic_fwd, ic_bwd):
    """Device half of the second-order symmetric filter: causal sosfilt
    seeded from ic_fwd = (y[0], y[1]), then anticausal sosfilt over the
    reversed forward output seeded from ic_bwd = (out[K-1], out[K-2])."""
    rsq = r * r
    a2 = 2 * r * math.cos(omega)
    a3 = -rsq
    cs = 1 - a2 + rsq
    sos = np.array([[cs, 0.0, 0.0, 1.0, -a2, -a3]])
    coef = np.array([[a3, a2], [0.0, a3]])

    def seed(ic):
        # direct-form-II-transposed state equivalent to the last two
        # outputs ic = (y[n-1], y[n-2]) of the pure-recursive section
        return _dot(ic, coef.T)

    y_fwd_tail, _ = sosfilt(sos, x[:, 2:], zi=seed(ic_fwd)[None])
    y_fwd = torch.cat([ic_fwd, y_fwd_tail], -1)
    y_rev, _ = sosfilt(sos, _flip(y_fwd[:, :-2]), zi=seed(ic_bwd)[None])
    return torch.cat([_flip(y_rev), _flip(ic_bwd)], -1)


def symiirorder2(input, r: float, omega: float, precision: float = -1.0):
    """Smoothing IIR cs^2 / ((1 - a2 z^-1 - a3 z^-2)(1 - a2 z - a3 z^2))
    with mirror-symmetric boundaries (scipy.signal.symiirorder2
    semantics): half-sample-symmetric starting conditions from the
    truncated _hc/_hs sums, recursions on the device."""
    if r >= 1.0:
        raise PlanError("r must be less than 1.0")
    prec = _default_precision(input, precision)
    x = fftapi._f32(input)
    if x.ndim > 2:
        raise PlanError("Input must be 1D or 2D")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    K = x.shape[-1]
    cs = 1 - 2 * r * math.cos(omega) + r * r
    k = np.arange(K, dtype=np.float64)

    def _truncate(terms, squared: bool):
        """scipy's early-stop contract: include terms until the FIRST
        one at m > 0 whose magnitude (or square, for the backward sums)
        drops to <= precision — an oscillating kernel can stop at a
        cosine zero-crossing, and matching scipy means stopping with
        it.  Raises like scipy when the signal is too short."""
        crit = terms * terms if squared else np.abs(terms)
        below = np.flatnonzero(crit[1:] <= prec)
        if below.size == 0:
            raise PlanError("Sum to find symmetric boundary conditions "
                            "did not converge (signal too short for r "
                            "and precision)")
        stop = below[0] + 1
        # backward sums include the stopping term; forward sums do not
        return stop + 1 if squared else stop

    # forward: y[0], y[1] under the half-sample mirror x[-j] = x[j-1]
    # (note the hc(1)*x0 + hc(0)*x1 order for y[1] — this matches the
    # C kernels scipy's symiirorder2 uses, which differ from the
    # hc(0)*x0 + hc(1)*x1 order of its Python _cubic_smooth_coeff path)
    t0 = _hc(k + 1, cs, r, omega)
    t1 = _hc(k + 2, cs, r, omega)
    m0 = _truncate(t0, False)
    m1 = _truncate(t1, False)
    ic0 = float(_hc(0, cs, r, omega)) * x[:, 0] + _dot(x[:, :m0], t0[:m0])
    ic1 = (float(_hc(1, cs, r, omega)) * x[:, 0]
           + float(_hc(0, cs, r, omega)) * x[:, 1] + _dot(x[:, :m1], t1[:m1]))
    ic_fwd = torch.stack([ic0, ic1], -1)
    # backward: out[K-1], out[K-2] from the folded total response
    xr = _flip(x)
    d0 = _hs(k, cs, r, omega) + _hs(k + 1, cs, r, omega)
    d1 = _hs(k - 1, cs, r, omega) + _hs(k + 2, cs, r, omega)
    n0 = _truncate(d0, True)
    n1 = _truncate(d1, True)
    ic_bwd = torch.stack([_dot(xr[:, :n0], d0[:n0]), _dot(xr[:, :n1], d1[:n1])], -1)
    out = _sym2_run(x, r, omega, ic_fwd, ic_bwd)
    return out[0] if squeeze else out


# -------------------------------------------------- spline coefficients

def gauss_spline(x, n: int):
    """Gaussian approximation to the order-n B-spline basis
    (scipy.signal.gauss_spline: sigma^2 = (n+1)/12)."""
    x = fftapi._f32(x)
    signsq = (n + 1) / 12.0
    return 1 / math.sqrt(2 * math.pi * signsq) * torch.exp(-x ** 2 / (2 * signsq))


def _coeff_smooth(lam: float):
    """Pole radius/angle of the cubic smoothing-spline filter at
    fall-off lam (Unser's root formula, as scipy computes it)."""
    xi = 1 - 96 * lam + 24 * lam * math.sqrt(3 + 144 * lam)
    omega = math.atan2(math.sqrt(144 * lam - 1), math.sqrt(xi))
    rho = (24 * lam - 1 - math.sqrt(xi)) / (24 * lam)
    rho = rho * math.sqrt((48 * lam + 24 * lam
                           * math.sqrt(3 + 144 * lam)) / xi)
    return rho, omega


def _cubic_smooth_coeff(signal, lamb: float):
    """Cubic smoothing-spline coefficients, scipy's exact boundary
    convention for cspline1d(lamb > 0): FULL-signal mirror sums (not the
    precision-truncated symiirorder2 ones)."""
    rho, omega = _coeff_smooth(lamb)
    cs = 1 - 2 * rho * math.cos(omega) + rho * rho
    sq = signal.ndim == 1
    x = signal[None] if sq else signal
    K = x.shape[-1]
    k = np.arange(K, dtype=np.float64)
    ic0 = float(_hc(0, cs, rho, omega)) * x[:, 0] + _dot(x, _hc(k + 1, cs, rho, omega))
    ic1 = (float(_hc(0, cs, rho, omega)) * x[:, 0]
           + float(_hc(1, cs, rho, omega)) * x[:, 1] + _dot(x, _hc(k + 2, cs, rho, omega)))
    xr = _flip(x)
    b0 = _dot(xr, _hs(k, cs, rho, omega) + _hs(k + 1, cs, rho, omega))
    b1 = _dot(xr, _hs(k - 1, cs, rho, omega) + _hs(k + 2, cs, rho, omega))
    out = _sym2_run(x, rho, omega,
                    torch.stack([ic0, ic1], -1), torch.stack([b0, b1], -1))
    return out[0] if sq else out


def _prefilter_1d(x, z1: float, gain: float):
    """Exact (untruncated) B-spline interpolation prefilter used by
    cspline1d/qspline1d at lamb == 0: gain / ((1-z1 z^-1)(1-z1 z)) with
    the full-signal mirror starting sum."""
    sq = x.ndim == 1
    if sq:
        x = x[None]
    K = x.shape[-1]
    y0 = x[:, 0] + z1 * _dot(x, z1 ** np.arange(K, dtype=np.float64))
    if K == 1:
        # scipy quirk: the single-sample path omits the gain factor
        out = (z1 / (z1 - 1) * y0)[:, None]
        return out[0] if sq else out
    y1_tail, _ = lfilter([1.0], [1.0, -z1], x[:, 1:], zi=(z1 * y0)[:, None])
    y1 = torch.cat([y0[:, None], y1_tail], -1)
    out_last = (z1 / (z1 - 1)) * y1[:, -1]
    # backward: out[k] = z1 (out[k+1] - y1[k])  ==  lfilter([-z1], [1,-z1])
    out_rev, _ = lfilter([-z1], [1.0, -z1], _flip(y1[:, :-1]),
                         zi=(z1 * out_last)[:, None])
    out = torch.cat([_flip(out_rev), out_last[:, None]], -1) * gain
    return out[0] if sq else out


def cspline1d(signal, lamb: float = 0.0):
    """Cubic B-spline coefficients of a rank-1 signal
    (scipy.signal.cspline1d semantics; mirror-symmetric boundaries;
    ``lamb > 0`` smooths)."""
    x = fftapi._f32(signal)
    if lamb != 0.0:
        return _cubic_smooth_coeff(x, lamb)
    return _prefilter_1d(x, -2 + math.sqrt(3), 6.0)


def qspline1d(signal, lamb: float = 0.0):
    """Quadratic B-spline coefficients (scipy.signal.qspline1d)."""
    if lamb != 0.0:
        raise PlanError("Smoothing quadratic splines not supported yet.")
    return _prefilter_1d(fftapi._f32(signal), -3 + 2 * math.sqrt(2), 8.0)


def _precision_2d(signal, precision: float) -> float:
    if precision < 0.0 or precision >= 1.0:
        return 1e-3 if _single(signal) else 1e-6
    return precision


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0):
    """2-D cubic B-spline coefficients (scipy.signal.cspline2d
    semantics): the symmetric prefilter applied separably along the last
    axis then axis 0; smoothing lambda routes to the second-order
    smoothing filter."""
    if np.ndim(signal) != 2:
        raise PlanError("cspline2d expects a 2-D array")
    precision = _precision_2d(signal, precision)
    if lamb <= 1 / 144.0:
        r = -2 + math.sqrt(3.0)
        out = symiirorder1(signal, -r * 6.0, r, precision)
        return symiirorder1(out.t(), -r * 6.0, r, precision).t()
    rho, omega = _coeff_smooth(lamb)
    out = symiirorder2(signal, rho, omega, precision)
    return symiirorder2(out.t(), rho, omega, precision).t()


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0):
    """2-D quadratic B-spline coefficients (scipy.signal.qspline2d)."""
    if np.ndim(signal) != 2:
        raise PlanError("qspline2d expects a 2-D array")
    if lamb > 0:
        raise PlanError("lambda must be negative or zero")
    precision = _precision_2d(signal, precision)
    r = -3 + 2 * math.sqrt(2.0)
    out = symiirorder1(signal, -r * 8.0, r, precision)
    return symiirorder1(out.t(), -r * 8.0, r, precision).t()


# ----------------------------------------------------- spline evaluation

def _bspline3(x):
    ax = torch.abs(x)
    return torch.where(ax < 1, 2.0 / 3 - ax * ax + ax ** 3 / 2.0,
                       torch.where(ax < 2, (2.0 - ax) ** 3 / 6.0, 0.0))


def _bspline2(x):
    ax = torch.abs(x)
    return torch.where(ax < 0.5, 0.75 - ax * ax,
                       torch.where(ax < 1.5, (ax - 1.5) ** 2 / 2.0, 0.0))


def _spline_eval(cj, newx, dx, x0, kernel, jlo_shift: float, taps: int):
    cj = fftapi._f32(cj)
    N = cj.shape[0]
    # triangular fold onto [0, N-1] (repeated mirror reflection) in host
    # f64 — the fold must not lose grid positions to f32 rounding
    if isinstance(newx, torch.Tensor):
        newx = newx.detach().cpu().numpy()
    x = (np.asarray(newx, dtype=np.float64) - x0) / float(dx)
    if N > 1:
        period = 2.0 * (N - 1)
        x = np.abs(x) % period
        x = np.minimum(x, period - x)
    else:
        x = np.zeros_like(x)
    x = fftapi._f32(x, cj.device)
    jlower = torch.floor(x - jlo_shift).to(torch.int64) + 1
    res = torch.zeros_like(x)
    for i in range(taps):
        thisj = jlower + i
        res = res + cj[thisj.clamp(0, N - 1)] * kernel(x - thisj)
    return res


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0):
    """Evaluate a cubic spline from its coefficients at new points
    (scipy.signal.cspline1d_eval semantics: mirror-symmetric extension
    beyond the knots; ``dx``/``x0`` map newx onto the knot grid)."""
    return _spline_eval(cj, newx, dx, x0, _bspline3, 2.0, 4)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0):
    """Evaluate a quadratic spline (scipy.signal.qspline1d_eval)."""
    return _spline_eval(cj, newx, dx, x0, _bspline2, 1.5, 3)


# ------------------------------------------------------- 2-D FIR helpers

def sepfir2d(input, hrow, hcol):
    """Separable 2-D FIR with half-sample mirror-symmetric boundaries
    (scipy.signal.sepfir2d semantics; odd-length filters).  Runs as two
    plan-layer FFT convolutions over a symmetric pad."""
    x = fftapi._f32(input)
    if x.ndim != 2:
        raise PlanError("sepfir2d expects a 2-D array")
    hrow = np.asarray(hrow, dtype=np.float64).ravel()
    hcol = np.asarray(hcol, dtype=np.float64).ravel()
    if hrow.size % 2 != 1 or hcol.size % 2 != 1:
        raise PlanError("hrow and hcol must be odd length")
    pr = hrow.size // 2
    pc = hcol.size // 2
    ext = fftapi._pad_axis(fftapi._pad_axis(x, 0, pc, pc, "symmetric"), 1, pr, pr, "symmetric")
    out = fftconvolve(ext, hrow.astype(np.float32)[None, :], mode="valid")
    return fftconvolve(out, hcol.astype(np.float32)[:, None], mode="valid")


def spline_filter(Iin, lmbda: float = 5.0):
    """Cubic smoothing-spline filter of a rank-2 array
    (scipy.signal.spline_filter semantics: cspline2d coefficients
    re-convolved with the [1, 4, 1]/6 sampling kernel)."""
    hcol = np.array([1.0, 4.0, 1.0]) / 6.0
    # the JAX package hands cspline2d float64 whatever the input, so its
    # default precision is the double-precision one, 1e-6
    ck = cspline2d(Iin, lmbda, 1e-6)
    return sepfir2d(ck, hcol, hcol)
