"""scipy.signal waveform generators (chirp/sweep_poly/gausspulse/
sawtooth/square/unit_impulse/max_len_seq) on torch tensors.

Port of ``webgpufft_tpu/waveforms.py``.  Waveform synthesis is table
generation, the same host-precompute idiom as the package's twiddle and
window tables: with a concrete time vector the phase accumulates in float64
on the host (large phases destroy float32 trig), and the result lands as a
float32 tensor through ``fftapi._f32``: on the time vector's device when it
is a tensor, else on the facade's default device.

Passed a time tensor that ``radix.tracked`` reports (something
differentiates or batches through it), every function computes with torch
on that tensor's device and keeps its gradient, where the JAX package keeps
a tracer; the phase then carries float32 precision, which is fine for the
short horizons such a generator is used at.

Pinned against scipy.signal and the JAX package in
tests/test_torch_waveforms.py.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from . import fftapi
from .core import radix
from .spec import PlanError

__all__ = ["chirp", "sweep_poly", "gausspulse", "sawtooth", "square",
           "unit_impulse", "max_len_seq"]

# the numpy calls below, on tensors
_TORCH = SimpleNamespace(cos=torch.cos, sin=torch.sin, exp=torch.exp, log=torch.log,
                         abs=torch.abs, power=torch.pow, mod=torch.remainder,
                         where=torch.where, stack=torch.stack)


def _xp_for(t):
    """(numpy, False, device) for a concrete time vector (f64 phase math on
    the host, the result placed on ``device``: the tensor's own, or the
    facade default), (torch ops, True, None) for a tracked one."""
    if isinstance(t, torch.Tensor) and radix.tracked(t):
        return _TORCH, True, None
    return np, False, t.device if isinstance(t, torch.Tensor) else None


def _host_t(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def _to_device(x, traced, device):
    if traced:
        return x
    return fftapi._f32(np.asarray(x), device)


def _nan_unless(ok, y, xp):
    """``y`` where the scipy parameter test ``ok`` holds, NaN elsewhere."""
    if xp is np:
        return np.where(ok, y, np.nan)
    return torch.where(torch.as_tensor(ok, device=y.device), y, math.nan)


def _chirp_phase(t, f0, t1, f1, method, vertex_zero, xp):
    if method in ("linear", "lin", "li"):
        beta = (f1 - f0) / t1
        return 2 * np.pi * (f0 * t + 0.5 * beta * t * t)
    if method in ("quadratic", "quad", "q"):
        beta = (f1 - f0) / (t1 ** 2)
        if vertex_zero:
            return 2 * np.pi * (f0 * t + beta * t ** 3 / 3)
        return 2 * np.pi * (f1 * t + beta * ((t1 - t) ** 3 - t1 ** 3) / 3)
    if method in ("logarithmic", "log", "lo"):
        if f0 * f1 <= 0:
            raise PlanError("logarithmic chirp needs f0 and f1 nonzero "
                            "with the same sign")
        if f0 == f1:
            return 2 * np.pi * f0 * t
        beta = t1 / np.log(f1 / f0)
        return 2 * np.pi * beta * f0 * (xp.power(f1 / f0, t / t1) - 1.0)
    if method in ("hyperbolic", "hyp"):
        if f0 == 0 or f1 == 0:
            raise PlanError("hyperbolic chirp needs nonzero f0 and f1")
        if f0 == f1:
            return 2 * np.pi * f0 * t
        sing = -f1 * t1 / (f0 - f1)
        return -2 * np.pi * f0 * sing * xp.log(xp.abs(1 - t / sing))
    raise PlanError(f"unknown chirp method {method!r} (linear, quadratic, "
                    "logarithmic, hyperbolic)")


def chirp(t, f0, t1, f1, method: str = "linear", phi=0,
          vertex_zero: bool = True, *, complex: bool = False):
    """Frequency-swept cosine (scipy.signal.chirp semantics).  With
    ``complex=True`` returns the analytic sweep as an interleaved
    (..., 2) tensor (``fftapi.ascomplex`` for a complex view)."""
    xp, traced, device = _xp_for(t)
    if not traced:
        t = _host_t(t)
    phase = _chirp_phase(t, f0, t1, f1, method, vertex_zero, xp)
    phase = phase + np.pi * phi / 180.0
    if complex:
        # exp(+1j phase): scipy's analytic convention
        return _to_device(xp.stack([xp.cos(phase), xp.sin(phase)], -1),
                          traced, device)
    return _to_device(xp.cos(phase), traced, device)


def _horner(coeffs, t):
    """The polynomial with ``coeffs`` (highest first) at tensor ``t``."""
    out = torch.zeros_like(t)
    for a in coeffs:
        out = out * t + float(a)
    return out


def sweep_poly(t, poly, phi=0):
    """Cosine with polynomial frequency law f(t) = poly(t)
    (scipy.signal.sweep_poly semantics; ``poly`` is coefficient array
    highest-first or np.poly1d)."""
    xp, traced, device = _xp_for(t)
    if not traced:
        t = _host_t(t)
    p = np.poly1d(poly)
    intp = p.integ()                         # host coefficient integral
    if traced:
        phase = 2 * np.pi * _horner(intp.coeffs.astype(np.float32), t)
    else:
        phase = 2 * np.pi * intp(t)
    return _to_device(xp.cos(phase + np.pi * phi / 180.0), traced, device)


def gausspulse(t, fc: float = 1000, bw: float = 0.5, bwr: float = -6,
               tpr: float = -60, retquad: bool = False,
               retenv: bool = False):
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse semantics),
    including ``t='cutoff'``."""
    if fc < 0:
        raise PlanError(f"fc must be nonnegative, got {fc}")
    if bw <= 0:
        raise PlanError(f"bw must be positive, got {bw}")
    if bwr >= 0:
        raise PlanError(f"bwr must be negative, got {bwr}")
    ref = pow(10.0, bwr / 20.0)
    # exp(-a t^2) envelope whose spectrum is `ref` down at +-bw*fc/2
    a = -(np.pi * fc * bw) ** 2 / (4.0 * np.log(ref))
    if isinstance(t, str):
        if t != "cutoff":
            raise PlanError("t must be an array or the string 'cutoff'")
        if tpr >= 0:
            raise PlanError(f"tpr must be negative, got {tpr}")
        tref = pow(10.0, tpr / 20.0)
        return float(np.sqrt(-np.log(tref) / a))
    xp, traced, device = _xp_for(t)
    if not traced:
        t = _host_t(t)
    env = xp.exp(-a * t * t)
    yi = env * xp.cos(2 * np.pi * fc * t)
    out = [yi]
    if retquad:
        out.append(env * xp.sin(2 * np.pi * fc * t))
    if retenv:
        out.append(env)
    if len(out) == 1:
        return _to_device(out[0], traced, device)
    return tuple(_to_device(o, traced, device) for o in out)


def sawtooth(t, width=1):
    """Periodic sawtooth/triangle wave, period 2*pi
    (scipy.signal.sawtooth semantics)."""
    xp, traced, device = _xp_for(t)
    if not traced:
        t = _host_t(t)
    w = width
    tmod = xp.mod(t, 2 * np.pi)
    rising = tmod < w * 2 * np.pi
    up = xp.where(rising, tmod / (w * np.pi) - 1.0 if w > 0 else 0.0, 0.0)
    down = xp.where(rising, 0.0,
                    (np.pi * (w + 1) - tmod) / (np.pi * (1 - w))
                    if w < 1 else 0.0)
    y = xp.where(rising, up, down)
    ok = (0 <= np.asarray(width)) & (np.asarray(width) <= 1)
    return _to_device(_nan_unless(ok, y, xp), traced, device)


def square(t, duty=0.5):
    """Periodic square wave, period 2*pi (scipy.signal.square
    semantics: +1 for the first ``duty`` fraction, -1 after)."""
    xp, traced, device = _xp_for(t)
    if not traced:
        t = _host_t(t)
    tmod = xp.mod(t, 2 * np.pi)
    y = xp.where(tmod < duty * 2 * np.pi, 1.0, -1.0)
    ok = (0 <= np.asarray(duty)) & (np.asarray(duty) <= 1)
    return _to_device(_nan_unless(ok, y, xp), traced, device)


def unit_impulse(shape, idx=None, dtype=float):
    """Unit impulse delta(n - idx) (scipy.signal.unit_impulse
    semantics; idx='mid' centers it), a float32 tensor on the facade's
    default device (another ``dtype`` keeps its numpy type there)."""
    out = np.zeros(shape, dtype)
    shape_t = (shape,) if np.ndim(shape) == 0 else tuple(shape)
    if idx is None:
        idx = (0,) * len(shape_t)
    elif idx == "mid":
        idx = tuple(s // 2 for s in shape_t)
    elif np.ndim(idx) == 0 and len(shape_t) > 1:
        idx = (idx,) * len(shape_t)
    out[tuple(np.atleast_1d(idx))] = 1
    if dtype is float:
        return fftapi._f32(out)
    return torch.from_numpy(out).to(fftapi._default_device())


# standard published maximum-length LFSR tap table (Fibonacci form),
# indexed by register length; same polynomials scipy uses
_MLS_TAPS = {
    2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6], 8: [7, 6, 1],
    9: [5], 10: [7], 11: [9], 12: [11, 10, 4], 13: [12, 11, 8],
    14: [13, 12, 2], 15: [14], 16: [15, 13, 4], 17: [14], 18: [11],
    19: [18, 17, 14], 20: [17], 21: [19], 22: [21], 23: [18],
    24: [23, 22, 17], 25: [22], 26: [25, 24, 20], 27: [26, 25, 22],
    28: [25], 29: [27], 30: [29, 28, 7], 31: [28], 32: [31, 30, 10],
}


def max_len_seq(nbits: int, state=None, length=None, taps=None):
    """Maximum-length sequence (MLS) generator
    (scipy.signal.max_len_seq semantics): Fibonacci LFSR over GF(2) on a
    circular state buffer; returns ``(seq, final_state)`` as host numpy.
    Host bit recursion: an MLS is a TABLE like the window functions,
    consumed by device pipelines (e.g. impulse-response measurement via
    fftconvolve)."""
    nbits = int(nbits)
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise PlanError(f"nbits must be between 2 and 32 when taps is "
                            f"not given, got {nbits}")
        taps = np.array(_MLS_TAPS[nbits], np.intp)
    else:
        taps = np.unique(np.asarray(taps, np.intp))[::-1]
        if np.any(taps < 0) or np.any(taps > nbits) or taps.size < 1:
            raise PlanError("taps must be non-empty with values between "
                            "0 and nbits (inclusive)")
        taps = np.asarray(taps, np.intp)
    n_max = (2 ** nbits) - 1
    if length is None:
        length = n_max
    else:
        length = int(length)
        if length < 0:
            raise PlanError("length must be greater than or equal to 0")
    if state is None:
        state = np.ones(nbits, dtype=np.int8)
    else:
        state = (np.asarray(state, dtype=np.float64) != 0).astype(np.int8)
    if state.ndim != 1 or state.size != nbits:
        raise PlanError("state must be a 1-D array of size nbits")
    if np.all(state == 0):
        raise PlanError("state must not be all zeros")
    seq = np.empty(length, dtype=np.int8)
    idx = 0
    for i in range(length):
        fb = state[idx]
        seq[i] = fb
        for t in taps:
            fb ^= state[(t + idx) % nbits]
        state[idx] = fb
        idx = (idx + 1) % nbits
    return seq, np.roll(state, -idx)
