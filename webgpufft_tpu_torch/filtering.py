"""scipy.signal-style digital filtering on the package's compute path.

Port of ``webgpufft_tpu/filtering.py``, the port's own copy.  Design
utilities (firwin/firwin2/savgol_coeffs/lfilter_zi/remez/...) are host
numpy table precompute, copied as they are.  Application functions run on
the data's device (a tensor where it lives, anything else on the facade's
default device):

- FIR filtering routes through the plan layer's FFT convolution
  (``fftapi.fftconvolve`` -> ``create_plan(type="fftconv")``, which takes
  the overlap-save block route for long signals), so ``lfilter`` with
  ``a = [1]``, ``savgol_filter`` and ``wiener`` run on the package's CUDA
  kernels (K1/K2) on the card.
- IIR filtering is the transposed direct-form-II recurrence.  The JAX
  package runs it as a ``lax.scan``; eager PyTorch has no device loop, so
  it runs one of two exact orderings of the same recurrence:
  ``_iir_seq``, a host-driven loop of five launches a sample, or
  ``_iir_assoc``, the parallel prefix over the affine state maps (log2(n)
  rounds of batched K x K products), for order <= ``IIR_ASSOC_MAX_K``.  The
  gate is ``IIR_ASSOC_MIN_N`` for CPU tensors (off: the JAX package's
  default and the route the CPU tests compare) and ``IIR_ASSOC_MIN_N_CUDA``
  for CUDA tensors (measured on the card, see its comment).  Above
  ``IIR_ASSOC_MAX_K`` (ba-form ``lfilter`` / ``filtfilt`` of order > 4)
  every device runs the sequential loop, as the JAX package does
  everywhere.  Whichever route the gate names runs; nothing falls back.
- Every product of the recurrences and the edge rules runs in full float32,
  as the JAX package's run at ``Precision.HIGHEST``: the edge rules' and the
  FIR state's einsums under ``core.precision.full_f32``, the parallel
  prefix's K x K products as broadcast multiply-adds (``_small_mm``).

Everything is pinned against scipy.signal and the JAX package in
tests/test_torch_filtering.py.  Real coefficients only; complex DATA is
supported by riding the interleaved component dim as batch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as _F

from . import fftapi
from .core.cplx import cmul_t4, to_t4
from .core.precision import full_f32
from .fftapi import asinterleaved, fftconvolve
from .spec import PlanError
# IIR design lives in its own module (pure host coefficient math); it is
# re-exported here so the scipy.signal call set is one namespace:
# ``from webgpufft_tpu_torch.filtering import butter, sosfiltfilt``.
from . import iirdesign as _iirdesign
# Peak finding and the LTI toolbox live in their own modules; their
# whole __all__ is re-exported programmatically so the scipy.signal
# single-namespace story can never drift out of sync with the modules.
from . import peaks as _peaks
from . import ltisys as _ltisys

__all__ = [
    "firwin", "firwin2", "firwin_2d", "kaiser_beta", "kaiser_atten",
    "freqz", "sosfreqz", "freqz_sos", "freqz_zpk", "group_delay",
    "firls", "minimum_phase", "remez", "kaiserord",
    "lfilter", "lfilter_zi", "lfiltic", "filtfilt",
    "sosfilt", "sosfilt_zi", "sosfiltfilt",
    "savgol_coeffs", "savgol_filter",
    "wiener", "order_filter", "medfilt", "medfilt2d",
] + list(_iirdesign.__all__) + list(_peaks.__all__) \
    + list(_ltisys.__all__)

for _mod in (_iirdesign, _peaks, _ltisys):
    for _name in _mod.__all__:
        globals()[_name] = getattr(_mod, _name)
del _mod, _name


# ------------------------------------------------------------- FIR design

def kaiser_beta(a: float) -> float:
    """Kaiser-window beta for ``a`` dB of attenuation
    (scipy.signal.kaiser_beta)."""
    a = float(a)
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation of a Kaiser-window FIR of ``numtaps`` taps and
    normalized transition ``width`` (scipy.signal.kaiser_atten)."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def firwin(numtaps: int, cutoff, *, width: Optional[float] = None,
           window="hamming", pass_zero=True, scale: bool = True,
           fs: Optional[float] = None) -> np.ndarray:
    """Window-method FIR design (scipy.signal.firwin semantics): sums of
    sinc band responses, windowed and optionally gain-normalized at the
    first passband center.  Returns a host numpy float64 tap array ready
    for :func:`lfilter` / fftapi.upfirdn."""
    numtaps = int(numtaps)
    if numtaps < 1:
        raise PlanError("numtaps must be >= 1")
    nyq = 0.5 * (2.0 if fs is None else float(fs))
    cutoff = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) / nyq
    if cutoff.ndim > 1:
        raise PlanError("cutoff must be a scalar or a 1-D sequence")
    if cutoff.size == 0:
        raise PlanError("at least one cutoff frequency is required")
    if np.any(cutoff <= 0) or np.any(cutoff >= 1):
        raise PlanError("cutoff must be strictly between 0 and fs/2")
    if np.any(np.diff(cutoff) <= 0):
        raise PlanError("cutoff frequencies must be strictly increasing")
    if isinstance(pass_zero, str):
        if pass_zero in ("bandstop", "lowpass"):
            if pass_zero == "lowpass" and cutoff.size != 1:
                raise PlanError("lowpass takes exactly one cutoff")
            pass_zero = True
        elif pass_zero in ("bandpass", "highpass"):
            if pass_zero == "highpass" and cutoff.size != 1:
                raise PlanError("highpass takes exactly one cutoff")
            pass_zero = False
        else:
            raise PlanError(f"pass_zero must be bool|'bandpass'|'lowpass'|"
                            f"'highpass'|'bandstop', got {pass_zero!r}")
    pass_nyquist = bool(cutoff.size & 1) ^ bool(pass_zero)
    if pass_nyquist and numtaps % 2 == 0:
        raise PlanError("an even-numtaps filter cannot pass the Nyquist "
                        "frequency (type II zero there); use odd numtaps")
    if width is not None:
        window = ("kaiser", kaiser_beta(kaiser_atten(numtaps, width / nyq)))
    bands = np.concatenate([
        [0.0] if pass_zero else [],
        cutoff,
        [1.0] if pass_nyquist else []]).reshape(-1, 2)
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2
    h = np.zeros(numtaps, dtype=np.float64)
    for left, right in bands:
        h += right * np.sinc(right * m)
        h -= left * np.sinc(left * m)
    # f64 window straight from the zoo — filter tables must not pass
    # through the f32 device-window cast
    from .windows import get_window as _gw64
    h *= np.asarray(_gw64(window, numtaps, fftbins=False),
                    dtype=np.float64)
    if scale:
        left, right = bands[0]
        scale_freq = (0.0 if left == 0 else
                      1.0 if right == 1 else (left + right) / 2)
        h /= np.sum(h * np.cos(np.pi * m * scale_freq))
    return h


def firwin2(numtaps: int, freq, gain, *, nfreqs: Optional[int] = None,
            window="hamming", antisymmetric: bool = False,
            fs: Optional[float] = None) -> np.ndarray:
    """Frequency-sampling FIR design (scipy.signal.firwin2 semantics):
    interpolate the desired response onto a dense grid, inverse-transform
    with the linear-phase shift folded in, window, truncate."""
    numtaps = int(numtaps)
    nyq = 0.5 * (2.0 if fs is None else float(fs))
    freq = np.asarray(freq, dtype=np.float64) / nyq
    gain = np.asarray(gain, dtype=np.float64)
    if freq.ndim != 1 or freq.shape != gain.shape:
        raise PlanError("freq and gain must be matching 1-D sequences")
    if freq[0] != 0 or freq[-1] != 1:
        raise PlanError("freq must start at 0 and end at fs/2")
    if np.any(np.diff(freq) < 0):
        raise PlanError("freq must be nondecreasing")
    _, counts = np.unique(freq, return_counts=True)
    if np.any(counts > 2):
        raise PlanError("freq may not contain a value more than twice")
    if freq[1] == 0 or freq[-2] == 1:
        raise PlanError("freq may repeat only at interior band edges")
    if antisymmetric:
        if numtaps % 2 == 0:
            ftype = 4
            if gain[0] != 0.0:
                raise PlanError("type IV filter must have zero gain at DC")
        else:
            ftype = 3
            if gain[0] != 0.0 or gain[-1] != 0.0:
                raise PlanError("type III filter must have zero gain at "
                                "DC and Nyquist")
    else:
        if numtaps % 2 == 0:
            ftype = 2
            if gain[-1] != 0.0:
                raise PlanError("type II filter must have zero gain at "
                                "Nyquist")
        else:
            ftype = 1
    if nfreqs is None:
        nfreqs = 1 + 2 ** int(math.ceil(math.log2(numtaps)))
    if numtaps > nfreqs:
        raise PlanError("nfreqs must be >= numtaps")
    # nudge repeated band-edge values apart so interp sees a step
    eps = np.finfo(np.float64).eps
    freq = freq.copy()
    for k in np.nonzero(np.diff(freq) == 0)[0]:
        freq[k] = freq[k] - eps * (nfreqs - 1)
        freq[k + 1] = freq[k + 1] + eps * (nfreqs - 1)
    x = np.linspace(0.0, 1.0, nfreqs)
    fx = np.interp(x, freq, gain)
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * np.pi * x)
    if ftype > 2:
        shift *= 1j
    out_full = np.fft.irfft(fx * shift)
    from .windows import get_window as _gw64
    win = np.asarray(_gw64(window, numtaps, fftbins=False),
                     dtype=np.float64) if window is not None else 1.0
    out = out_full[:numtaps] * win
    if ftype == 3:
        out[numtaps // 2] = 0.0
    return out


# ------------------------------------------------------- frequency response

def freqz(b, a=1, worN=512, whole: bool = False, *,
          include_nyquist: bool = False, fs: Optional[float] = None):
    """Digital filter frequency response (scipy.signal.freqz semantics).

    Integer ``worN`` grids run as one zero-padded FFT of the numerator
    through the facade (the denominator's is a short host table) — the
    same fast path scipy takes; an explicit frequency array takes host
    polynomial evaluation.  Returns ``(w, h)`` with ``h`` an interleaved
    (..., 2) tensor on the facade's default device (``fftapi.ascomplex``
    gives numpy complex)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if b.ndim != 1 or a.ndim != 1:
        raise PlanError("freqz b and a must be 1-D")
    fs_ = 2 * np.pi if fs is None else float(fs)
    if np.ndim(worN) == 0:
        N = int(worN)
        if N < 1:
            raise PlanError("worN must be positive")
        lastpoint = 2 * np.pi if whole else np.pi
        endpoint = include_nyquist and not whole
        w = np.linspace(0.0, lastpoint, N, endpoint=endpoint)
        # the uniform grid is the first N bins of an nfft-point DFT
        nfft = (2 * (N - 1)) if endpoint else (N if whole else 2 * N)
        if N > 1 and nfft >= len(b) and nfft >= len(a):
            hb = fftapi.fft(np.pad(b, (0, nfft - len(b))))[:N]
            if len(a) == 1:
                h = hb / float(np.float32(a[0]))
            else:
                ha = np.fft.fft(a, nfft)[:N]   # short host table
                h = cmul_t4(hb, fftapi._const(to_t4(1.0 / ha), hb))
            return w * (fs_ / (2 * np.pi)), h
    else:
        w = np.asarray(worN, dtype=np.float64)
        if fs is not None:
            w = w * (2 * np.pi / fs_)
    # host evaluation: direct polynomial evaluation at arbitrary/tiny grids
    zm1 = np.exp(-1j * w)
    h_np = (np.polynomial.polynomial.polyval(zm1, b)
            / np.polynomial.polynomial.polyval(zm1, a))
    return w * (fs_ / (2 * np.pi)), fftapi._f32(np.stack([h_np.real, h_np.imag], -1))


def _t4(h: torch.Tensor) -> torch.Tensor:
    """``to_t4`` of an interleaved tensor, on its device."""
    re, im = h[..., 0], h[..., 1]
    return torch.stack([torch.stack([re, im], -1), torch.stack([-im, re], -1)], -2)


def sosfreqz(sos, worN=512, whole: bool = False, *,
             fs: Optional[float] = None):
    """Frequency response of a second-order-section cascade
    (scipy.signal.sosfreqz): the product of per-section responses,
    accumulated on the device as t4 complex multiplies."""
    sos = _validate_sos(sos)
    w, h = freqz(sos[0, :3], sos[0, 3:], worN=worN, whole=whole, fs=fs)
    for sec in sos[1:]:
        _, hk = freqz(sec[:3], sec[3:], worN=worN, whole=whole, fs=fs)
        h = cmul_t4(h, _t4(hk))
    return w, h


# ------------------------------------------------------------- application

def _coeff_1d(c, name: str) -> np.ndarray:
    c = np.atleast_1d(np.asarray(c, dtype=np.float64))
    if c.ndim != 1:
        raise PlanError(f"{name} must be 1-D")
    if np.iscomplexobj(c):
        raise PlanError(f"complex {name} coefficients are not supported "
                        "(complex DATA is; see module docstring)")
    return c


def _as_filter_data(x, axis: int):
    """Real or complex data -> (real f32 (..., n), restore, complex_in)
    with the filtered axis last; a complex input's component dim rides
    as an ordinary batch dim (the filters have real coefficients)."""
    complex_in = fftapi._is_complex(x)
    if complex_in:
        xv = asinterleaved(x)                      # (..., 2)
        nd = xv.ndim - 1
        ax = axis + nd if axis < 0 else axis
        if not 0 <= ax < nd:
            raise PlanError(f"axis {axis} out of range for rank {nd}")
        xv = torch.movedim(xv, ax, -2).transpose(-1, -2)  # (..., 2, n)

        def restore(y):
            return torch.movedim(y.transpose(-1, -2), -2, ax)
    else:
        xv = fftapi._f32(x)
        nd = xv.ndim
        ax = axis + nd if axis < 0 else axis
        if not 0 <= ax < nd:
            raise PlanError(f"axis {axis} out of range for rank {nd}")
        xv = torch.movedim(xv, ax, -1)

        def restore(y):
            return torch.movedim(y, -1, ax)
    return xv, restore, complex_in


def _state(zi, like: torch.Tensor, shape) -> torch.Tensor:
    """An initial state (numpy, list or a tensor on ``like``'s device) as
    float32 on that device, broadcast to ``shape``."""
    return fftapi._f32(zi, like.device).expand(shape)


# associative (log-depth) IIR route: the gate, per device.
# CPU tensors: off (None), the JAX package's default (IIR_ASSOC_MIN_N, set
# there from a CPU measurement: the sequential scan won 5.5x at 2^20, K=2).
# CUDA tensors: IIR_ASSOC_MIN_N_CUDA, the signal length from which the
# parallel prefix beats the host-driven sequential loop, measured by
# chip_smoke.py's IIR A/B phase (both routes, butter(K, 0.2), 8 lines,
# n = 2^3 .. 2^14, one call from an idle device) on an NVIDIA H100 80GB HBM3
# at 700.00 W: the prefix wins from n = 64 at K = 2 and at K = 4 (at 64
# samples 2.62 / 3.63 ms against the loop's 5.62 / 5.14 ms, at 32 it loses,
# 2.20 / 2.57 against 2.08 / 2.12; at 2^14 4.1 / 8.8 ms against 1159 / 1164
# ms: the loop costs 62-108 us a sample, all of it host work).  A later run
# read 32 for both; below 64 the two routes are within 1.5x of each other at
# a few ms, so the gate keeps the larger reading.
# K is capped because the prefix carries K x K cumulative matrices.
IIR_ASSOC_MIN_N: Optional[int] = None
IIR_ASSOC_MIN_N_CUDA: Optional[int] = 64
IIR_ASSOC_MAX_K = 4


def _assoc_gate(x: torch.Tensor) -> Optional[int]:
    return IIR_ASSOC_MIN_N_CUDA if x.is_cuda else IIR_ASSOC_MIN_N


def _iir_affine_parts(b: np.ndarray, a: np.ndarray):
    """The DF2T state recurrence written affinely: z_k = M z_{k-1} + v x_k
    with CONSTANT M (shift matrix with -a[1:] in column 0) and
    v = b[1:] - b0 a[1:]; the output taps y_k = b0 x_k + z_{k-1}[0]."""
    K = len(b) - 1
    M = np.zeros((K, K), np.float32)
    M[:, 0] = -a[1:]
    M[:K - 1, 1:] += np.eye(K - 1, dtype=np.float32)
    v = (b[1:] - b[0] * a[1:]).astype(np.float32)
    return M, v


def _small_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., I, J) @ b (..., J, K) with J <= IIR_ASSOC_MAX_K as J
    broadcast multiply-adds, summed in order j = 0, 1, ...  A batched
    cuBLAS product of millions of 2 x 2 matrices runs its 32 x 32 tiles
    nearly empty: on an NVIDIA H100 80GB HBM3 at 700 W one K = 2 section of
    (8, 2^22) took 42.9 ms of device time with ``torch.matmul``, 92 % of it
    in those products, and takes 6.7 ms this way (chip_profile.py)."""
    out = a[..., :, :1] * b[..., :1, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j:j + 1] * b[..., j:j + 1, :]
    return out


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 0."""
    out = even.new_empty((even.shape[0] + odd.shape[0],) + tuple(even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def _associative_scan(combine, elems):
    """Inclusive scan of ``combine`` along dim 0 by the odd/even recursion
    of ``jax.lax.associative_scan``, so that every product is formed from
    the same operands as in the JAX package (log2(n) levels)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine(tuple(e[0:n - 1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(ev, od) for ev, od in zip(even, odd))


def _iir_assoc(b: np.ndarray, a: np.ndarray, x, zi):
    """DF2T recurrence as a parallel prefix (associative scan) over the
    affine maps z -> M z + v x_k: combine((A1,c1),(A2,c2)) = (A2 A1,
    A2 c1 + c2).  Exact reordering of the sequential recurrence (f32
    rounding differs in the last bits).  Same contract as _iir_scan; the
    K x K products are broadcast multiply-adds in full float32 (``_small_mm``:
    no TF32 path, which log2(n) rounds of products would amplify, as the JAX
    package's comment on ``Precision.HIGHEST`` says)."""
    K = len(b) - 1
    M, v = _iir_affine_parts(b, a)
    lead = tuple(x.shape[:-1])
    n = x.shape[-1]
    xl = x.reshape(-1, n)                              # (L, n)
    c = xl.t()[..., None] * fftapi._const(v, x)        # (n, L, K)
    A = fftapi._const(M, x).expand(n, K, K)

    def combine(l, r):
        Al, cl = l
        Ar, cr = r
        # Ar (n', K, K) acts on cl (n', L, K): contract the last dim
        return _small_mm(Ar, Al), _small_mm(cl, Ar.transpose(-1, -2)) + cr

    Acum, ccum = _associative_scan(combine, (A, c))
    # z_k = Acum_k zi + ccum_k (inclusive, k = 1..n)
    z0 = zi.reshape(-1, K)
    zs = _small_mm(z0, Acum.transpose(-1, -2)) + ccum
    z_prev = torch.cat([z0.expand(1, *z0.shape), zs[:-1]])
    y = float(np.float32(b[0])) * xl + z_prev[..., 0].t()
    return y.reshape(*lead, n), zs[-1].reshape(*lead, K)


def _iir_seq(b: np.ndarray, a: np.ndarray, x, zi):
    """The JAX package's ``lax.scan`` step as a host-driven loop: per
    sample y = b0 x + z[0], z = shift(z) + x b[1:] - y a[1:] (five launches;
    the products with x are formed for every sample before the loop).
    Never waits for the device."""
    b32 = b.astype(np.float32)
    xb = x[..., None] * fftapi._const(b32[1:], x)      # (..., n, K)
    bx = float(b32[0]) * x
    a1 = fftapi._const(a.astype(np.float32)[1:], x)
    z, ys = zi, []
    for i in range(x.shape[-1]):
        yn = bx[..., i] + z[..., 0]
        z = _F.pad(z[..., 1:], (0, 1)) + xb[..., i, :] - yn[..., None] * a1
        ys.append(yn)
    return torch.stack(ys, -1), z


def _iir_scan(b: np.ndarray, a: np.ndarray, x, zi):
    """Transposed direct-form-II recurrence: the parallel prefix from the
    device's gate on (``_assoc_gate``) for order <= IIR_ASSOC_MAX_K, the
    sequential loop otherwise.

    x: (..., n) f32; zi: (..., K) f32.  Returns (y, zf)."""
    K = len(b) - 1
    gate = _assoc_gate(x)
    if gate is not None and K <= IIR_ASSOC_MAX_K and x.shape[-1] >= gate:
        return _iir_assoc(b, a, x, zi)
    return _iir_seq(b, a, x, zi)


def lfilter(b, a, x, axis: int = -1, zi=None):
    """Filter data along one axis (scipy.signal.lfilter semantics).

    FIR filters (``len(a) == 1``) run through the plan layer's FFT
    convolution (overlap-save blocks when long); IIR filters run the
    transposed direct-form-II recurrence (``_iir_scan``: the parallel
    prefix or the sequential loop, by the device's gate; order > 4 always
    the loop).  Returns ``y``, or ``(y, zf)`` when ``zi`` is given."""
    b = _coeff_1d(b, "b")
    a = _coeff_1d(a, "a")
    if a[0] == 0:
        raise PlanError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    K = max(len(a), len(b)) - 1
    bp = np.pad(b, (0, K + 1 - len(b)))
    ap = np.pad(a, (0, K + 1 - len(a)))
    xv, restore, _ = _as_filter_data(x, axis)
    n = xv.shape[-1]
    if zi is not None:
        zi_v = _state(zi, xv, xv.shape[:-1] + (K,))
    if K == 0:
        y = float(bp[0]) * xv
        out = restore(y)
        return (out, xv.new_zeros(xv.shape[:-1] + (0,))) if zi is not None \
            else out
    if len(a) == 1 and (zi is None or n >= K):
        # FIR fast path: one plan-layer convolution; with zi, the first K
        # samples get the initial-state contribution and the final state is
        # a K-tap correlation against the signal tail (state memory is K, so
        # zi itself never leaks into zf once n >= K)
        kb = bp.reshape((1,) * (xv.ndim - 1) + (K + 1,))
        y = fftconvolve(xv, kb, axes=-1)[..., :n]
        if zi is None:
            return restore(y)
        y = torch.cat([y[..., :K] + zi_v, y[..., K:]], -1)
        tailmat = np.zeros((K, K), dtype=np.float64)
        for k in range(K):
            for m_ in range(K - k):
                tailmat[k, m_] = bp[k + 1 + m_]
        xtail = torch.flip(xv[..., n - K:], (-1,))
        with full_f32():
            zf = torch.einsum("...m,km->...k", xtail, fftapi._const(tailmat, xv))
        return restore(y), zf
    z0 = zi_v if zi is not None else xv.new_zeros(xv.shape[:-1] + (K,))
    y, zf = _iir_scan(bp, ap, xv, z0)
    return (restore(y), zf) if zi is not None else restore(y)


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state initial conditions for a step input
    (scipy.signal.lfilter_zi): solve (I - companion(a).T) zi = B."""
    b = _coeff_1d(b, "b")
    a = _coeff_1d(a, "a")
    while len(a) > 1 and a[0] == 0:
        a = a[1:]
    if a[0] == 0:
        raise PlanError("a must have at least one nonzero coefficient")
    n = max(len(a), len(b))
    if n == 1:
        return np.zeros(0)
    a0 = a[0]
    a = np.pad(a / a0, (0, n - len(a)))
    b = np.pad(b / a0, (0, n - len(b)))
    companion = np.zeros((n - 1, n - 1))
    companion[0, :] = -a[1:]
    companion[np.arange(1, n - 1), np.arange(n - 2)] = 1.0
    IminusA = np.eye(n - 1) - companion.T
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(IminusA, B)


# filtfilt's edge extensions as numpy.pad modes of fftapi._pad_axis:
# "odd" = 2 x[0] - reflection, "even" = reflection, "constant" = the edge
_EXTENSIONS = {"odd": ("reflect", "odd"), "even": ("reflect", "even"),
               "constant": ("edge", "even")}


def _extend(xv, padtype: str, padlen: int):
    mode, kind = _EXTENSIONS[padtype]
    return fftapi._pad_axis(xv, -1, padlen, padlen, mode, reflect_type=kind)


def filtfilt(b, a, x, axis: int = -1, padtype: Optional[str] = "odd",
             padlen: Optional[int] = None, method: str = "pad"):
    """Zero-phase forward-backward filtering
    (scipy.signal.filtfilt, method='pad' semantics): extend, filter with
    steady-state initial conditions, reverse, repeat, crop."""
    if method != "pad":
        raise PlanError("only method='pad' is supported (Gustafsson's "
                        "method is a host-side least-squares edge solve; "
                        "use padtype/padlen to control the edges)")
    b = _coeff_1d(b, "b")
    a = _coeff_1d(a, "a")
    ntaps = max(len(a), len(b))
    if padtype is not None and padtype not in _EXTENSIONS:
        raise PlanError("padtype must be 'odd', 'even', 'constant' or None")
    edge = (3 * ntaps if padlen is None else int(padlen)) \
        if padtype is not None else 0
    xv, restore, _ = _as_filter_data(x, axis)
    n = xv.shape[-1]
    if edge >= n:
        raise PlanError(f"padlen ({edge}) must be less than the signal "
                        f"length ({n})")
    ext = _extend(xv, padtype, edge) if edge > 0 else xv
    zi = lfilter_zi(b, a).astype(np.float32)
    zi_shape = (1,) * (ext.ndim - 1) + (zi.shape[0],)
    zi_j = fftapi._const(zi.reshape(zi_shape), ext)
    y, _ = lfilter(b, a, ext, axis=-1, zi=zi_j * ext[..., :1])
    y = torch.flip(y, (-1,))
    y, _ = lfilter(b, a, y, axis=-1, zi=zi_j * y[..., :1])
    y = torch.flip(y, (-1,))
    if edge > 0:
        y = y[..., edge:-edge]
    return restore(y)


# ------------------------------------------------------------- SOS cascade

def _validate_sos(sos) -> np.ndarray:
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise PlanError("sos must have shape (n_sections, 6)")
    if np.any(sos[:, 3] == 0):
        raise PlanError("every section's a0 must be nonzero")
    return sos / sos[:, 3:4]


def sosfilt(sos, x, axis: int = -1, zi=None):
    """Cascaded second-order-section filtering (scipy.signal.sosfilt):
    each section runs the K=2 transposed direct-form-II recurrence in
    turn (``_iir_scan``)."""
    sos = _validate_sos(sos)
    xv, restore, _ = _as_filter_data(x, axis)
    want_zf = zi is not None
    if want_zf:
        zi_a = _state(zi, xv, (sos.shape[0],) + xv.shape[:-1] + (2,))
    zf_all = []
    for s_i, sec in enumerate(sos):
        z0 = zi_a[s_i] if want_zf else xv.new_zeros(xv.shape[:-1] + (2,))
        xv, zf = _iir_scan(sec[:3], sec[3:], xv, z0)
        zf_all.append(zf)
    out = restore(xv)
    if want_zf:
        return out, torch.stack(zf_all, 0)
    return out


def sosfilt_zi(sos) -> np.ndarray:
    """Steady-state initial conditions per section
    (scipy.signal.sosfilt_zi): each section's lfilter_zi scaled by the
    DC gain of everything before it."""
    sos = _validate_sos(sos)
    zi = np.empty((sos.shape[0], 2))
    scale = 1.0
    for i, sec in enumerate(sos):
        b, a = sec[:3], sec[3:]
        zi[i] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def sosfiltfilt(sos, x, axis: int = -1, padtype: Optional[str] = "odd",
                padlen: Optional[int] = None):
    """Zero-phase SOS filtering (scipy.signal.sosfiltfilt semantics)."""
    sos = _validate_sos(sos)
    # scipy's default padlen discounts sections with a trailing zero tap
    # (odd-order designs): 3 * (2*ns + 1 - min(#b2==0, #a2==0)).  The
    # result genuinely depends on this (the zi*x0 transient interacts
    # with the extension length) — pinned by test_filtering.
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min(int((sos[:, 2] == 0).sum()), int((sos[:, 5] == 0).sum()))
    if padtype is not None and padtype not in _EXTENSIONS:
        raise PlanError("padtype must be 'odd', 'even', 'constant' or None")
    edge = (ntaps * 3 if padlen is None else int(padlen)) \
        if padtype is not None else 0
    xv, restore, _ = _as_filter_data(x, axis)
    n = xv.shape[-1]
    if edge >= n:
        raise PlanError(f"padlen ({edge}) must be less than the signal "
                        f"length ({n})")
    ext = _extend(xv, padtype, edge) if edge > 0 else xv
    zi = sosfilt_zi(sos).astype(np.float32)          # (ns, 2)
    zi_j = fftapi._const(zi, ext).reshape(
        (sos.shape[0],) + (1,) * (ext.ndim - 1) + (2,))
    y, _ = sosfilt(sos, ext, axis=-1, zi=zi_j * ext[..., :1])
    y = torch.flip(y, (-1,))
    y, _ = sosfilt(sos, y, axis=-1, zi=zi_j * y[..., :1])
    y = torch.flip(y, (-1,))
    if edge > 0:
        y = y[..., edge:-edge]
    return restore(y)


# --------------------------------------------------------- Savitzky-Golay

def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, pos: Optional[float] = None,
                  use: str = "conv") -> np.ndarray:
    """Savitzky-Golay FIR coefficients (scipy.signal.savgol_coeffs):
    the least-squares local-polynomial smoother as one host lstsq."""
    window_length = int(window_length)
    polyorder = int(polyorder)
    if polyorder >= window_length:
        raise PlanError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen - 0.5 if rem == 0 else halflen
    if not (0 <= pos < window_length):
        raise PlanError("pos must be nonnegative and less than "
                        "window_length")
    if use not in ("conv", "dot"):
        raise PlanError("use must be 'conv' or 'dot'")
    if deriv > polyorder:
        return np.zeros(window_length)
    t = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        t = t[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = t ** order
    y = np.zeros(polyorder + 1)
    y[deriv] = float(math.factorial(deriv)) / (float(delta) ** deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def _savgol_edge_matrix(window_length: int, polyorder: int, deriv: int,
                        npts: int) -> np.ndarray:
    """Projection matrix E (npts, window_length): fit a degree-polyorder
    polynomial to a window and evaluate its deriv-th derivative at the
    first ``npts`` positions — the 'interp' edge rule as one matmul."""
    t = np.arange(window_length, dtype=np.float64)
    V = np.vander(t, polyorder + 1, increasing=True)   # (W, p+1)
    P = np.linalg.pinv(V)                               # (p+1, W)
    # derivative operator on increasing-power coefficients
    coeffs_idx = np.arange(polyorder + 1)
    D = np.zeros((polyorder + 1, polyorder + 1))
    for j in range(deriv, polyorder + 1):
        D[j - deriv, j] = math.perm(j, deriv)
    te = np.arange(npts, dtype=np.float64)
    Ve = np.vander(te, polyorder + 1, increasing=True)
    return Ve @ D @ P


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, axis: int = -1, mode: str = "interp",
                  cval: float = 0.0):
    """Savitzky-Golay smoothing (scipy.signal.savgol_filter semantics).

    The interior runs as one FIR convolution through the plan layer; the
    'interp' edge rule is a precomputed polynomial-projection matmul over
    the edge windows (no host loop, no per-batch polyfit)."""
    window_length = int(window_length)
    if mode not in ("mirror", "constant", "nearest", "wrap", "interp"):
        raise PlanError("mode must be 'mirror', 'constant', 'nearest', "
                        "'wrap' or 'interp'")
    coeffs = savgol_coeffs(window_length, polyorder, deriv=deriv,
                           delta=delta)
    xv, restore, _ = _as_filter_data(x, axis)
    n = xv.shape[-1]
    halflen = window_length // 2
    kb = coeffs.reshape((1,) * (xv.ndim - 1) + (window_length,))
    if mode == "interp":
        if window_length > n:
            raise PlanError("If mode is 'interp', window_length must be "
                            "less than or equal to the size of x")
        y = fftconvolve(xv, kb, mode="same", axes=-1)
        E = _savgol_edge_matrix(window_length, polyorder, deriv,
                                halflen) / (float(delta) ** deriv)
        Er = _savgol_edge_matrix(window_length, polyorder, deriv,
                                 window_length) / (float(delta) ** deriv)
        # right edge: fit the LAST window, evaluate at its last halflen
        # in-window positions
        Er = Er[window_length - halflen:]
        with full_f32():
            left = torch.einsum("...w,pw->...p", xv[..., :window_length],
                                fftapi._const(E, xv))
            right = torch.einsum("...w,pw->...p", xv[..., n - window_length:],
                                 fftapi._const(Er, xv))
        y = torch.cat([left, y[..., halflen:n - halflen], right], -1)
        return restore(y)
    if mode == "constant":
        ext = _F.pad(xv, (halflen, halflen), value=float(cval))
    else:
        pad = {"mirror": "reflect", "nearest": "edge", "wrap": "wrap"}[mode]
        ext = fftapi._pad_axis(xv, -1, halflen, halflen, pad)
    y = fftconvolve(ext, kb, mode="valid", axes=-1)
    return restore(y)


# ------------------------------------------------------------------ Wiener

def wiener(im, mysize=None, noise: Optional[float] = None):
    """Adaptive Wiener filter (scipy.signal.wiener semantics): local
    mean/variance via box convolutions through the plan layer, then the
    pointwise shrinkage."""
    if fftapi._is_complex(im):
        raise PlanError("wiener expects a real array (scipy's complex "
                        "path is deprecated)")
    xv = fftapi._f32(im)
    nd = xv.ndim
    if mysize is None:
        mysize = [3] * nd
    elif np.ndim(mysize) == 0:
        mysize = [int(mysize)] * nd
    else:
        mysize = [int(m) for m in mysize]
        if len(mysize) != nd:
            raise PlanError("mysize must match the input rank")
    size = float(np.prod(mysize))
    box = np.ones(tuple(mysize), dtype=np.float32)
    l_mean = fftconvolve(xv, box, mode="same") / size
    l_var = fftconvolve(xv * xv, box, mode="same") / size - l_mean * l_mean
    noise_v = l_var.mean() if noise is None else float(np.float32(noise))
    res = (xv - l_mean) * (1.0 - noise_v / torch.where(l_var == 0, 1.0,
                                                       l_var)) + l_mean
    return torch.where(l_var < noise_v, l_mean, res)


# --------------------------------------------------- order-statistic filters

def order_filter(a, domain, rank: int):
    """N-d order-statistic filter (scipy.signal.order_filter semantics):
    at every point, sort the neighbors selected by the nonzero entries of
    ``domain`` (zero-padded at the boundary) and keep the ``rank``-th.

    One shifted zero-padded slice per footprint point (nnz slices of one
    padded array, no gather), stacked and sorted along the footprint axis
    (``torch.sort``: NaNs sort last, as in the JAX package)."""
    if fftapi._is_complex(a):
        raise PlanError("order_filter expects a real array")
    xv = fftapi._f32(a)
    domain = np.asarray(domain)
    if domain.ndim != xv.ndim:
        raise PlanError("domain must have the same rank as the input")
    if any(s % 2 == 0 for s in domain.shape):
        raise PlanError("each dimension of domain should be odd")
    offsets = np.argwhere(domain != 0)
    nnz = offsets.shape[0]
    if nnz == 0:
        raise PlanError("domain must have at least one nonzero entry")
    rank = int(rank)
    if not 0 <= rank < nnz:
        raise PlanError(f"rank must be in [0, {nnz})")
    ext = xv
    for ax, s in enumerate(domain.shape):
        ext = fftapi._pad_axis(ext, ax, s // 2, s // 2)
    shp = xv.shape
    slices = [ext[tuple(slice(int(o), int(o) + s)
                        for o, s in zip(off, shp))] for off in offsets]
    return torch.sort(torch.stack(slices, 0), dim=0).values[rank]


def medfilt(volume, kernel_size=None):
    """N-d median filter (scipy.signal.medfilt semantics): zero-padded
    boundary, odd kernel per axis (default 3).  Runs as
    :func:`order_filter` with a full box footprint at the middle rank."""
    xv = np.ndim(volume)
    if kernel_size is None:
        kernel_size = [3] * xv
    elif np.ndim(kernel_size) == 0:
        kernel_size = [int(kernel_size)] * xv
    else:
        kernel_size = [int(k) for k in kernel_size]
        if len(kernel_size) != xv:
            raise PlanError("kernel_size must match the input rank")
    if any(k % 2 == 0 for k in kernel_size):
        raise PlanError("each element of kernel_size should be odd")
    domain = np.ones(tuple(kernel_size), dtype=np.int8)
    return order_filter(volume, domain, int(np.prod(kernel_size)) // 2)


def medfilt2d(input, kernel_size=3):
    """2-D median filter (scipy.signal.medfilt2d semantics — identical
    result to :func:`medfilt` on a rank-2 array)."""
    if np.ndim(input) != 2:
        raise PlanError("medfilt2d expects a 2-D array")
    return medfilt(input, kernel_size)


# ------------------------------------------------- response analysis (host)

def group_delay(system, w=512, whole: bool = False,
                fs: float = 2 * np.pi):
    """Group delay of a digital filter (scipy.signal.group_delay
    semantics): -d(angle(H))/dw via the Fejer differentiation identity on
    c = b * conj(reversed(a)), evaluated on the freqz grid.  Host
    analysis math (coefficient-table idiom); returns numpy ``(w, gd)``."""
    import warnings
    b, a = system
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    fs = float(fs)
    if np.ndim(w) == 0:
        n = int(w)
        w = np.linspace(0, 2 * np.pi if whole else np.pi, n, endpoint=False)
    else:
        w = 2 * np.pi * np.atleast_1d(np.asarray(w, dtype=np.float64)) / fs
    c = np.convolve(b, a[::-1])
    cr = c * np.arange(c.size)
    z = np.exp(-1j * w)
    num = np.polynomial.polynomial.polyval(z, cr)
    den = np.polynomial.polynomial.polyval(z, c)
    with np.errstate(divide="ignore", invalid="ignore"):
        gd = np.real(num / den) - a.size + 1
    singular = ~np.isfinite(gd)
    if np.any(singular):
        gd[singular] = 0
        warnings.warn("The group delay is singular at frequencies "
                      f"[{', '.join(f'{ws:.3f}' for ws in w[singular])}], "
                      "setting to 0", stacklevel=2)
    elif np.any(np.abs(den) < 10 * np.finfo(np.float64).eps):
        warnings.warn("The filter's denominator is extremely small at some "
                      "frequencies, around which a singularity may be "
                      "present", stacklevel=2)
    return w * (fs / (2 * np.pi)), gd


def freqz_zpk(z, p, k, worN=512, whole: bool = False,
              fs: Optional[float] = None):
    """Frequency response from zeros/poles/gain
    (scipy.signal.freqz_zpk semantics): h = k prod(zm - z)/prod(zm - p).
    Returns ``(w, h)`` with ``h`` interleaved (..., 2), like freqz."""
    z = np.atleast_1d(np.asarray(z))
    p = np.atleast_1d(np.asarray(p))
    fs_ = 2 * np.pi if fs is None else float(fs)
    if np.ndim(worN) == 0:
        n = int(worN)
        lastpoint = 2 * np.pi if whole else np.pi
        w = np.linspace(0, lastpoint, n, endpoint=False)
    else:
        w = 2 * np.pi * np.atleast_1d(np.asarray(worN, np.float64)) / fs_
    zm = np.exp(1j * w)
    h = k * np.prod(zm[:, None] - z[None, :], axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = h / np.prod(zm[:, None] - p[None, :], axis=1)
    return w * (fs_ / (2 * np.pi)), fftapi._f32(np.stack([h.real, h.imag], -1))


# ------------------------------------------------- least-squares FIR design

def firls(numtaps: int, bands, desired, *, weight=None,
          fs: Optional[float] = None):
    """Least-squares linear-phase (type I) FIR design
    (scipy.signal.firls semantics).  Host table math: the normal
    equations Q a = beta have Q = Toeplitz(q) + Hankel(q) from the band
    integrals of cos(pi n f), solved directly (least-squares fallback
    when a band spec makes Q singular)."""
    fs = 2.0 if fs is None else float(fs)
    nyq = 0.5 * fs
    numtaps = int(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise PlanError("numtaps must be odd and >= 1")
    m_half = (numtaps - 1) // 2
    bands = np.asarray(bands, dtype=np.float64).flatten() / nyq
    if len(bands) % 2:
        raise PlanError("bands must contain frequency pairs")
    if (bands < 0).any() or (bands > 1).any():
        raise PlanError("bands must be between 0 and fs/2")
    bands = bands.reshape(-1, 2)
    desired = np.asarray(desired, dtype=np.float64).flatten()
    if bands.size != desired.size:
        raise PlanError("desired must have one entry per band edge")
    desired = desired.reshape(-1, 2)
    if (np.diff(bands) <= 0).any() or (np.diff(bands[:, 0]) < 0).any():
        raise PlanError("bands must be monotonically nondecreasing with "
                        "width > 0")
    if (bands[:-1, 1] > bands[1:, 0]).any():
        raise PlanError("bands must not overlap")
    if weight is None:
        weight = np.ones(len(desired))
    weight = np.asarray(weight, dtype=np.float64).flatten()
    if len(weight) != len(desired):
        raise PlanError("weight needs one entry per band pair")

    # q(n) = sum_bands W int_f1^f2 cos(pi n f) df = W [f sinc(n f)]_f1^f2
    n = np.arange(numtaps)[:, None, None]
    q = np.diff(np.sinc(bands * n) * bands, axis=2)[:, :, 0] @ weight
    idx = np.arange(m_half + 1)
    Q = q[np.abs(idx[:, None] - idx[None, :])] + q[idx[:, None] + idx[None, :]]

    # beta(n) = sum_bands W int (m f + c) cos(pi n f) df with the linear
    # desired ramp (m, c) per band; n = 0 takes the L'Hopital limit
    n = n[:m_half + 1]
    slope = np.diff(desired, axis=1) / np.diff(bands, axis=1)
    const = desired[:, [0]] - bands[:, [0]] * slope
    beta = bands * (slope * bands + const) * np.sinc(bands * n)
    beta[0] -= slope * bands * bands / 2.0
    beta[1:] += slope * np.cos(n[1:] * np.pi * bands) / (np.pi * n[1:]) ** 2
    beta = np.diff(beta, axis=2)[:, :, 0] @ weight

    try:
        a = np.linalg.solve(Q, beta)
        if not np.all(np.isfinite(a)):
            raise np.linalg.LinAlgError
    except np.linalg.LinAlgError:
        a = np.linalg.lstsq(Q, beta, rcond=None)[0]
    return np.concatenate([a[:0:-1], [2 * a[0]], a[1:]])


# ------------------------------------------------- minimum-phase conversion

def minimum_phase(h, method: str = "homomorphic",
                  n_fft: Optional[int] = None, *, half: bool = True):
    """Minimum-phase version of a linear-phase FIR filter
    (scipy.signal.minimum_phase semantics; homomorphic cepstral method of
    Oppenheim & Schafer, or the discrete-Hilbert-transform method).

    Host f64 coefficient math, like the module's other design functions:
    the cepstral chain takes a log of near-zero stopband bins, so an f32
    spectrum's ~1e-6 absolute error becomes ~1% filter error (measured;
    the f64 host path is at 2e-11 of scipy).  Design-time, tiny sizes —
    not a data path."""
    import warnings
    if np.iscomplexobj(h):
        raise PlanError("complex filters are not supported")
    h = np.atleast_1d(np.asarray(h, dtype=np.float64))
    if h.ndim != 1 or h.size <= 2:
        raise PlanError("h must be 1-D and at least 3 samples long")
    n_half = h.size // 2
    if not np.any(np.abs(h[-n_half:][::-1] - h[:n_half])
                  <= 1e-8 + 1e-6 * np.abs(h[:n_half])):
        warnings.warn("h does not appear to be symmetric, conversion may "
                      "fail", RuntimeWarning, stacklevel=2)
    if method not in ("homomorphic", "hilbert"):
        raise PlanError("method must be 'homomorphic' or 'hilbert'")
    if method == "hilbert" and not half:
        raise PlanError("half=False is only supported with "
                        "method='homomorphic'")
    if n_fft is None:
        n_fft = 2 ** int(math.ceil(math.log2(2 * (h.size - 1) / 0.01)))
    n_fft = int(n_fft)
    if n_fft < h.size:
        raise PlanError(f"n_fft must be at least len(h)=={h.size}")
    n_out = (n_half + h.size % 2) if half else h.size
    fft, ifft = np.fft.fft, np.fft.ifft

    if method == "hilbert":
        # H(w) shifted to zero phase, normalized into [0, 1], sqrt ->
        # magnitude; then the modified discrete Hilbert transform
        w = np.arange(n_fft) * (2 * np.pi / n_fft * n_half)
        Hr = np.real(fft(h, n_fft) * np.exp(1j * w))
        dp = Hr.max() - 1.0
        ds = 0.0 - Hr.min()
        S = 4.0 / (math.sqrt(1 + dp + ds) + math.sqrt(1 - dp + ds)) ** 2
        mag = np.sqrt((Hr + ds) * S) + 1e-10
        # _dhtm: recon = Re ifft(mag * exp(fft(sig * ifft(log mag))))
        sig = np.zeros(n_fft)
        mid = n_fft // 2
        sig[1:mid] = 1.0
        sig[mid + 1:] = -1.0
        h_min = np.real(ifft(mag * np.exp(fft(sig * ifft(np.log(mag))))))
        return h_min[:n_out]

    # homomorphic: log magnitude -> cepstrum -> causal lifter -> exp
    mag = np.abs(fft(h, n_fft))
    mag = mag + 1e-7 * mag[mag > 0].min()
    logm = np.log(mag) * (0.5 if half else 1.0)
    cep = np.real(ifft(logm))
    win = np.zeros(n_fft)
    win[0] = 1.0
    win[1:n_fft // 2] = 2.0
    if n_fft % 2:
        win[n_fft // 2] = 1.0
    h_min = np.real(ifft(np.exp(fft(cep * win))))
    return h_min[:n_out]


# ------------------------------------------------- Parks-McClellan (remez)

def kaiserord(ripple: float, width: float):
    """Kaiser-window FIR order/beta for a given ripple (dB) and
    transition width (scipy.signal.kaiserord semantics)."""
    A = abs(float(ripple))
    if A < 8:
        raise PlanError("requested maximum ripple attenuation is too "
                        "small for the Kaiser formula")
    beta = kaiser_beta(A)
    numtaps = (A - 7.95) / 2.285 / (np.pi * float(width)) + 1
    return int(math.ceil(numtaps)), beta


def _pm_grid(numtaps: int, bands, desired, weight, grid_density: int,
             neg: int, differentiator: bool):
    """Dense Parks-McClellan evaluation grid with desired/weight values,
    matching the classic PM construction: spacing 0.5/(grid_density *
    nfcns) within each band, last in-band point snapped to the band
    edge (reference algorithm: McClellan, Parks & Rabiner 1973)."""
    nodd = numtaps % 2
    nfcns = numtaps // 2
    if nodd == 1 and neg == 0:
        nfcns += 1
    delf = 0.5 / (grid_density * nfcns)
    grid, des, wt, segs = [], [], [], []
    for (f1, f2), fx, w in zip(bands, desired, weight):
        f = f1
        if neg and len(grid) == 0 and f < delf:
            f = delf
        pts = [f]
        while pts[-1] + delf <= f2:
            pts.append(pts[-1] + delf)
        pts[-1] = f2
        for f in pts:
            if differentiator and fx >= 1e-4:
                des.append(fx * f)
                wt.append(w / f)
            else:
                des.append(fx)
                wt.append(w)
        segs.append((len(grid), len(grid) + len(pts) - 1))
        grid.extend(pts)
    grid = np.asarray(grid, np.float64)
    des = np.asarray(des, np.float64)
    wt = np.asarray(wt, np.float64)
    # the basis transform divides by cos(pi f) / sin(2 pi f) which vanish
    # at f = 0.5 when neg == nodd -- drop grid points in that zero zone
    if neg == nodd:
        keep = grid <= 0.5 - delf
        if not np.all(keep):
            grid, des, wt = grid[keep], des[keep], wt[keep]
            last = grid.size - 1
            segs = [(s, min(e, last)) for s, e in segs if s <= last]
    if nfcns + 1 > grid.size:
        raise PlanError("design grid has fewer points than extremal "
                        "frequencies; raise grid_density or shrink numtaps")
    # transform the desired/weight so the approximation runs over a pure
    # cosine series P(f) = sum b_k cos(2 pi k f)
    if neg == 0:
        if nodd == 0:
            q = np.cos(np.pi * grid)
            des, wt = des / q, wt * q
    else:
        q = np.sin(2 * np.pi * grid) if nodd else np.sin(np.pi * grid)
        des, wt = des / q, wt * q
    return grid, des, wt, nfcns, segs


def _pm_bary_weights(x: np.ndarray):
    """Second-kind barycentric weights over nodes x as (sign, log
    magnitude) pairs — clustered extremal nodes (x = cos collapses the
    band near f = 0 / 0.5) give weight spreads far beyond the float64
    exponent range, so magnitudes stay in the log domain and every
    consumer renormalizes per expression (only RATIOS matter)."""
    diff = x[:, None] - x[None, :]
    np.fill_diagonal(diff, 1.0)
    logs = -np.sum(np.log(np.abs(diff)), axis=1)
    signs = np.prod(np.sign(diff), axis=1)
    return signs, logs


def _pm_ratio(sgn, logw, num_f, den_f):
    """sum(w * num_f) / sum(w * den_f) with w = sgn * exp(logw),
    renormalized by max(logw) so the exp never over/underflows."""
    w = sgn * np.exp(logw - logw.max())
    return (w * num_f).sum() / (w * den_f).sum()


def _pm_eval(fgrid, xk, wk, yk):
    """Barycentric evaluation of the interpolant through (xk, yk) at
    x = cos(2 pi fgrid); wk is the (sign, log-magnitude) pair from
    _pm_bary_weights.  Per-point log-sum-exp keeps the clustered-node
    weight spread exact; node coincidences return yk exactly."""
    sgn, logw = wk
    x = np.cos(2 * np.pi * np.asarray(fgrid, np.float64))
    d = x[:, None] - xk[None, :]
    hit = d == 0.0
    d = np.where(hit, 1.0, d)
    t = logw[None, :] - np.log(np.abs(d))
    t -= t.max(axis=1, keepdims=True)
    term = sgn[None, :] * np.sign(d) * np.exp(t)
    num = (term * yk[None, :]).sum(axis=1)
    den = term.sum(axis=1)
    out = num / den
    any_hit = hit.any(axis=1)
    if np.any(any_hit):
        out[any_hit] = yk[np.argmax(hit[any_hit], axis=1)]
    return out


def _pm_exchange(grid, des, wt, nfcns, maxiter, segs):
    """Remez multiple-exchange on the dense grid.  Returns the final
    extremal nodes (xk, yk, wk) and the achieved deviation.

    Candidates each round are the per-band local maxima of |E|, every
    band edge, AND the previous extremals — the previous set carries the
    alternation skeleton at |E| = delta exactly, which guarantees the
    alternating selection below never collapses under r points (the de
    la Vallee Poussin bound then forces |delta| to grow monotonically)."""
    import warnings
    ngrid = grid.size
    r = nfcns + 1
    iext = np.round(np.linspace(0, ngrid - 1, r)).astype(np.int64)
    sigma = np.where(np.arange(r) % 2 == 0, 1.0, -1.0)
    last = None
    delta = 0.0
    for _ in range(maxiter):
        xk = np.cos(2 * np.pi * grid[iext])
        ak = _pm_bary_weights(xk)
        delta = _pm_ratio(*ak, des[iext], sigma / wt[iext])
        yk = des[iext] - sigma * delta / wt[iext]
        A = _pm_eval(grid, xk, ak, yk)
        E = wt * (A - des)
        mag = np.abs(E)
        parts = [iext]
        for s, e in segs:
            m = mag[s:e + 1]
            if m.size >= 3:
                parts.append(np.flatnonzero(
                    (m[1:-1] >= m[:-2]) & (m[1:-1] >= m[2:])) + 1 + s)
            parts.append(np.asarray([s, e], np.int64))
        cand = np.unique(np.concatenate(parts))
        # keep genuine ripples at/above the current level; previous
        # extremals always stay (|E| there is ±delta up to rounding,
        # and dropping one breaks the alternation-count guarantee)
        cand = cand[(mag[cand] >= abs(delta) * (1 - 1e-9))
                    | np.isin(cand, iext)]
        # collapse runs of equal sign to their peak -> alternating list
        sgn = np.sign(E[cand])
        sel = []
        i = 0
        while i < cand.size:
            j = i
            while j + 1 < cand.size and sgn[j + 1] == sgn[i]:
                j += 1
            blk = cand[i:j + 1]
            sel.append(blk[np.argmax(mag[blk])])
            i = j + 1
        sel = np.asarray(sel, np.int64)
        # trim to exactly r extremals, dropping the weakest end ripples
        while sel.size > r:
            if (sel.size - r) % 2 == 1:
                sel = sel[1:] if mag[sel[0]] < mag[sel[-1]] else sel[:-1]
            else:
                pair = np.argmin(np.maximum(mag[sel[:-1]], mag[sel[1:]]))
                sel = np.delete(sel, [pair, pair + 1])
        if sel.size < r:
            break
        if last is not None and np.array_equal(sel, last):
            iext = sel
            break
        last = sel
        iext = sel
        if mag[iext].max() <= abs(delta) * (1 + 1e-12):
            break
    else:
        warnings.warn("remez exchange did not fully converge in "
                      f"{maxiter} iterations; result may be suboptimal",
                      RuntimeWarning, stacklevel=3)
    xk = np.cos(2 * np.pi * grid[iext])
    ak = _pm_bary_weights(xk)
    delta = _pm_ratio(*ak, des[iext], sigma[:iext.size] / wt[iext])
    yk = des[iext] - sigma[:iext.size] * delta / wt[iext]
    return xk, ak, yk, delta


def remez(numtaps: int, bands, desired, *, weight=None,
          type: str = "bandpass", maxiter: int = 25,
          grid_density: int = 16, fs: Optional[float] = None):
    """Optimal equiripple FIR design via the Parks-McClellan exchange
    (scipy.signal.remez semantics; algorithm re-implemented from
    McClellan, Parks & Rabiner 1973 — cosine-basis Remez exchange with
    barycentric interpolation).  Host f64 design math; returns numpy
    taps ready for lfilter/fftconvolve."""
    fs = 1.0 if fs is None else float(fs)
    numtaps = int(numtaps)
    if numtaps < 3:
        raise PlanError("numtaps must be at least 3")
    if type not in ("bandpass", "differentiator", "hilbert"):
        raise PlanError("type must be 'bandpass', 'differentiator' or "
                        "'hilbert'")
    bands = np.asarray(bands, np.float64).ravel() / fs
    if bands.size % 2 or bands.size < 2:
        raise PlanError("bands must contain (lower, upper) pairs")
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > 0.5:
        raise PlanError("bands must be monotonic within [0, fs/2]")
    bands = bands.reshape(-1, 2)
    desired = np.asarray(desired, np.float64).ravel()
    if desired.size != bands.shape[0]:
        raise PlanError("desired must have one gain per band")
    if weight is None:
        weight = np.ones(desired.size)
    weight = np.asarray(weight, np.float64).ravel()
    if weight.size != desired.size:
        raise PlanError("weight must have one entry per band")

    neg = 0 if type == "bandpass" else 1
    nodd = numtaps % 2
    # amplitude-at-edge feasibility (a differentiator's desired is a
    # slope, so its amplitude fx*f vanishes at f=0 by construction)
    if type == "hilbert":
        if nodd and bands[-1, 1] >= 0.5 and desired[-1] != 0:
            raise PlanError("odd-length antisymmetric filters must have "
                            "zero response at the Nyquist frequency")
        if bands[0, 0] <= 0 and desired[0] != 0:
            raise PlanError("antisymmetric filters must have zero "
                            "response at zero frequency")
    if (not neg) and nodd == 0 and bands[-1, 1] >= 0.5 \
            and desired[-1] != 0:
        raise PlanError("even-length symmetric filters must have zero "
                        "response at the Nyquist frequency")

    grid, des, wt, nfcns, segs = _pm_grid(
        numtaps, bands, desired, weight, grid_density, neg,
        type == "differentiator")
    xk, ak, yk, _ = _pm_exchange(grid, des, wt, nfcns, maxiter, segs)

    # sample the TRUE amplitude response on the numtaps-point DFT grid
    # (a trig polynomial of degree < numtaps is exactly recovered)
    N = numtaps
    fj = np.arange(N) / N
    fold = np.minimum(fj, 1.0 - fj)
    P = _pm_eval(fold, xk, ak, yk)
    if neg == 0:
        qa = np.cos(np.pi * fj) if nodd == 0 else np.ones(N)
    else:
        qa = np.sin(2 * np.pi * fj) if nodd else np.sin(np.pi * fj)
    A = P * qa
    phase = np.exp(-1j * np.pi * fj * (numtaps - 1))
    H = A * phase * (1.0 if neg == 0 else 1j)
    h = np.fft.ifft(H).real[:numtaps]
    return h


# B-spline toolbox (splines.py) builds on lfilter/sosfilt above; the
# late import avoids circular module initialization while keeping the
# scipy.signal single-namespace story.
from . import splines as _splines  # noqa: E402

__all__ += list(_splines.__all__)
for _name in _splines.__all__:
    globals()[_name] = getattr(_splines, _name)
del _name


def lfiltic(b, a, y, x=None):
    """Initial lfilter state from past outputs/inputs
    (scipy.signal.lfiltic semantics): y = [y[-1], y[-2], ...],
    x = [x[-1], x[-2], ...]; host table math feeding lfilter's zi."""
    b = _coeff_1d(b, "b")
    a = _coeff_1d(a, "a")
    if a[0] == 0:
        raise PlanError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    N = a.size - 1
    M = b.size - 1
    K = max(M, N)
    y = np.asarray(y, dtype=np.float64).ravel()
    if y.size < N:
        y = np.concatenate([y, np.zeros(N - y.size)])
    if x is None:
        x = np.zeros(M)
    else:
        x = np.asarray(x, dtype=np.float64).ravel()
        if x.size < M:
            x = np.concatenate([x, np.zeros(M - x.size)])
    zi = np.zeros(K)
    for m in range(M):
        zi[m] += np.sum(b[m + 1:] * x[:M - m])
    for m in range(N):
        zi[m] -= np.sum(a[m + 1:] * y[:N - m])
    return zi


def freqz_sos(sos, worN=512, whole: bool = False, fs: float = 2 * np.pi):
    """Frequency response of an SOS filter — scipy's new name for
    sosfreqz (scipy.signal.freqz_sos)."""
    return sosfreqz(sos, worN=worN, whole=whole, fs=fs)


def firwin_2d(hsize, window, *, fc=None, fs: float = 2,
              circular: bool = False, pass_zero=True, scale: bool = True):
    """2-D window-method FIR design (scipy.signal.firwin_2d semantics):
    separable outer product of two 1-D firwin designs, or a circularly
    symmetric filter built by radial interpolation of an 8x-oversampled
    1-D design.  NOTE: like scipy 1.17, ``pass_zero``/``scale`` are
    accepted for signature parity but not forwarded (both branches use
    firwin's defaults)."""
    if len(hsize) != 2:
        raise PlanError("hsize must be a 2-element tuple or list")
    if circular:
        if fc is None:
            raise PlanError("Cutoff frequency `fc` must be provided when "
                            "`circular` is True")
        n_r = max(hsize[0], hsize[1]) * 8
        win_r = firwin(n_r, cutoff=fc, window=window, fs=fs)
        f1, f2 = np.meshgrid(np.linspace(-1, 1, hsize[0]),
                             np.linspace(-1, 1, hsize[1]))
        r = np.sqrt(f1 * f1 + f2 * f2)
        return np.interp(r, np.linspace(0, 1, n_r), np.asarray(win_r))
    if len(window) != 2:
        raise PlanError("window must be a 2-element tuple or list")
    row = firwin(hsize[0], cutoff=fc, window=window[0], fs=fs)
    col = firwin(hsize[1], cutoff=fc, window=window[1], fs=fs)
    return np.outer(row, col)
