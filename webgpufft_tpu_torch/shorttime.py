"""scipy.signal.ShortTimeFFT, the modern STFT/ISTFT class, on the
plan-layer transforms.  Port of ``webgpufft_tpu/shorttime.py``.

Window/dual-window/scaling math is host f64 table precompute (the
canonical dual is the window divided by its hop-aliased energy profile);
the per-call compute path is the facade's device machinery: ``unfold``
framing (fftapi._frame_segments, a view), plan-layer rfft/fft over the
frame batch, and the inverse block overlap-add (fftapi._overlap_add).

Spectrograms are interleaved float32 ``(..., f, p, 2)`` tensors (package
convention); scipy-complex comparisons go through ``fftapi.ascomplex``.
Slice geometry (p/k index algebra), FFT roll/phase_shift convention,
fft_mode variants incl. onesided2X factors, padding modes, scaling factors,
dual-window construction, border properties and extent follow
scipy.signal.ShortTimeFFT.  The device rule is the facade's: a tensor runs
where it lives, anything else on the facade's default device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .spec import PlanError
from .fftapi import (
    fft as _fft, rfft as _rfft, irfft as _irfft, ifft as _ifft,
    asinterleaved, _frame_segments, _overlap_add, get_window,
    _const, _f32, _is_complex, _pad_axis, _slice, _zero_pad,
)

__all__ = ["ShortTimeFFT", "closest_STFT_dual_window"]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")


def _canonical_dual(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical dual window: win / (hop-aliased |win|^2 profile).
    Raises when the profile has zeros (the STFT is not invertible)."""
    w2 = win.real ** 2 + win.imag ** 2 if np.iscomplexobj(win) \
        else win ** 2
    m = win.shape[0]
    # straightforward aliasing sum (m is small — table math)
    q = np.empty(m)
    for mm in range(m):
        q[mm] = np.sum(w2[mm % hop::hop])
    if np.any(q <= np.finfo(np.float64).tiny * 100):
        raise PlanError("Short-time Fourier Transform not invertible: "
                        "the hop-aliased window energy profile has zeros")
    return win / q


class ShortTimeFFT:
    """scipy.signal.ShortTimeFFT semantics on the plan-layer transforms.

    Slice p covers samples ``p*hop - m_num_mid + [0, m_num)``; the FFT
    input is the windowed slice zero-padded to ``mfft`` and cyclically
    rolled by ``-(m_num_mid + phase_shift)`` (no roll for
    ``phase_shift=None``) — the empirically pinned scipy convention.
    Real windows only (the package's filter-table idiom); complex
    signals are supported for the twosided/centered modes.
    """

    def __init__(self, win, hop: int, fs: float, *,
                 fft_mode: str = "onesided", mfft: Optional[int] = None,
                 dual_win=None, scale_to: Optional[str] = None,
                 phase_shift: Optional[int] = 0):
        win = np.asarray(win, dtype=np.float64)
        if win.ndim != 1 or win.size == 0:
            raise PlanError("win must be a non-empty 1-D array")
        if not np.all(np.isfinite(win)):
            raise PlanError("win must contain finite values")
        if np.iscomplexobj(win):
            raise PlanError("complex windows are not supported "
                            "(real window tables only)")
        self._win = win
        if not (isinstance(hop, (int, np.integer)) and 1 <= hop):
            raise PlanError("hop must be a positive integer")
        self._hop = int(hop)
        self._fs = float(fs)
        if self._fs <= 0:
            raise PlanError("fs must be positive")
        self._mfft = win.size if mfft is None else int(mfft)
        if self._mfft < win.size:
            raise PlanError("mfft must be >= len(win)")
        self._fft_mode = None
        self._scaling: Optional[str] = None
        self._phase_shift = None
        if dual_win is not None:
            dual_win = np.asarray(dual_win, dtype=np.float64)
            if dual_win.shape != win.shape:
                raise PlanError("dual_win must have the same shape as win")
            self._dual_win = dual_win
        else:
            self._dual_win = None          # computed lazily
        if scale_to is not None:
            self.scale_to(scale_to)       # before fft_mode: 2X needs it
        self.fft_mode = fft_mode
        self.phase_shift = phase_shift

    # ------------------------------------------------------ constructors

    @classmethod
    def from_window(cls, win_param, fs: float, nperseg: int,
                    noverlap: int, *, symmetric_win: bool = False,
                    fft_mode: str = "onesided",
                    mfft: Optional[int] = None,
                    scale_to: Optional[str] = None,
                    phase_shift: Optional[int] = 0):
        """Build from a scipy get_window parameter set
        (scipy.signal.ShortTimeFFT.from_window semantics)."""
        win = np.asarray(get_window(win_param, int(nperseg),
                                    fftbins=not symmetric_win),
                         dtype=np.float64)
        return cls(win, int(nperseg) - int(noverlap), fs,
                   fft_mode=fft_mode, mfft=mfft, scale_to=scale_to,
                   phase_shift=phase_shift)

    @classmethod
    def from_dual(cls, dual_win, hop: int, fs: float, *,
                  fft_mode: str = "onesided", mfft: Optional[int] = None,
                  scale_to: Optional[str] = None,
                  phase_shift: Optional[int] = 0):
        """Build with ``dual_win`` as the synthesis window; the analysis
        window becomes its canonical dual."""
        dual_win = np.asarray(dual_win, dtype=np.float64)
        win = _canonical_dual(dual_win, int(hop))
        return cls(win, hop, fs, fft_mode=fft_mode, mfft=mfft,
                   dual_win=dual_win, scale_to=scale_to,
                   phase_shift=phase_shift)

    @classmethod
    def from_win_equals_dual(cls, desired_win, hop: int, fs: float, *,
                             fft_mode: str = "onesided",
                             mfft: Optional[int] = None,
                             scale_to: Optional[str] = None,
                             phase_shift: Optional[int] = 0):
        """Normalize ``desired_win`` so the window equals its own dual
        (divide by the sqrt of the hop-aliased energy profile)."""
        desired_win = np.asarray(desired_win, dtype=np.float64)
        m = desired_win.size
        q = np.empty(m)
        for mm in range(m):
            q[mm] = np.sum(desired_win[mm % hop::hop] ** 2)
        if np.any(q <= np.finfo(np.float64).tiny * 100):
            raise PlanError("desired_win cannot be normalized to equal "
                            "its dual (hop-aliased energy has zeros)")
        win = desired_win / np.sqrt(q)
        unitary = scale_to == "unitary"
        obj = cls(win, hop, fs, fft_mode=fft_mode, mfft=mfft,
                  dual_win=win.copy(),
                  scale_to=None if unitary else scale_to,
                  phase_shift=phase_shift)
        if unitary:
            # unitary scaling: win / sqrt(mfft), dual * sqrt(mfft)
            # (the scipy factors, probed empirically)
            s = obj.mfft ** -0.5
            obj._win = obj._win * s
            obj._dual_win = obj._dual_win / s
            obj._scaling = "unitary"
        return obj

    # ---------------------------------------------------------- geometry

    @property
    def win(self) -> np.ndarray:
        return self._win

    @property
    def hop(self) -> int:
        return self._hop

    @property
    def fs(self) -> float:
        return self._fs

    @property
    def T(self) -> float:
        return 1.0 / self._fs

    @property
    def m_num(self) -> int:
        return self._win.size

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    @property
    def mfft(self) -> int:
        return self._mfft

    @mfft.setter
    def mfft(self, n: int):
        n = int(n)
        if n < self.m_num:
            raise PlanError("mfft must be >= len(win)")
        self._mfft = n

    @property
    def fft_mode(self) -> str:
        return self._fft_mode

    @fft_mode.setter
    def fft_mode(self, mode: str):
        if mode not in _FFT_MODES:
            raise PlanError(f"fft_mode must be one of {_FFT_MODES}")
        if mode == "onesided2X" and self._scaling is None:
            raise PlanError("fft_mode='onesided2X' needs scaling "
                            "'magnitude' or 'psd' — call scale_to first "
                            "or pass scale_to=")
        self._fft_mode = mode

    @property
    def phase_shift(self) -> Optional[int]:
        return self._phase_shift

    @phase_shift.setter
    def phase_shift(self, v: Optional[int]):
        if v is not None:
            v = int(v)
            if not -self.mfft < v < self.mfft:
                raise PlanError("phase_shift must satisfy "
                                "-mfft < phase_shift < mfft")
        self._phase_shift = v

    @property
    def scaling(self) -> Optional[str]:
        return self._scaling

    @property
    def fac_magnitude(self) -> float:
        if self._scaling == "magnitude":
            return 1.0
        return 1.0 / abs(np.sum(self._win))

    @property
    def fac_psd(self) -> float:
        if self._scaling == "psd":
            return 1.0
        return 1.0 / math.sqrt(np.sum(self._win ** 2) * self._fs)

    def scale_to(self, scaling: str):
        """Rescale window (and dual) in place so the STFT has
        'magnitude' or 'psd' scaling."""
        if scaling not in ("magnitude", "psd"):
            raise PlanError("scaling must be 'magnitude' or 'psd'")
        if self._scaling == scaling:
            return
        fac = self.fac_psd if scaling == "psd" else self.fac_magnitude
        self._win = self._win * fac
        if self._dual_win is not None:
            self._dual_win = self._dual_win / fac
        self._scaling = scaling

    @property
    def dual_win(self) -> np.ndarray:
        if self._dual_win is None:
            self._dual_win = _canonical_dual(self._win, self._hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            _ = self.dual_win
            return True
        except PlanError:
            return False

    @property
    def onesided_fft(self) -> bool:
        return self._fft_mode in ("onesided", "onesided2X")

    @property
    def f_pts(self) -> int:
        return self.mfft // 2 + 1 if self.onesided_fft else self.mfft

    @property
    def f(self) -> np.ndarray:
        if self.onesided_fft:
            return np.fft.rfftfreq(self.mfft, self.T)
        if self._fft_mode == "centered":
            return np.fft.fftshift(np.fft.fftfreq(self.mfft, self.T))
        return np.fft.fftfreq(self.mfft, self.T)

    @property
    def delta_f(self) -> float:
        return self._fs / self.mfft

    @property
    def delta_t(self) -> float:
        return self._hop * self.T

    @property
    def p_min(self) -> int:
        # smallest p whose slice [p*hop - mid, p*hop - mid + m) reaches
        # into the signal: p*hop + (m - mid) > 0, i.e. the STRICT
        # inequality matters when hop divides (m - mid)
        return (self.m_num_mid - self.m_num) // self._hop + 1

    @property
    def k_min(self) -> int:
        return self.p_min * self._hop - self.m_num_mid

    def p_max(self, n: int) -> int:
        """First p whose slice lies fully past sample n (exclusive end
        of the slice range)."""
        return (n + self.m_num_mid - 1) // self._hop + 1

    def k_max(self, n: int) -> int:
        return (self.p_max(n) - 1) * self._hop \
            + self.m_num - self.m_num_mid

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    @property
    def lower_border_end(self):
        """(k, p): first sample / slice index untouched by the
        pre-padding border slices."""
        p = -(-self.m_num_mid // self._hop)   # ceil(mid / hop)
        if self.p_min == 0 and self.m_num_mid == 0:
            return (0, 0)
        k = (p - 1) * self._hop + self.m_num - self.m_num_mid
        return (k, p)

    def upper_border_begin(self, n: int):
        """(k, p): first sample / slice index touching the post-padding."""
        p = (n - self.m_num + self.m_num_mid) // self._hop + 1
        return (p * self._hop - self.m_num_mid, p)

    def p_range(self, n: int, p0: Optional[int] = None,
                p1: Optional[int] = None):
        p0 = self.p_min if p0 is None else int(p0)
        p1 = self.p_max(n) if p1 is None else int(p1)
        if not self.p_min <= p0 < p1 <= self.p_max(n):
            raise PlanError(f"needs p_min <= p0 < p1 <= p_max(n), got "
                            f"p0={p0}, p1={p1}, p_min={self.p_min}, "
                            f"p_max({n})={self.p_max(n)}")
        return p0, p1

    def t(self, n: int, p0: Optional[int] = None, p1: Optional[int] = None,
          k_offset: int = 0) -> np.ndarray:
        p0, p1 = self.p_range(n, p0, p1)
        return (np.arange(p0, p1) * self._hop + k_offset) * self.T

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        """Nearest slice-center sample index (a hop multiple) at or
        left/right of k."""
        p = k // self._hop if left else -(-k // self._hop)
        return p * self._hop

    def extent(self, n: int, axes_seq: str = "tf",
               center_bins: bool = False):
        """imshow extents of the (t, f) grid."""
        if axes_seq not in ("tf", "ft"):
            raise PlanError("axes_seq must be 'tf' or 'ft'")
        tt = self.t(n)
        t0, t1 = float(tt[0]), float(tt[-1]) + self.delta_t
        fv = self.f
        f0, f1 = float(fv[0]), float(fv[-1]) + self.delta_f
        if center_bins:
            t0, t1 = t0 - self.delta_t / 2, t1 - self.delta_t / 2
            f0, f1 = f0 - self.delta_f / 2, f1 - self.delta_f / 2
        return (t0, t1, f0, f1) if axes_seq == "tf" else (f0, f1, t0, t1)

    # ----------------------------------------------------------- compute

    def _pad_mode(self, padding: str):
        try:
            return {"zeros": dict(mode="constant"),
                    "edge": dict(mode="edge"),
                    "even": dict(mode="reflect"),
                    "odd": dict(mode="reflect", reflect_type="odd"),
                    }[padding]
        except KeyError:
            raise PlanError("padding must be 'zeros', 'edge', 'even' or "
                            "'odd'") from None

    def _roll_amount(self) -> int:
        """The FFT input is rolled LEFT by this amount — scipy's pinned
        convention: (phase_shift + m_num_mid) taken MOD THE WINDOW
        LENGTH (not mfft; deep-fuzz-caught for negative shifts and odd
        windows), spectrum gains e^{+2 pi i q s / mfft}.  Zero when
        phase_shift is None."""
        if self._phase_shift is None:
            return 0
        return (self._phase_shift + self.m_num_mid) % self.m_num

    def _onesided2x_fac(self) -> np.ndarray:
        fac = np.ones(self.f_pts, np.float32)
        x2 = 2.0 if self._scaling == "magnitude" else math.sqrt(2.0)
        hi = self.f_pts - 1 if self.mfft % 2 == 0 else self.f_pts
        fac[1:hi] = x2
        return fac

    def stft(self, x, p0: Optional[int] = None, p1: Optional[int] = None,
             *, k_offset: int = 0, padding: str = "zeros",
             axis: int = -1, detr=None):
        """STFT (scipy.signal.ShortTimeFFT.stft semantics).  Returns
        interleaved float32 (..., f_pts, p1-p0, 2)."""
        complex_in = _is_complex(x)
        if complex_in:
            if self.onesided_fft:
                raise PlanError(f"Complex-valued x not allowed for "
                                f"fft_mode={self._fft_mode!r}; use "
                                f"'twosided' or 'centered'")
            xi = asinterleaved(x)
            xi = torch.movedim(xi, axis if axis >= 0 else axis - 1, -2)
            n = xi.shape[-2]
        else:
            xi = _f32(x)
            xi = torch.movedim(xi, axis, -1)
            n = xi.shape[-1]
        p0, p1 = self.p_range(n, p0, p1)
        nb = p1 - p0
        k_first = p0 * self._hop - self.m_num_mid + k_offset
        k_last = (p1 - 1) * self._hop - self.m_num_mid \
            + self.m_num + k_offset
        lpad = max(0, -k_first)
        rpad = max(0, k_last - n)
        kw = self._pad_mode(padding)
        tdim = -2 if complex_in else -1
        xp = _pad_axis(xi, tdim, lpad, rpad, **kw)
        start = k_first + lpad
        xp = _slice(xp, start, start + (nb - 1) * self._hop + self.m_num,
                    tdim)
        win32 = _const(self._win, xi)
        if complex_in:
            # frame the two lanes as batch: (..., n, 2) -> (..., 2, n)
            xp = torch.movedim(xp, -1, -2)
        fr = _frame_segments(xp, self.m_num, self._hop, nb)   # a view
        if detr is not None:
            fr = self._detrend(fr, detr)
        fr = fr * win32                                       # the copy
        fr = _zero_pad(fr, -1, 0, self.mfft - self.m_num)
        fr = torch.roll(fr, -self._roll_amount(), -1)
        if complex_in:
            fr = torch.movedim(fr, -3, -1)        # (..., nb, mfft, 2)
            Z = _fft(fr, axis=-1, interleaved=True)
        elif self.onesided_fft:
            Z = _rfft(fr, axis=-1)                # (..., nb, f, 2)
        else:
            Z = _fft(fr, axis=-1, interleaved=False)
        if self._fft_mode == "centered":
            Z = torch.roll(Z, self.mfft // 2, -2)
        if self._fft_mode == "onesided2X":
            Z = Z * _const(self._onesided2x_fac()[:, None], Z)
        Z = Z.transpose(-3, -2)                   # (..., f, p, 2)
        # scipy's multidimensional layout: the frequency axis replaces
        # the original time axis; the new slice axis is appended last
        a = axis % (Z.ndim - 2)                   # dims besides (p, lane)
        return torch.movedim(Z, -3, a)

    @staticmethod
    def _detrend(fr, detr):
        if callable(detr):
            return detr(fr)
        if detr == "constant":
            return fr - fr.mean(dim=-1, keepdim=True)
        if detr == "linear":
            m = fr.shape[-1]
            tt = _const(np.arange(m) - (m - 1) / 2.0, fr)
            denom = (tt * tt).sum()
            mean = fr.mean(dim=-1, keepdim=True)
            slope = (fr * tt).sum(dim=-1, keepdim=True) / denom
            return fr - mean - slope * tt
        raise PlanError("detr must be 'linear', 'constant', a callable "
                        "or None")

    def stft_detrend(self, x, detr, p0: Optional[int] = None,
                     p1: Optional[int] = None, *, k_offset: int = 0,
                     padding: str = "zeros", axis: int = -1):
        """STFT with per-slice detrending before windowing."""
        return self.stft(x, p0, p1, k_offset=k_offset, padding=padding,
                         axis=axis, detr=detr)

    def spectrogram(self, x, y=None, detr=None, *,
                    p0: Optional[int] = None, p1: Optional[int] = None,
                    k_offset: int = 0, padding: str = "zeros",
                    axis: int = -1):
        """|S_x|^2 (y=None) or the cross-spectrogram S_x * conj(S_y).
        Returns real float32 for the auto case, interleaved otherwise."""
        Sx = self.stft(x, p0, p1, k_offset=k_offset, padding=padding,
                       axis=axis, detr=detr)
        if y is None:
            return Sx[..., 0] ** 2 + Sx[..., 1] ** 2
        Sy = self.stft(y, p0, p1, k_offset=k_offset, padding=padding,
                       axis=axis, detr=detr)
        re = Sx[..., 0] * Sy[..., 0] + Sx[..., 1] * Sy[..., 1]
        im = Sx[..., 1] * Sy[..., 0] - Sx[..., 0] * Sy[..., 1]
        return torch.stack([re, im], dim=-1)

    def istft(self, S, k0: int = 0, k1: Optional[int] = None, *,
              f_axis: int = -2, t_axis: int = -1,
              interleaved: Optional[bool] = None):
        """Inverse STFT via the canonical dual window
        (scipy.signal.ShortTimeFFT.istft semantics).  ``S`` is assumed
        to start at slice p_min (a default-range stft output); returns
        the real (or interleaved complex) signal over [k0, k1)."""
        Z = asinterleaved(S, interleaved)
        # normalize axes: want (..., f, p, 2)
        fa = f_axis if f_axis >= 0 else f_axis - 1
        ta = t_axis if t_axis >= 0 else t_axis - 1
        if (fa % (Z.ndim - 1), ta % (Z.ndim - 1)) != (Z.ndim - 3,
                                                      Z.ndim - 2):
            Z = torch.movedim(Z, (fa, ta), (-3, -2))
        if Z.shape[-3] != self.f_pts:
            raise PlanError(f"S has {Z.shape[-3]} frequency rows; "
                            f"f_pts is {self.f_pts}")
        q = Z.shape[-2]
        # n implied by q slices (scipy's default k1); the slice-p_max
        # algebra gives n = (p_min + q - 1) * hop + (m_num - m_num_mid)
        n_impl = (self.p_min + q - 1) * self._hop \
            + (self.m_num - self.m_num_mid)
        # the overlap-add output physically ends here — the bound for k1
        k_hi = self.k_min + (q - 1) * self._hop + self.m_num
        if k1 is None:
            k1 = n_impl
        if not (self.k_min <= k0 < k1 <= k_hi):
            raise PlanError(f"needs k_min <= k0 < k1 <= k_max, got "
                            f"k0={k0}, k1={k1}, k_min={self.k_min}, "
                            f"k_max={k_hi}")
        if self._fft_mode == "onesided2X":
            Z = Z / _const(self._onesided2x_fac()[:, None, None], Z)
        if self._fft_mode == "centered":
            Z = torch.roll(Z, -(self.mfft // 2), -3)
        Zt = Z.transpose(-3, -2)                  # (..., p, f, 2)
        if self.onesided_fft:
            fr = _irfft(Zt, n=self.mfft, axis=-1,
                        interleaved=True)             # (..., p, mfft)
            fr = torch.roll(fr, self._roll_amount(), -1)
            fr = fr[..., :self.m_num]
            fr = fr * _const(self.dual_win, fr)
            y = _overlap_add(fr, self.m_num, self._hop)
            lo = k0 - self.k_min
            return _slice(y, lo, lo + (k1 - k0), -1)
        fr = _ifft(Zt, axis=-1, interleaved=True) # (..., p, mfft, 2)
        fr = torch.roll(fr, self._roll_amount(), -2)
        fr = fr[..., :self.m_num, :]
        fr = fr * _const(self.dual_win[:, None], fr)
        fr2 = torch.movedim(fr, -1, -3)           # (..., 2, p, m)
        y2 = _overlap_add(fr2, self.m_num, self._hop)
        y = torch.movedim(y2, -2, -1)             # (..., k, 2)
        lo = k0 - self.k_min
        return _slice(y, lo, lo + (k1 - k0), -2)


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *,
                             scaled: bool = True):
    """The valid STFT dual window closest to ``desired_dual``
    (scipy.signal.closest_STFT_dual_window semantics): project the
    desired window onto the affine space of windows satisfying the
    hop-biorthogonality constraint; with ``scaled`` the optimal scalar
    multiple of the projection direction is used.  Returns
    ``(dual_win, alpha)``."""
    win = np.asarray(win, dtype=np.float64)
    if desired_dual is None:
        desired_dual = np.ones_like(win)
    desired_dual = np.asarray(desired_dual, dtype=np.float64)
    if not (win.ndim == 1 and win.shape == desired_dual.shape):
        raise PlanError("win and desired_dual must be 1-D arrays of "
                        "equal length")
    if not np.all(np.isfinite(win)):
        raise PlanError("win must have finite entries")
    if not np.all(np.isfinite(desired_dual)):
        raise PlanError("desired_dual must have finite entries")
    if not (isinstance(hop, (int, np.integer)) and 1 <= hop <= win.size):
        raise PlanError(f"hop={hop!r} is not an integer between 1 and "
                        f"len(win)={win.size}")
    w_d = _canonical_dual(win, int(hop))
    # hop-aliased correlation of win with the desired dual, then the
    # projection residual direction q_d
    wdd = np.conj(win) * desired_dual
    q = wdd.copy()
    for k in range(hop, win.size, hop):
        q[k:] += wdd[:-k]
        q[:-k] += wdd[k:]
    q_d = w_d * q
    if not scaled:
        return w_d + desired_dual - q_d, 1.0
    numerator = np.conj(q_d) @ w_d
    denominator = q_d.real @ q_d.real + q_d.imag @ q_d.imag
    if not (abs(numerator) > 0
            and denominator > np.finfo(np.float64).resolution):
        raise PlanError("Unable to calculate scaled closest dual window "
                        "(numerically unstable scaling factor); try "
                        "scaled=False")
    alpha = numerator / denominator
    return w_d + alpha * (desired_dual - q_d), alpha
