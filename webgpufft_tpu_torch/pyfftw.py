"""pyfftw-compatible namespace over the plan layer.  Port of
``webgpufft_tpu/pyfftw.py``.

It mirrors pyfftw's public API:

- ``FFTW``: the planned-transform object (c2c / r2c / c2r schemes
  inferred from the array dtypes and shapes, plus ALL eleven FFTW
  real-to-real kinds: ``FFTW_REDFT*``/``FFTW_RODFT*`` mapped onto the
  plan layer's dct/dst types, and ``FFTW_R2HC``/``FFTW_HC2R``/
  ``FFTW_DHT`` computed from the packed rfft spectrum).  FFTW
  normalization conventions are kept exactly: ``execute()`` is
  raw/unnormalized in both directions, ``__call__(normalise_idft=True)``
  scales the backward transform by 1/N, ``ortho=True`` scales both
  directions by 1/sqrt(N).
- ``builders``: pre-planned callable objects with pyfftw's n=/s=
  crop-or-pad semantics.
- ``interfaces``: drop-in ``numpy_fft`` / ``scipy_fft`` /
  ``scipy_fftpack`` namespaces (the extra pyfftw keywords are accepted;
  see below for which ones do something here).
- wisdom: ``export_wisdom()`` / ``import_wisdom()`` / ``forget_wisdom``
  serialize the plan-cache snapshot (schema v3, including the measured
  planner's winners), which is this package's exact analog of FFTW
  wisdom.  The snapshot schema is the JAX package's, so wisdom exported by
  either package imports into the other.
- aligned-allocation helpers (``empty_aligned`` & co.) are real: they
  return numpy arrays aligned to the requested boundary (the device path
  has no host-pointer alignment requirement).

Device.  Arrays are numpy, in and out; the transform runs on a device taken
at construction: ``FFTW(..., device=...)`` and the ``device=`` keyword of every
``builders`` function.  ``None`` (the default) means the facade's default device at
execution time: ``"cuda"``, which raises without a GPU, unless a
``fftapi.default_device`` block is active.  ``interfaces`` follow the
facade's default device.

planner_effort mapping (documented, not silently ignored):

- ``FFTW_ESTIMATE`` and ``FFTW_MEASURE`` -> the static route policy
  (runtime/policy.py).
- ``FFTW_PATIENT`` / ``FFTW_EXHAUSTIVE`` -> ``tuning.rigor="measure"``:
  route candidates are timed live on the device on first build and the
  winner is cached + snapshot-persisted (runtime/measure.py), the
  behavioral analog of FFTW's planning effort.

Accepted-but-inert pyfftw keywords (``threads``, ``planning_timelimit``,
``overwrite_input``, ``auto_align_input``, ``auto_contiguous``,
``avoid_copy``, and the non-planning flags) are recorded on the object
(``FFTW.ignored_options``) per the repo's record-or-reject rule.

Precision: the device path computes in f32 (interleaved complex, see
core/cplx.py); float64/complex128 arrays are accepted and cast, with
results reported in the output array's dtype.
"""

from __future__ import annotations

import contextlib
import json
from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import fftapi
from . import fftpack as _fftpack_mod
from .spec import PlanError
from .runtime.cache import (
    default_cache,
    export_plan_cache_snapshot,
    import_plan_cache_snapshot,
)

__all__ = [
    "FFTW", "builders", "interfaces",
    "export_wisdom", "import_wisdom", "forget_wisdom",
    "empty_aligned", "zeros_aligned", "ones_aligned", "byte_align",
    "is_byte_aligned", "simd_alignment", "next_fast_len",
]

# The device path has no host-pointer alignment requirement; 128 bytes is
# reported for compatibility with code that allocates via simd_alignment
# (and is a cache-line-friendly host default).
simd_alignment = 128

next_fast_len = fftapi.next_fast_len

_MEASURE_EFFORTS = ("FFTW_PATIENT", "FFTW_EXHAUSTIVE")
_PLANNER_EFFORTS = ("FFTW_ESTIMATE", "FFTW_MEASURE") + _MEASURE_EFFORTS
_NONPLANNING_FLAGS = (
    "FFTW_DESTROY_INPUT", "FFTW_PRESERVE_INPUT", "FFTW_UNALIGNED",
    "FFTW_WISDOM_ONLY",
)

# FFTW real-to-real kinds -> (plan family, type) of the scipy/plan-layer
# trig transforms.  scipy's norm=None conventions ARE FFTW's (scipy.fft
# docs state the correspondence; re-pinned empirically in the tests).
# The halfcomplex and Hartley kinds (FFTW r2r kinds with no scipy trig
# analog) are computed from the packed rfft spectrum below.
_R2R_KINDS = {
    "FFTW_REDFT00": ("dct", 1), "FFTW_REDFT10": ("dct", 2),
    "FFTW_REDFT01": ("dct", 3), "FFTW_REDFT11": ("dct", 4),
    "FFTW_RODFT00": ("dst", 1), "FFTW_RODFT10": ("dst", 2),
    "FFTW_RODFT01": ("dst", 3), "FFTW_RODFT11": ("dst", 4),
    "FFTW_R2HC": ("r2hc", None), "FFTW_HC2R": ("hc2r", None),
    "FFTW_DHT": ("dht", None),
}


def _axslice(x, axis: int, start: int, stop: int):
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(start, stop)
    return x[tuple(sl)]


def _r2hc_axis(y, a: int):
    """FFTW R2HC: real -> halfcomplex layout r0..r_{n/2}, i_{..}..i_1
    (FFTW manual §'The Halfcomplex-format DFT'), via the packed rfft —
    real parts head, imaginary parts 1..ceil(n/2)-1 reversed tail (the
    even-n Nyquist imaginary part is identically zero and omitted)."""
    n = int(y.shape[a])
    X = fftapi.rfft(y, axis=a)            # interleaved (..., n//2+1, .., 2)
    re, im = X[..., 0], X[..., 1]
    tail = torch.flip(_axslice(im, a, 1, (n + 1) // 2), (a,))
    return torch.cat([re, tail], dim=a)


def _hc2r_axis(y, a: int):
    """FFTW HC2R: halfcomplex -> real, unnormalized (roundtrip with R2HC
    yields n * x, like FFTW).  Rebuilds the packed spectrum and runs the
    unscaled inverse rfft."""
    n = int(y.shape[a])
    y = fftapi._f32(y)
    re = _axslice(y, a, 0, n // 2 + 1)
    n_im = (n + 1) // 2 - 1               # stored imaginary entries
    mid = torch.flip(_axslice(y, a, n - n_im, n), (a,))
    zero = torch.zeros_like(_axslice(re, a, 0, 1))
    parts = [zero, mid] + ([zero] if n % 2 == 0 and n > 1 else [])
    im = torch.cat(parts, dim=a) if n > 1 else zero
    X = torch.stack([re, im], dim=-1)
    return fftapi.irfft(X, n=n, axis=a, norm="forward", interleaved=True)


def _dht_axis(y, a: int):
    """FFTW DHT: H[k] = sum_j x[j] (cos + sin)(2*pi*j*k/n) = Re(X[k]) -
    Im(X[k]) of the DFT; the k > n/2 half follows from Hermitian symmetry
    of the rfft spectrum (H[n-k] = Re(X[k]) + Im(X[k]))."""
    n = int(y.shape[a])
    X = fftapi.rfft(y, axis=a)
    re, im = X[..., 0], X[..., 1]
    tail = torch.flip(_axslice(re + im, a, 1, (n + 1) // 2), (a,))
    return torch.cat([re - im, tail], dim=a)


_HC_FNS = {"r2hc": _r2hc_axis, "hc2r": _hc2r_axis, "dht": _dht_axis}


def _norm_axes(ndim: int, axes) -> Tuple[int, ...]:
    out = []
    for a in axes:
        a = int(a)
        a = a + ndim if a < 0 else a
        if not 0 <= a < ndim:
            raise IndexError(f"axis {a} out of range for rank {ndim}")
        out.append(a)
    if len(set(out)) != len(out):
        raise ValueError("duplicate axes are not supported by FFTW plans")
    return tuple(out)


def _is_complex(a) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.complexfloating)


class FFTW:
    """pyfftw.FFTW-compatible planned transform over the plan layer.

    The scheme is inferred from the input/output arrays exactly like
    pyfftw: complex->complex is c2c (direction FFTW_FORWARD/BACKWARD),
    real->complex is r2c (forward only), complex->real is c2r (backward
    only), real->real takes a per-axis kind sequence as ``direction``.
    """

    def __init__(self, input_array, output_array, axes=(-1,),
                 direction="FFTW_FORWARD", flags=("FFTW_MEASURE",),
                 threads: int = 1, planning_timelimit: Optional[float] = None,
                 *, normalise_idft: bool = True, ortho: bool = False,
                 device=None):
        if ortho and normalise_idft:
            raise ValueError(
                "Invalid option: normalise_idft and ortho are both True "
                "(ortho scales both directions by 1/sqrt(N) already)")
        self._input_array = np.asarray(input_array)
        self._output_array = np.asarray(output_array)
        if self._output_array is not output_array:
            raise ValueError("output_array must be a numpy array "
                             "(it is updated in place)")
        self._axes = _norm_axes(self._input_array.ndim, tuple(axes)
                                if not isinstance(axes, int) else (axes,))
        if self._input_array.ndim != self._output_array.ndim:
            raise ValueError("input and output arrays must have equal rank")
        self._normalise_idft = bool(normalise_idft)
        self._ortho = bool(ortho)
        self._device = device

        flags = (flags,) if isinstance(flags, str) else tuple(flags)
        efforts = [f for f in flags if f in _PLANNER_EFFORTS]
        unknown = [f for f in flags
                   if f not in _PLANNER_EFFORTS + _NONPLANNING_FLAGS]
        if unknown:
            raise ValueError(f"unknown FFTW flags: {unknown}")
        self._flags = flags
        self._effort = efforts[-1] if efforts else "FFTW_MEASURE"
        self._tuning = ({"rigor": "measure"}
                        if self._effort in _MEASURE_EFFORTS else {})
        self.ignored_options = tuple(
            f for f in flags if f in _NONPLANNING_FLAGS)
        if threads != 1:
            self.ignored_options += (f"threads={threads}",)
        if planning_timelimit is not None:
            self.ignored_options += (
                f"planning_timelimit={planning_timelimit}",)
        self._threads = int(threads)

        self._scheme_and_validate(direction)
        # plan eagerly like pyfftw (compiles + caches; measured efforts
        # time their candidates here, not on the first __call__)
        self.execute()

    # -------------------------------------------------- scheme setup

    def _scheme_and_validate(self, direction):
        i, o = self._input_array, self._output_array
        ax = self._axes
        if not isinstance(direction, str):
            kinds = tuple(direction)
            if len(kinds) != len(ax):
                raise ValueError("one r2r kind is required per axis")
            bad = [k for k in kinds if k not in _R2R_KINDS]
            if bad:
                raise ValueError(f"unknown r2r kinds: {bad}")
            if _is_complex(i) or _is_complex(o):
                raise ValueError("r2r kinds require real input and output")
            if i.shape != o.shape:
                raise ValueError("r2r input/output shapes must match")
            self._scheme = "r2r"
            self._kinds = kinds
            self._direction = kinds
            return
        if direction not in ("FFTW_FORWARD", "FFTW_BACKWARD"):
            raise ValueError(f"unknown direction: {direction!r}")
        self._direction = direction
        if _is_complex(i) and _is_complex(o):
            if i.shape != o.shape:
                raise ValueError("c2c input/output shapes must match")
            self._scheme = "c2c"
        elif not _is_complex(i) and _is_complex(o):
            if direction != "FFTW_FORWARD":
                raise ValueError("r2c transforms are forward-only")
            want = list(i.shape)
            want[ax[-1]] = i.shape[ax[-1]] // 2 + 1
            if list(o.shape) != want:
                raise ValueError(
                    f"r2c output shape {o.shape} does not match the "
                    f"packed spectrum shape {tuple(want)}")
            self._scheme = "r2c"
        elif _is_complex(i) and not _is_complex(o):
            if direction != "FFTW_BACKWARD":
                raise ValueError("c2r transforms are backward-only")
            want = list(o.shape)
            want[ax[-1]] = o.shape[ax[-1]] // 2 + 1
            if list(i.shape) != want:
                raise ValueError(
                    f"c2r input shape {i.shape} does not match the "
                    f"packed spectrum of output shape {o.shape}")
            self._scheme = "c2r"
        else:
            raise ValueError(
                "real input with real output requires r2r kinds as the "
                "direction argument")

    # -------------------------------------------------- properties

    @property
    def input_array(self):
        return self._input_array

    @property
    def output_array(self):
        return self._output_array

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return self._input_array.shape

    @property
    def output_shape(self) -> Tuple[int, ...]:
        return self._output_array.shape

    @property
    def input_dtype(self):
        return self._input_array.dtype

    @property
    def output_dtype(self):
        return self._output_array.dtype

    @property
    def axes(self) -> Tuple[int, ...]:
        return self._axes

    @property
    def direction(self):
        return self._direction

    @property
    def flags(self) -> Tuple[str, ...]:
        return self._flags

    @property
    def threads(self) -> int:
        return self._threads

    @property
    def simd_aligned(self) -> bool:
        return True            # alignment is irrelevant on the device path

    @property
    def N(self) -> int:
        """Product of the LOGICAL transform lengths — FFTW's
        normalization divisor (real lengths for r2c/c2r; for r2r the
        FFTW logical sizes 2(n-1) / 2(n+1) / 2n per kind)."""
        shape = (self._output_array.shape if self._scheme == "c2r"
                 else self._input_array.shape)
        total = 1
        for pos, a in enumerate(self._axes):
            n = shape[a]
            if self._scheme == "r2r":
                fam, typ = _R2R_KINDS[self._kinds[pos]]
                if fam in _HC_FNS:
                    pass                  # halfcomplex/DHT logical size = n
                elif typ == 1:
                    n = 2 * (n - 1) if fam == "dct" else 2 * (n + 1)
                else:
                    n = 2 * n
            total *= int(n)
        return total

    # -------------------------------------------------- execution

    def _compute(self, x: np.ndarray) -> np.ndarray:
        """Raw unnormalized transform (FFTW semantics) via the facade."""
        ax = self._axes
        if self._scheme == "c2c":
            if self._direction == "FFTW_FORWARD":
                y = fftapi.fftn(x, axes=ax)                 # unnormalized
            else:
                y = fftapi.ifftn(x, axes=ax, norm="forward")  # unscaled
            return np.asarray(fftapi.ascomplex(y))
        if self._scheme == "r2c":
            y = fftapi.rfftn(x.astype(np.float32, copy=False), axes=ax)
            return np.asarray(fftapi.ascomplex(y))
        if self._scheme == "c2r":
            s = tuple(self._output_array.shape[a] for a in ax)
            y = fftapi.irfftn(x, s=s, axes=ax, norm="forward")
            return fftapi._to_numpy(y)
        y = x.astype(np.float32, copy=False)
        for a, kind in zip(ax, self._kinds):
            fam, typ = _R2R_KINDS[kind]
            if fam in _HC_FNS:
                y = _HC_FNS[fam](y, a)
            else:
                fn = fftapi.dct if fam == "dct" else fftapi.dst
                y = fn(y, type=typ, axis=a, norm=None)
        return fftapi._to_numpy(y)

    def execute(self) -> None:
        """Run the RAW transform (no normalization in either direction,
        exactly like FFTW) from input_array into output_array."""
        with contextlib.ExitStack() as scope:
            if self._tuning:
                scope.enter_context(fftapi.plan_tuning(**self._tuning))
            if self._device is not None:
                scope.enter_context(fftapi.default_device(self._device))
            y = self._compute(self._input_array)
        self._output_array[...] = y.astype(self._output_array.dtype,
                                           copy=False)

    def __call__(self, input_array=None, output_array=None,
                 normalise_idft: Optional[bool] = None,
                 ortho: Optional[bool] = None):
        """Execute with pyfftw's calling conventions: optional new
        arrays, backward scaled by 1/N when ``normalise_idft`` (the
        default), both directions scaled by 1/sqrt(N) when ``ortho``."""
        normalise_idft = (self._normalise_idft if normalise_idft is None
                          else normalise_idft)
        ortho = self._ortho if ortho is None else ortho
        if ortho and normalise_idft:
            raise ValueError(
                "Invalid option: normalise_idft and ortho are both True")
        if input_array is not None or output_array is not None:
            new_in = (self._input_array if input_array is None
                      else np.asarray(input_array))
            # pyfftw's __call__ casts safe/same-kind dtypes into the
            # planned array (e.g. the real array a c2c plan was built
            # from widens to complex); only scheme-LOSING casts reject
            if (new_in.dtype != self._input_array.dtype
                    and new_in.shape == self._input_array.shape
                    and np.can_cast(new_in.dtype, self._input_array.dtype,
                                    casting="same_kind")):
                new_in = new_in.astype(self._input_array.dtype)
            self.update_arrays(
                new_in,
                self._output_array if output_array is None else output_array)
        self.execute()
        out = self._output_array
        if ortho:
            out[...] = out / np.sqrt(self.N)
        elif normalise_idft and self._scheme in ("c2c", "c2r") \
                and self._direction == "FFTW_BACKWARD":
            out[...] = out / self.N
        return out

    def update_arrays(self, new_input_array, new_output_array) -> None:
        """Swap in new arrays (shapes and dtypes must match the plan)."""
        new_input_array = np.asarray(new_input_array)
        new_output_array = np.asarray(new_output_array)
        if new_input_array.shape != self._input_array.shape:
            raise ValueError(
                f"new input shape {new_input_array.shape} does not match "
                f"the planned shape {self._input_array.shape}")
        if new_output_array.shape != self._output_array.shape:
            raise ValueError(
                f"new output shape {new_output_array.shape} does not "
                f"match the planned shape {self._output_array.shape}")
        if _is_complex(new_input_array) != _is_complex(self._input_array) \
                or _is_complex(new_output_array) != _is_complex(
                    self._output_array):
            raise ValueError("new arrays must keep the planned scheme "
                             "(real/complex kinds)")
        self._input_array = new_input_array
        self._output_array = new_output_array

    def get_input_array(self):
        return self._input_array

    def get_output_array(self):
        return self._output_array


# ------------------------------------------------------------- builders

class _FFTWWrapper(FFTW):
    """pyfftw._FFTWWrapper analog: a ``builders`` plan whose planned input
    shape differs from the user's array shape along the transform axes
    (n=/s= crop-or-pad happens on every call, like pyfftw)."""

    def __init__(self, user_shape, *args, **kwargs):
        self._user_shape = tuple(user_shape)
        super().__init__(*args, **kwargs)

    def __call__(self, input_array=None, **kwargs):
        if input_array is not None:
            input_array = np.asarray(input_array)
            if input_array.shape != self._user_shape:
                raise ValueError(
                    f"input shape {input_array.shape} does not match the "
                    f"planned array shape {self._user_shape}")
            planned = self._input_array
            staged = np.zeros_like(planned)
            sl = tuple(slice(0, min(u, p))
                       for u, p in zip(input_array.shape, planned.shape))
            staged[sl] = input_array[sl].astype(planned.dtype, copy=False)
            kwargs = dict(kwargs)
            kwargs["input_array"] = staged
        return FFTW.__call__(self, **kwargs)


def _planned(name: str, kind: str, default_axes):
    def build(a, *args, overwrite_input: bool = False,
              planner_effort: str = "FFTW_MEASURE", threads: int = 1,
              auto_align_input: bool = True, auto_contiguous: bool = True,
              avoid_copy: bool = False, device=None, **axis_kw):
        a = np.asarray(a)
        # positional/keyword n=/s= + axis=/axes= in numpy.fft order
        n = s = None
        axes = axis_kw.pop("axes", None)
        axis = axis_kw.pop("axis", None)
        if kind == "1d":
            if args:
                n = args[0]
            n = axis_kw.pop("n", n)
            if len(args) > 1:
                axis = args[1]
        else:
            if args:
                s = args[0]
            s = axis_kw.pop("s", s)
            if len(args) > 1:
                axes = args[1]
        if axis_kw:
            raise TypeError(f"unexpected keyword(s): {sorted(axis_kw)}")

        if kind == "1d":
            axes_t = (int(axis) if axis is not None else -1,)
            sizes = None if n is None else (int(n),)
        else:
            axes_t = (tuple(axes) if axes is not None
                      else (default_axes if default_axes is not None
                            else tuple(range(a.ndim))))
            if s is not None and axes is None and default_axes is None:
                axes_t = tuple(range(a.ndim - len(tuple(s)), a.ndim))
            sizes = None if s is None else tuple(int(m) for m in tuple(s))
        axes_n = _norm_axes(a.ndim, axes_t)
        if sizes is not None and len(sizes) != len(axes_n):
            raise ValueError(f"s has {len(sizes)} entries for "
                             f"{len(axes_n)} axes")

        real_fwd = name.startswith("r")       # rfft family: real -> packed
        real_bwd = name.startswith("irfft")   # irfft family: packed -> real
        if real_bwd and sizes is None:
            sizes = tuple(a.shape[ax] for ax in axes_n[:-1]) \
                + (2 * (a.shape[axes_n[-1]] - 1),)
        planned = list(a.shape)
        if sizes is not None:
            for ax, m in zip(axes_n, sizes):
                planned[ax] = int(m)
        if real_bwd:
            in_shape = list(planned)
            in_shape[axes_n[-1]] = planned[axes_n[-1]] // 2 + 1
            out_shape = planned
            in_dtype, out_dtype = np.complex64, np.float32
            direction = "FFTW_BACKWARD"
        elif real_fwd:
            in_shape = planned
            out_shape = list(planned)
            out_shape[axes_n[-1]] = planned[axes_n[-1]] // 2 + 1
            in_dtype, out_dtype = np.float32, np.complex64
            direction = "FFTW_FORWARD"
        else:
            in_shape = out_shape = planned
            in_dtype = out_dtype = np.complex64
            direction = ("FFTW_BACKWARD" if name.startswith("i")
                         else "FFTW_FORWARD")

        flags = (planner_effort,)
        non_defaults = {"overwrite_input": overwrite_input,
                        "auto_align_input": not auto_align_input,
                        "auto_contiguous": not auto_contiguous,
                        "avoid_copy": avoid_copy}
        planned_in = np.zeros(tuple(in_shape), dtype=in_dtype)
        out = np.zeros(tuple(out_shape), dtype=out_dtype)
        crop_pad = tuple(planned_in.shape) != a.shape
        if crop_pad:
            obj = _FFTWWrapper(a.shape, planned_in, out, axes=axes_n,
                               direction=direction, flags=flags,
                               threads=threads, device=device)
        else:
            obj = FFTW(planned_in, out, axes=axes_n, direction=direction,
                       flags=flags, threads=threads, device=device)
        obj.ignored_options += tuple(
            k for k, flipped in non_defaults.items() if flipped)
        # prime with the caller's data so obj() with no argument matches
        # pyfftw (which copies `a` into the internal array)
        obj(input_array=a if crop_pad else a.astype(in_dtype, copy=False))
        return obj

    build.__name__ = name
    build.__qualname__ = f"builders.{name}"
    build.__doc__ = (f"pyfftw.builders.{name}-compatible function over the "
                     f"plan layer (returns a planned FFTW object; "
                     f"n=/s= crop-or-pad on call like pyfftw).")
    return build


builders = SimpleNamespace(
    fft=_planned("fft", "1d", None),
    ifft=_planned("ifft", "1d", None),
    rfft=_planned("rfft", "1d", None),
    irfft=_planned("irfft", "1d", None),
    fft2=_planned("fft2", "nd", (-2, -1)),
    ifft2=_planned("ifft2", "nd", (-2, -1)),
    rfft2=_planned("rfft2", "nd", (-2, -1)),
    irfft2=_planned("irfft2", "nd", (-2, -1)),
    fftn=_planned("fftn", "nd", None),
    ifftn=_planned("ifftn", "nd", None),
    rfftn=_planned("rfftn", "nd", None),
    irfftn=_planned("irfftn", "nd", None),
)


# ------------------------------------------------------------ interfaces

_IFACE_INERT = ("overwrite_input", "overwrite_x", "threads",
                "auto_align_input", "auto_contiguous", "workers",
                "planning_timelimit")


def _iface(fn, default_effort: str = "FFTW_ESTIMATE",
           complex_out: bool = False):
    def g(*args, **kwargs):
        effort = kwargs.pop("planner_effort", default_effort)
        if effort not in _PLANNER_EFFORTS:
            raise ValueError(f"unknown planner_effort: {effort!r}")
        for k in _IFACE_INERT:
            kwargs.pop(k, None)
        if effort in _MEASURE_EFFORTS:
            with fftapi.plan_tuning(rigor="measure"):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        # pyfftw interfaces return host numpy arrays (complex dtype for
        # complex-valued transforms, not the facade's interleaved form)
        if complex_out:
            return np.asarray(fftapi.ascomplex(out), dtype=np.complex64)
        return fftapi._to_numpy(out)

    g.__name__ = getattr(fn, "__name__", "fft")
    g.__doc__ = (f"pyfftw.interfaces wrapper over {fn.__module__}."
                 f"{getattr(fn, '__name__', '?')} — accepts the pyfftw "
                 f"extra keywords (planner_effort maps PATIENT/EXHAUSTIVE "
                 f"to the measured planner; the rest are inert here).")
    return g


# helpers pyfftw re-exports untouched (numpy's own, in pyfftw's case)
_HELPER_NAMES = ("fftshift", "ifftshift", "fftfreq", "rfftfreq",
                 "next_fast_len")


def _iface_ns(mod, names, complex_names):
    out = {}
    for n in names:
        if not hasattr(mod, n):
            continue
        if n in _HELPER_NAMES:
            out[n] = getattr(mod, n)       # plain re-export like pyfftw
        else:
            out[n] = _iface(getattr(mod, n), complex_out=n in complex_names)
    return SimpleNamespace(**out)


_NUMPY_FFT_NAMES = (
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "fftshift", "ifftshift", "fftfreq", "rfftfreq",
)
_SCIPY_FFT_NAMES = _NUMPY_FFT_NAMES + (
    "hfft2", "ihfft2", "hfftn", "ihfftn",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "next_fast_len",
)
_FFTPACK_NAMES = (
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "rfft", "irfft",
    "dct", "idct", "dst", "idst", "fftshift", "ifftshift",
    "fftfreq", "rfftfreq", "next_fast_len",
)
# fftpack's complex-out set differs: its rfft is the PACKED-REAL form
# (real array out), and hfft/ihfft do not exist there
_FFTPACK_COMPLEX = frozenset(
    {"fft", "ifft", "fft2", "ifft2", "fftn", "ifftn"})


class _InterfacesCache:
    """pyfftw.interfaces.cache analog.  The plan layer memoizes compiled
    plans unconditionally (they are pure functions of the spec — there
    is nothing stale to expire), so enable/disable only track state and
    keepalive is recorded; nothing is ever evicted mid-session."""

    def __init__(self):
        self._enabled = True
        self.keepalive_time = None

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def is_enabled(self) -> bool:
        return self._enabled

    def set_keepalive_time(self, keepalive_time: float):
        self.keepalive_time = float(keepalive_time)


interfaces = SimpleNamespace(
    numpy_fft=_iface_ns(fftapi, _NUMPY_FFT_NAMES,
                        fftapi.COMPLEX_VALUED_FFTS),
    scipy_fft=_iface_ns(fftapi, _SCIPY_FFT_NAMES,
                        fftapi.COMPLEX_VALUED_FFTS),
    scipy_fftpack=_iface_ns(_fftpack_mod, _FFTPACK_NAMES,
                            _FFTPACK_COMPLEX),
    cache=_InterfacesCache(),
)


# --------------------------------------------------------------- wisdom

def export_wisdom() -> Tuple[bytes, bytes, bytes]:
    """FFTW-wisdom analog: the plan-cache snapshot (schema v3, incl. the
    measured planner's winners) as JSON bytes.  Returns the pyfftw-shaped
    3-tuple (double, single, long-double slots); everything lives in the
    first slot: the device computes in one precision."""
    snap = export_plan_cache_snapshot()
    return (json.dumps(snap).encode(), b"", b"")


def import_wisdom(wisdom) -> Tuple[bool, bool, bool]:
    """Load wisdom exported by :func:`export_wisdom` (specs are validated
    but not eagerly rebuilt — like FFTW, wisdom informs future planning).
    Returns per-slot success flags."""
    ok = [False, True, True]
    try:
        blob = wisdom[0]
    except (TypeError, IndexError, KeyError):
        raise ValueError("wisdom must be the tuple from export_wisdom()")
    try:
        snap = json.loads(bytes(blob).decode())
        import_plan_cache_snapshot(snap, build=False)
        ok[0] = True
    except (ValueError, TypeError):
        ok[0] = False
    return tuple(ok)


def forget_wisdom() -> None:
    """Drop the measured planner's remembered winners (future
    rigor='measure' builds re-time their candidates)."""
    default_cache().measured.clear()


# ---------------------------------------------------- aligned allocation

def empty_aligned(shape, dtype="float64", n: Optional[int] = None,
                  order: str = "C"):
    """numpy array whose data pointer is aligned to ``n`` bytes (default
    simd_alignment).  Real alignment, though the device path does not need
    it; kept so pyfftw allocation idioms work unchanged."""
    n = simd_alignment if n is None else int(n)
    dtype = np.dtype(dtype)
    size = int(np.prod(shape)) if not np.isscalar(shape) else int(shape)
    raw = np.empty(size * dtype.itemsize + n, dtype=np.uint8)
    offset = (-raw.ctypes.data) % n
    return raw[offset:offset + size * dtype.itemsize].view(dtype).reshape(
        shape, order=order)


def zeros_aligned(shape, dtype="float64", n: Optional[int] = None,
                  order: str = "C"):
    a = empty_aligned(shape, dtype, n, order)
    a[...] = 0
    return a


def ones_aligned(shape, dtype="float64", n: Optional[int] = None,
                 order: str = "C"):
    a = empty_aligned(shape, dtype, n, order)
    a[...] = 1
    return a


def byte_align(array, n: Optional[int] = None, dtype=None):
    """Copy ``array`` into an ``n``-byte-aligned buffer if it is not
    already aligned (pyfftw.byte_align semantics)."""
    array = np.asarray(array, dtype=dtype)
    n = simd_alignment if n is None else int(n)
    if is_byte_aligned(array, n):
        return array
    out = empty_aligned(array.shape, array.dtype, n)
    out[...] = array
    return out


def is_byte_aligned(array, n: Optional[int] = None) -> bool:
    n = simd_alignment if n is None else int(n)
    return np.asarray(array).ctypes.data % n == 0
