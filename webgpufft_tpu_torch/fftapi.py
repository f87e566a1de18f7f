"""numpy/scipy-style functional API over the plan layer, on torch tensors.

Port of ``webgpufft_tpu/fftapi.py``: the ``numpy.fft`` / ``scipy.fft`` /
``scipy.signal`` call surface as a thin facade over ``create_plan``.  Every
transform builds (once, memoized in the default PlanCache) a plan for the
concrete (type, shape, batch, normalize) on the input's device and runs it,
so on a CUDA tensor every transform launches the package's own CUDA kernels.

Complex representation: **interleaved float32** with a trailing component
dim (``[..., 0]`` = re, ``[..., 1]`` = im), the package-wide convention
(core/cplx.py).  Inputs may be:

- complex arrays (numpy complex64/128) or complex torch tensors: converted
  (a complex64 tensor stays a view through ``torch.view_as_real``, so
  gradients flow; complex128 is cast to complex64 first);
- interleaved float arrays whose last dim is 2: used as-is (pass
  ``interleaved=False`` to force a real array with trailing length-2 axis
  to be treated as real data instead);
- real float arrays: widened with a zero imaginary part.

Outputs of complex-valued transforms are interleaved float32 tensors; use
``ascomplex(y)`` for a numpy complex128 array.  Host helpers (``fftfreq``,
``next_fast_len``, ``get_window``, ``correlation_lags``, ``czt_points``,
``check_COLA`` ...) return numpy, as in the JAX package.

Device rule.  A ``torch.Tensor`` input runs on the device it lives on (a
CPU tensor is the caller asking for the CPU).  Anything else (numpy, lists,
scalars) is placed on the facade's default device: ``"cuda"``, which raises
without a GPU, unless a ``default_device(...)`` block names another.  Two
tensor inputs on different devices raise ``PlanError``; a non-tensor second
input follows the tensor.  Nothing probes ``torch.cuda.is_available()`` to
choose a device silently.

float32 is explicit.  torch keeps float64 where JAX (without x64) turns it
into float32 by itself, so every user array enters through one helper
(``_f32``) that casts to float32; host tables enter through ``_const``.

Padding and framing.  ``_pad_axis`` gathers through an index vector that
``numpy.pad`` computes on the host, so every numpy mode the facade names
(``edge``, ``reflect``, ``symmetric``, ``wrap``, odd reflection) agrees with
numpy at any pad width.  Frames are ``Tensor.unfold`` views; the window
multiply that follows makes the one copy.

No facade function marks its input as requiring grad or enters a
``torch.func`` transform of its own, and no library FFT is called.

Normalization follows numpy: ``norm`` in {None/"backward", "ortho",
"forward"} with the scale on the inverse / split / forward respectively.
DCT/DST ``norm`` matches ``scipy.fft`` conventions.
"""

from __future__ import annotations

import contextlib as _contextlib
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as _F

from .core.cplx import conj as _conj
from .core.cplx import interleave as _np_interleave
from .core.cplx import uninterleave as _np_uninterleave
from .spec import PlanError
from .utils import factors

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "prev_fast_len", "set_workers", "get_workers",
    "set_backend", "skip_backend", "set_global_backend",
    "register_backend",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "fftconvolve", "oaconvolve", "convolve", "correlate",
    "convolve2d", "correlate2d",
    "correlation_lags", "deconvolve",
    "stft", "istft", "spectrogram", "welch", "periodogram",
    "csd", "coherence", "lombscargle",
    "resample", "resample_poly", "upfirdn",
    "decimate", "hilbert", "hilbert2",
    "czt", "zoom_fft", "czt_points", "vectorstrength", "envelope",
    "ShortTimeFFT", "closest_STFT_dual_window", "CZT", "ZoomFFT",
    "check_COLA", "check_NOLA", "choose_conv_method",
    "fht", "ifht", "fhtoffset",
    "detrend", "get_window",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift", "next_fast_len",
    "ascomplex", "asinterleaved", "plan_tuning", "default_device",
]


# ---------------------------------------------------------------- devices

# process-global stack of default devices (see default_device); empty means
# "cuda"
_DEVICE_STACK: list = []


@_contextlib.contextmanager
def default_device(device):
    """Context manager: place non-tensor inputs (numpy, lists, scalars) of
    every facade call inside the block on ``device``::

        with wfft.default_device("cpu"):
            Y = wfft.fft(z_numpy)         # runs the plain versions on the CPU

    Process-global (not thread-scoped) and nestable, like ``plan_tuning``.
    Tensor inputs are never moved: they run where they live."""
    _DEVICE_STACK.append(torch.device(device))
    try:
        yield
    finally:
        _DEVICE_STACK.pop()


def _default_device() -> torch.device:
    from . import _resolve_device
    return _resolve_device(_DEVICE_STACK[-1] if _DEVICE_STACK else "cuda")


def _device_of(*xs) -> torch.device:
    """The device a call runs on: the tensors' own (all equal, else
    PlanError), or the facade default when no input is a tensor."""
    devs = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise PlanError(
            f"inputs live on different devices: {sorted(map(str, devs))}")
    return devs.pop() if devs else _default_device()


def _is_complex(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_complex()
    return np.iscomplexobj(x)


def _is_integer(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex()
                    or x.dtype == torch.bool)
    return np.issubdtype(np.asarray(x).dtype, np.integer)


def _f32(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """THE cast of user data: a real float32 tensor.  Tensors keep their
    device (``device``, when given, must match); everything else is cast on
    the host and placed on ``device`` or the facade default."""
    if isinstance(x, torch.Tensor):
        if device is not None and x.device != device:
            raise PlanError(f"input is on {x.device}, expected {device}")
        if x.is_complex():
            raise PlanError("expected a real array, got complex input")
        return x if x.dtype == torch.float32 else x.to(torch.float32)
    a = np.asarray(x)
    if np.iscomplexobj(a):
        raise PlanError("expected a real array, got complex input")
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                           device=device if device is not None
                           else _default_device())


def _const(table, like: torch.Tensor) -> torch.Tensor:
    """A host table as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(np.ascontiguousarray(table, dtype=np.float32),
                           device=like.device)


def _to_numpy(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


# ---------------------------------------------------------------- helpers

def asinterleaved(x, interleaved: Optional[bool] = None, *,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Coerce ``x`` to an interleaved complex tensor (..., 2) float32.
    A complex64 tensor becomes a view (``torch.view_as_real``).  ``device``
    places a non-tensor input (default: the facade's default device)."""
    if isinstance(x, torch.Tensor) and x.is_complex():
        if device is not None and x.device != device:
            raise PlanError(f"input is on {x.device}, expected {device}")
        if x.dtype != torch.complex64:
            x = x.to(torch.complex64)
        return torch.view_as_real(x.resolve_conj())
    if not isinstance(x, torch.Tensor) and np.iscomplexobj(x):
        return _f32(_np_interleave(np.asarray(x)), device)
    x = _f32(x, device)
    if interleaved is None:
        interleaved = x.ndim >= 2 and x.shape[-1] == 2
    if interleaved:
        if x.ndim < 1 or x.shape[-1] != 2:
            raise PlanError(
                f"interleaved array must have a trailing component dim of "
                f"2, got shape {tuple(x.shape)}")
        return x
    return torch.stack([x, torch.zeros_like(x)], dim=-1)


def ascomplex(y) -> np.ndarray:
    """Interleaved tensor (or array) -> numpy complex128."""
    return _np_uninterleave(_to_numpy(y))


# facade transforms whose mathematical result is complex-valued (returned
# interleaved (..., 2) f32 here); the scipy/torch bridges repack these as
# complex dtypes: one shared table so the two cannot drift
COMPLEX_VALUED_FFTS = frozenset({
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "rfft2", "rfftn", "ihfft", "ihfft2", "ihfftn",
})


def _norm_modes(norm: Optional[str], inverse: bool) -> Tuple[str, float]:
    """numpy norm -> (plan normalize mode, extra post-scale factor-exponent).

    Returns the plan's normalize mode plus the exponent e such that the
    output must additionally be scaled by N**e (0 = no extra pass).
    """
    if norm is None or norm == "backward":
        return ("backward" if inverse else "none"), 0
    if norm == "ortho":
        return "unitary", 0
    if norm == "forward":
        # numpy: 1/N on the FORWARD transform, inverse unscaled
        return ("none", -1) if not inverse else ("none", 0)
    raise PlanError(f"norm must be None|'backward'|'ortho'|'forward', "
                    f"got {norm!r}")


def _is_int(v) -> bool:
    """True for python and numpy integer scalars (numpy accepts both
    for n=/s=/axes= everywhere)."""
    return isinstance(v, (int, np.integer))


def _axes_list(x_cplx_ndim: int, axes, default_all: bool,
               s=None, allow_duplicates: bool = False) -> Tuple[int, ...]:
    """Normalize an axes argument against the COMPLEX rank (component dim
    excluded).  numpy semantics for the s-without-axes form: ``s`` given
    with ``axes=None`` applies to the LAST len(s) axes."""
    if axes is None:
        if s is not None:
            if len(tuple(s)) > x_cplx_ndim:
                # must raise HERE: with allow_duplicates the wrapped-
                # around negative range below would alias real axes
                raise PlanError(f"s has {len(tuple(s))} entries for "
                                f"rank {x_cplx_ndim}")
            axes = tuple(range(x_cplx_ndim - len(tuple(s)), x_cplx_ndim))
        else:
            axes = tuple(range(x_cplx_ndim)) if default_all else (-1,)
    elif _is_int(axes):
        axes = (axes,)
    out = []
    for a in axes:
        a = a + x_cplx_ndim if a < 0 else a
        if not 0 <= a < x_cplx_ndim:
            raise PlanError(f"axis {a} out of range for rank {x_cplx_ndim}")
        out.append(int(a))
    if not allow_duplicates and len(set(out)) != len(out):
        raise PlanError(f"duplicate axes in {tuple(axes)}")
    return tuple(out)


def _resolve_s(x, sizes, axes):
    """numpy s= semantics: an entry of -1 keeps the current axis length
    (scalar n= does NOT accept -1: numpy raises there, and so do we via
    _crop_or_pad's validation).  Checks the length BEFORE zipping so a
    too-long s raises like numpy instead of being silently truncated."""
    sizes = tuple(sizes)
    if len(sizes) != len(axes):
        raise PlanError(f"s has {len(sizes)} entries for {len(axes)} axes")
    return tuple(x.shape[a] if m == -1 else m for m, a in zip(sizes, axes))


def _slice(x: torch.Tensor, start: int, stop: int, axis: int) -> torch.Tensor:
    """x[start:stop] along ``axis`` (a view)."""
    return x.narrow(axis, int(start), int(stop) - int(start))


def _zero_pad(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad ``axis`` by (lo, hi)."""
    if lo == 0 and hi == 0:
        return x
    ax = axis % x.ndim
    return _F.pad(x, [0, 0] * (x.ndim - 1 - ax) + [int(lo), int(hi)])


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int,
              mode: str = "constant", reflect_type: str = "even"):
    """``numpy.pad`` of one axis by (lo, hi) for the modes the facade names:
    ``constant`` (zeros), ``edge``, ``reflect``, ``symmetric``, ``wrap`` and
    ``reflect`` with ``reflect_type="odd"``.

    The source index of every output sample is what ``numpy.pad`` makes of
    ``arange(n)`` on the host, so pads wider than the signal repeat exactly
    as numpy's do; the data moves in one ``index_select``.  Odd reflection
    is not a pure gather (it is ``2 * edge - reflected``): it grows the
    signal in numpy's own chunks of at most n - 1 samples per side."""
    lo, hi = int(lo), int(hi)
    if lo == 0 and hi == 0:
        return x
    ax = axis % x.ndim
    n = x.shape[ax]
    if mode == "constant":
        return _zero_pad(x, ax, lo, hi)
    if mode not in ("edge", "reflect", "symmetric", "wrap"):
        raise PlanError(f"unsupported pad mode {mode!r}")
    if mode == "reflect" and reflect_type == "odd" and n > 1:
        while lo > 0 or hi > 0:
            n = x.shape[ax]
            l, h = min(lo, n - 1), min(hi, n - 1)
            parts = []
            if l:
                parts.append(2.0 * x.narrow(ax, 0, 1)
                             - torch.flip(x.narrow(ax, 1, l), (ax,)))
            parts.append(x)
            if h:
                parts.append(2.0 * x.narrow(ax, n - 1, 1)
                             - torch.flip(x.narrow(ax, n - 1 - h, h), (ax,)))
            x = torch.cat(parts, dim=ax)
            lo, hi = lo - l, hi - h
        return x
    idx = np.pad(np.arange(n), (lo, hi), mode=mode)
    return x.index_select(ax, torch.as_tensor(idx, device=x.device))


def _crop_or_pad(x, n: int, axis: int):
    """numpy n=/s= semantics: crop or zero-pad ``axis`` to length n."""
    n = int(n)
    if n < 1:
        raise PlanError(f"invalid number of FFT data points ({n})")
    cur = x.shape[axis]
    if n == cur:
        return x
    if n < cur:
        return _slice(x, 0, n, axis)
    return _zero_pad(x, axis, 0, n - cur)


# process-global tuning applied to every plan the facade builds (see
# plan_tuning); empty by default so facade plans keep their default specs
_DEFAULT_TUNING: dict = {}


@_contextlib.contextmanager
def plan_tuning(**tuning):
    """Context manager: apply plan tuning knobs to every transform the
    facade (and therefore the scipy/torch/fftpack bridges) builds inside
    the block, e.g. measured route selection::

        with wfft.plan_tuning(rigor="measure"):
            Y = wfft.fftn(x)          # candidates timed on first build

    Knobs are the create_plan tuning surface: rigor, maxSubLength,
    largeRoute, impl, matmulPrecision, ...  Process-global (not
    thread-scoped); plans built inside the block cache under their tuned
    spec, so repeated calls reuse them.  Nests: an inner block layers its
    knobs over the outer block's and restores them on exit.
    """
    saved = dict(_DEFAULT_TUNING)
    _DEFAULT_TUNING.update(tuning)
    try:
        yield
    finally:
        _DEFAULT_TUNING.clear()
        _DEFAULT_TUNING.update(saved)


def _plan_tuning_kw() -> dict:
    return {"tuning": dict(_DEFAULT_TUNING)} if _DEFAULT_TUNING else {}


def _exec_nd(x, plan_type: str, shape: Sequence[int], direction: str,
             normalize: str, interleaved_in: bool):
    """Collapse leading dims to batch, run the plan on x's device, restore
    leading dims.  ``create_plan`` is a cache lookup after the first call
    for a (spec, device)."""
    from . import create_plan
    comp_in = 1 if interleaved_in else 0
    lead = tuple(x.shape[: x.ndim - len(shape) - comp_in])
    batch = math.prod(lead)
    xin = x.reshape(batch, *x.shape[len(lead):])
    plan = create_plan(type=plan_type, shape=[int(m) for m in shape],
                       batch=batch, direction=direction, normalize=normalize,
                       device=x.device, **_plan_tuning_kw())
    y = plan(xin)
    return y.reshape(*lead, *y.shape[1:])


def _move_to_trailing(x, axes: Tuple[int, ...], comp: bool):
    """Move the given complex axes (in order) to the trailing positions
    just before the component dim (if comp)."""
    nd = x.ndim - (1 if comp else 0)
    dest = tuple(range(nd - len(axes), nd))
    if tuple(axes) == dest:
        return x, None
    x = torch.movedim(x, tuple(axes), dest)
    return x, (dest, tuple(axes))


def _restore_axes(y, undo, comp: bool):
    if undo is None:
        return y
    dest, axes = undo
    return torch.movedim(y, dest, axes)


# ---------------------------------------------------------------- c2c

def _c2c(x, n, axes, norm, inverse: bool, default_all_axes: bool,
         interleaved):
    x = asinterleaved(x, interleaved)
    nd = x.ndim - 1
    if default_all_axes and _is_int(n):
        # numpy: fftn/fft2 require a sequence s (TypeError there)
        raise PlanError("s must be a sequence of integers, not a bare int")
    s = None if (n is None or _is_int(n)) else tuple(n)
    if (axes is not None and not _is_int(axes)
            and len(set(a + nd if a < 0 else a for a in axes)) != len(tuple(axes))):
        # numpy permits repeated axes in fftn/ifftn: the transform runs
        # once per occurrence (normalization per pass), applied in
        # numpy's _raw_fftnd order (REVERSED over the axes list) with
        # s entries (-1 included) resolved against the ORIGINAL shape
        # before any pass runs (only observable with duplicates + s)
        ax = tuple(a + nd if a < 0 else a for a in axes)
        for a in ax:
            if not 0 <= a < nd:
                raise PlanError(f"axis {a} out of range for rank {nd}")
        sizes = (None,) * len(ax) if s is None else _resolve_s(x, s, ax)
        for a, m in zip(reversed(ax), reversed(sizes)):
            x = _c2c(x, m, (a,), norm, inverse, False, True)
        return x
    axes = _axes_list(nd, axes, default_all_axes, s=s)
    if n is not None:
        sizes = (n,) if _is_int(n) else _resolve_s(x, tuple(n), axes)
        for a, m in zip(axes, sizes):
            x = _crop_or_pad(x, m, a)
    normalize, scale_exp = _norm_modes(norm, inverse)
    x, undo = _move_to_trailing(x, axes, comp=True)
    shape = tuple(x.shape[x.ndim - 1 - len(axes): x.ndim - 1])
    y = _exec_nd(x, "c2c", shape, "inverse" if inverse else "forward",
                 normalize, True)
    if scale_exp:
        y = y * float(math.prod(shape)) ** scale_exp
    return _restore_axes(y, undo, comp=True)


def fft(x, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None, *, interleaved: Optional[bool] = None):
    """1-D complex FFT along ``axis`` (numpy.fft.fft semantics)."""
    return _c2c(x, n, (axis,), norm, False, False, interleaved)


def ifft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, *, interleaved: Optional[bool] = None):
    return _c2c(x, n, (axis,), norm, True, False, interleaved)


def fft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None, *,
         interleaved: Optional[bool] = None):
    return _c2c(x, s, axes, norm, False, True, interleaved)


def ifft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None, *,
          interleaved: Optional[bool] = None):
    return _c2c(x, s, axes, norm, True, True, interleaved)


def fftn(x, s=None, axes=None, norm: Optional[str] = None, *,
         interleaved: Optional[bool] = None):
    return _c2c(x, s, axes, norm, False, True, interleaved)


def ifftn(x, s=None, axes=None, norm: Optional[str] = None, *,
          interleaved: Optional[bool] = None):
    return _c2c(x, s, axes, norm, True, True, interleaved)


# ---------------------------------------------------------------- r2c/c2r

def rfft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None):
    """Real FFT along ``axis``: real input -> packed half-spectrum
    (..., n//2+1, 2) interleaved (numpy.fft.rfft semantics)."""
    x = _f32(x)
    axes = _axes_list(x.ndim, (axis,), False)
    if n is not None:
        x = _crop_or_pad(x, n, axes[0])
    normalize, scale_exp = _norm_modes(norm, False)
    x, undo = _move_to_trailing(x, axes, comp=False)
    m = x.shape[-1]
    y = _exec_nd(x, "r2c", (m,), "forward", normalize, False)
    if scale_exp:
        y = y * float(m) ** scale_exp
    return _restore_axes(y, undo, comp=True)


def irfft(x, n: Optional[int] = None, axis: int = -1,
          norm: Optional[str] = None, *, interleaved: Optional[bool] = None):
    """Inverse real FFT: packed half-spectrum (..., m, 2) -> real (..., n)
    with n defaulting to 2*(m-1) (numpy.fft.irfft semantics)."""
    x = asinterleaved(x, interleaved)
    nd = x.ndim - 1
    axes = _axes_list(nd, (axis,), False)
    if n is None:
        n = 2 * (x.shape[axes[0]] - 1)
    n = int(n)
    packed = n // 2 + 1
    x = _crop_or_pad(x, packed, axes[0])
    # every inverse norm mode maps to a plan normalize with no extra pass
    # (_norm_modes returns exponent 0 for inverse transforms)
    normalize, _ = _norm_modes(norm, True)
    x, undo = _move_to_trailing(x, axes, comp=True)
    y = _exec_nd(x, "c2r", (n,), "inverse", normalize, True)
    return _restore_axes(y, undo, comp=False)


def _split_last(axes):
    """(other_axes, last_axis) for the rfftn composition order."""
    return tuple(axes[:-1]), axes[-1]


def rfftn(x, s=None, axes=None, norm: Optional[str] = None):
    """ND real FFT: rfft along the last given axis, then complex FFTs over
    the remaining axes of the packed spectrum (numpy.fft.rfftn semantics:
    the LAST axis in ``axes`` is the packed one)."""
    x = _f32(x)
    if _is_int(s):
        raise PlanError("s must be a sequence of integers, not a bare int")
    axes = _axes_list(x.ndim, axes, True, s=s, allow_duplicates=True)
    if len(set(axes)) != len(axes):
        # numpy permits repeated axes here too: s defaults to the
        # ORIGINAL axis lengths (so later passes explicitly resize:
        # rfftn(x, axes=(1,1)) re-pads the packed axis back to
        # x.shape[1]), rfft runs on the LAST entry, then plain ffts
        # over the rest in FORWARD order (numpy applies them 0..n-2)
        sizes = (tuple(x.shape[a] for a in axes) if s is None
                 else _resolve_s(x, tuple(s), axes))
        y = rfft(x, n=int(sizes[-1]), axis=axes[-1], norm=norm)
        for a, m in zip(axes[:-1], sizes[:-1]):
            y = _c2c(y, int(m), (a,), norm, False, False, True)
        return y
    if s is not None:
        s = _resolve_s(x, tuple(s), axes)
        for a, m in zip(axes, s):
            x = _crop_or_pad(x, m, a)
    others, last = _split_last(axes)
    y = rfft(x, axis=last, norm=norm)
    if others:
        y = _c2c(y, None, others, norm, False, True, True)
    return y


def irfftn(x, s=None, axes=None, norm: Optional[str] = None, *,
           interleaved: Optional[bool] = None):
    """ND inverse real FFT (numpy.fft.irfftn semantics)."""
    x = asinterleaved(x, interleaved)
    nd = x.ndim - 1
    if _is_int(s):
        raise PlanError("s must be a sequence of integers, not a bare int")
    axes = _axes_list(nd, axes, True, s=s, allow_duplicates=True)
    if len(set(axes)) != len(axes):
        # numpy permits repeated axes: ifft per leading occurrence in
        # FORWARD order with explicit resizes (s defaults to the current
        # axis lengths), then irfft on the LAST entry (default output
        # length 2*(n_last - 1); an explicit -1 keeps the ORIGINAL axis
        # length instead, like every other -1 entry)
        if s is None:
            sizes = tuple(x.shape[a] for a in axes[:-1]) + (None,)
        else:
            sizes = _resolve_s(x, tuple(s), axes)
        y = x
        for a, m in zip(axes[:-1], sizes[:-1]):
            y = _c2c(y, int(m), (a,), norm, True, False, True)
        n_last = None if sizes[-1] is None else int(sizes[-1])
        return irfft(y, n=n_last, axis=axes[-1], norm=norm,
                     interleaved=True)
    others, last = _split_last(axes)
    n_last = None
    if s is not None:
        s = _resolve_s(x, tuple(s), axes)   # -1 keeps the axis length,
        for a, m in zip(others, s[:-1]):    # incl. the packed last axis
            x = _crop_or_pad(x, m, a)
        n_last = s[-1]
    if others:
        x = _c2c(x, None, others, norm, True, True, True)
    return irfft(x, n=n_last, axis=last, norm=norm, interleaved=True)


def _hermitian_scale(norm: Optional[str], n: int, inverse: bool) -> float:
    """hfft/ihfft norm factor (numpy folds the 1/n onto ihfft for the
    default 'backward' mode; 'forward' swaps it, 'ortho' splits it)."""
    if norm is None or norm == "backward":
        return 1.0 / n if inverse else 1.0
    if norm == "ortho":
        return 1.0 / math.sqrt(n)
    if norm == "forward":
        return 1.0 if inverse else 1.0 / n
    raise PlanError(f"norm must be None|'backward'|'ortho'|'forward', "
                    f"got {norm!r}")


def hfft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, *, interleaved: Optional[bool] = None):
    """FFT of a Hermitian-symmetric (real-spectrum) signal -> real output
    (numpy.fft.hfft semantics: hfft(a, n) == irfft(conj(a), n) * n with
    the norm scale on the forward side)."""
    x = _conj(asinterleaved(x, interleaved))
    nd = x.ndim - 1
    axes = _axes_list(nd, (axis,), False)
    if n is None:
        n = 2 * (x.shape[axes[0]] - 1)
    # hfft is a FORWARD transform in numpy's norm accounting
    y = irfft(x, n=n, axis=axis, norm="forward",
              interleaved=True)                    # unscaled inverse core
    scale = _hermitian_scale(norm, n, inverse=False)
    return y if scale == 1.0 else y * scale


def ihfft(x, n: Optional[int] = None, axis: int = -1,
          norm: Optional[str] = None):
    """Inverse of hfft: real input -> packed Hermitian half-spectrum
    (numpy.fft.ihfft semantics: conj(rfft(a, n)) / n for the default
    norm)."""
    x = _f32(x)
    axes = _axes_list(x.ndim, (axis,), False)
    m = n if n is not None else x.shape[axes[0]]
    y = _conj(rfft(x, n=n, axis=axis, norm=None))
    scale = _hermitian_scale(norm, m, inverse=True)
    return y if scale == 1.0 else y * scale


def rfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None):
    return rfftn(x, s, axes, norm)


def irfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None, *,
           interleaved: Optional[bool] = None):
    return irfftn(x, s, axes, norm, interleaved=interleaved)


# ---------------------------------------------------------------- dct/dst

def _trig_ortho_weights(kind: str, eff_type: int, m: int):
    """(pre, post) per-bin sqrt(2) reweightings of scipy's ``orthogonalize``
    flag, keyed by the EFFECTIVE transform being executed (the inverse of a
    type-2 is type-3-based, and inverting a post-weight is the swapped
    type's pre-weight, so one table serves both directions).  Either entry
    may be None (identity).  Types 4 and dst1 have no special bins.
    """
    r2 = math.sqrt(2.0)
    pre = post = None
    if kind == "dct":
        if eff_type == 1:
            pre = np.ones(m, np.float32)
            pre[0] = pre[-1] = r2
            post = np.ones(m, np.float32)
            post[0] = post[-1] = 1.0 / r2
        elif eff_type == 2:
            post = np.ones(m, np.float32)
            post[0] = 1.0 / r2
        elif eff_type == 3:
            pre = np.ones(m, np.float32)
            pre[0] = r2
    else:
        if eff_type == 2:
            post = np.ones(m, np.float32)
            post[-1] = 1.0 / r2
        elif eff_type == 3:
            pre = np.ones(m, np.float32)
            pre[-1] = r2
    return pre, post


def _scipy_trig(x, kind: str, type: int, n, axis: int,
                norm: Optional[str], inverse: bool,
                orthogonalize: Optional[bool] = None):
    """scipy.fft.dct/dst/idct/idst semantics over the plan layer.

    scipy's inverse is the type-swapped transform (2<->3; 1 and 4 are
    self-inverse) with the normalization folded in; all modes lower to the
    plan layer's 'none' forward transform plus explicit diagonal scalings.
    Normalization is a single scalar derived from the unnormalized
    roundtrip gain G (dct1: 2(m-1), dst1: 2(m+1), else 2m):
    forward 1 | 1/G | 1/sqrt(G) and inverse 1/G | 1 | 1/sqrt(G) for
    norm backward | forward | ortho; ``orthogonalize`` (default: only
    under ortho) additionally applies the per-bin sqrt(2) reweights.
    """
    if type not in (1, 2, 3, 4):
        raise PlanError(f"{kind} type must be 1..4, got {type}")
    if norm not in (None, "backward", "ortho", "forward"):
        raise PlanError(
            f"{kind} norm must be None|'backward'|'ortho'|'forward', "
            f"got {norm!r}")
    ortho_w = (norm == "ortho") if orthogonalize is None else bool(orthogonalize)
    x = _f32(x)
    axes = _axes_list(x.ndim, (axis,), False)
    if n is not None:
        x = _crop_or_pad(x, n, axes[0])
    m = x.shape[axes[0]]
    inv_type = {1: 1, 2: 3, 3: 2, 4: 4}[type]
    eff_type = inv_type if inverse else type
    if kind == "dct" and type == 1:
        gain, half = 2.0 * (m - 1), 1.0   # plan 'none' dct1 matches scipy
    elif kind == "dst" and type == 1:
        gain, half = 2.0 * (m + 1), 2.0   # plan 'none' is scipy / 2
    else:
        gain, half = 2.0 * m, 2.0
    if norm == "ortho":
        scale = half / math.sqrt(gain)
    elif (norm == "forward") != inverse:   # forward-norm fwd, backward inv
        scale = half / gain
    else:
        scale = half
    pre = post = None
    if ortho_w:
        pre, post = _trig_ortho_weights(kind, eff_type, m)
    x, undo = _move_to_trailing(x, axes, comp=False)
    if pre is not None:
        x = x * _const(pre, x)
    y = _exec_nd(x, f"{kind}{eff_type}", (m,), "forward", "none",
                 False)
    if post is not None:
        y = y * _const(post, y)
    if scale != 1.0:
        y = y * scale
    return _restore_axes(y, undo, comp=False)


def dct(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None, *, orthogonalize: Optional[bool] = None):
    """DCT along ``axis`` (scipy.fft.dct semantics)."""
    return _scipy_trig(x, "dct", type, n, axis, norm, False, orthogonalize)


def idct(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, *, orthogonalize: Optional[bool] = None):
    return _scipy_trig(x, "dct", type, n, axis, norm, True, orthogonalize)


def dst(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None, *, orthogonalize: Optional[bool] = None):
    """DST along ``axis`` (scipy.fft.dst semantics)."""
    return _scipy_trig(x, "dst", type, n, axis, norm, False, orthogonalize)


def idst(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, *, orthogonalize: Optional[bool] = None):
    return _scipy_trig(x, "dst", type, n, axis, norm, True, orthogonalize)


def _trig_nd(x, kind: str, type: int, s, axes, norm, inverse: bool,
             orthogonalize: Optional[bool] = None):
    """scipy.fft.dctn-family semantics: the separable 1-D transform applied
    along each requested axis in turn."""
    x = _f32(x)
    axes = _axes_list(x.ndim, axes, True, s=s)
    sizes = (None,) * len(axes) if s is None else tuple(s)
    if len(sizes) != len(axes):
        raise PlanError(f"s has {len(sizes)} entries for {len(axes)} axes")
    for a, m in zip(axes, sizes):
        x = _scipy_trig(x, kind, type, m, a, norm, inverse, orthogonalize)
    return x


def dctn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None, *,
         orthogonalize: Optional[bool] = None):
    """ND DCT (scipy.fft.dctn semantics)."""
    return _trig_nd(x, "dct", type, s, axes, norm, False, orthogonalize)


def idctn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None, *,
          orthogonalize: Optional[bool] = None):
    return _trig_nd(x, "dct", type, s, axes, norm, True, orthogonalize)


def dstn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None, *,
         orthogonalize: Optional[bool] = None):
    """ND DST (scipy.fft.dstn semantics)."""
    return _trig_nd(x, "dst", type, s, axes, norm, False, orthogonalize)


def idstn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None, *,
          orthogonalize: Optional[bool] = None):
    return _trig_nd(x, "dst", type, s, axes, norm, True, orthogonalize)


# ---------------------------------------------------------------- conv

def fftconvolve(in1, in2, mode: str = "full", axes=None, *,
                interleaved: Optional[bool] = None):
    """FFT convolution of two arrays (scipy.signal.fftconvolve semantics).

    Convolves over ``axes`` (default: all); the non-convolved axes must
    match and ride as batch.  Real inputs give a real output; complex
    (or interleaved) inputs give an interleaved output.
    """
    if mode not in ("full", "same", "valid"):
        raise PlanError(f"mode must be full|same|valid, got {mode!r}")
    complex_in = (_is_complex(in1) or _is_complex(in2)
                  or (interleaved is True))
    dev = _device_of(in1, in2)
    # floats whose trailing dim is 2 are ambiguous here; real data is the
    # overwhelmingly common fftconvolve case, so floats are REAL unless
    # the caller passes interleaved=True
    x = asinterleaved(in1, interleaved if complex_in else False, device=dev)
    k = asinterleaved(in2, interleaved if complex_in else False, device=dev)
    nd = x.ndim - 1
    if k.ndim != x.ndim:
        raise PlanError(
            f"fftconvolve inputs must have equal rank, got {nd} and {k.ndim - 1}")
    axes = _axes_list(nd, axes, True)
    for a in range(nd):
        if (a not in axes and x.shape[a] != k.shape[a]
                and k.shape[a] != 1 and x.shape[a] != 1):
            raise PlanError(
                f"non-convolved axis {a} sizes differ: {x.shape[a]} vs "
                f"{k.shape[a]} (a size-1 axis on either input broadcasts, "
                "scipy-style; use the plan API's multi-kernel channel "
                "policy otherwise)")
    boundary = {"full": "linear-full", "same": "linear-same",
                "valid": "linear-valid"}[mode]
    # arrange: batch = non-axes dims of x; kernel batch dims must be 1-like
    x, undo_x = _move_to_trailing(x, axes, comp=True)
    k, _ = _move_to_trailing(k, axes, comp=True)
    shape = tuple(x.shape[x.ndim - 1 - len(axes): x.ndim - 1])
    kshape = tuple(k.shape[k.ndim - 1 - len(axes): k.ndim - 1])
    if mode == "valid":
        # scipy requires one input to be at least as large everywhere
        if not (all(a >= b for a, b in zip(shape, kshape))
                or all(b >= a for a, b in zip(shape, kshape))):
            raise PlanError(
                "valid mode requires one input to be at least as large as "
                "the other in every convolved dimension")
        if any(b > a for a, b in zip(shape, kshape)):
            x, k = k, x
            shape, kshape = kshape, shape
    from . import create_plan
    klead = tuple(k.shape[: k.ndim - 1 - len(axes)])
    lead = tuple(x.shape[: x.ndim - 1 - len(axes)])
    if any(d != 1 for d in klead):
        # the kernel slot varies along non-convolved axes (e.g. a batched
        # in1 swapped into it by valid mode): when the data slot is
        # singleton there, run one multi-kernel plan (convolution
        # commutes), matching scipy's broadcast semantics
        if any(d != 1 for d in lead):
            raise PlanError(
                "fftconvolve inputs may not BOTH vary along a non-"
                f"convolved axis (leading shapes {lead} and {klead}); use "
                "the plan API's multi-kernel channel policy for that")
        kc = math.prod(klead)
        plan = create_plan(type="fftconv", shape=list(shape), batch=1,
                           fftConv={"boundary": boundary,
                                    "kernelShape": list(kshape),
                                    "kernelCount": kc},
                           device=dev, **_plan_tuning_kw())
        y = plan.exec(x.reshape(1, *shape, 2),
                      kernel=k.reshape(kc, *kshape, 2))
        y = y.reshape(*klead, *y.shape[2:])   # kernel-major -> lead dims
        if mode == "same":
            # scipy's 'same' center-crops to in1's FULL shape, non-
            # convolved axes included; in1 is singleton there in this
            # branch, so keep the centered kernel lane only
            idx = tuple(slice((d - 1) // 2, (d - 1) // 2 + 1)
                        for d in klead)
            y = y[idx + (Ellipsis,)]
    else:
        batch = math.prod(lead)
        plan = create_plan(type="fftconv", shape=list(shape), batch=batch,
                           fftConv={"boundary": boundary,
                                    "kernelShape": list(kshape)},
                           device=dev, **_plan_tuning_kw())
        y = plan.exec(x.reshape(batch, *shape, 2),
                      kernel=k.reshape(*kshape, 2))
        y = y.reshape(*lead, *y.shape[1:])
    y = _restore_axes(y, undo_x, comp=True)
    if not complex_in:
        return y[..., 0]
    return y


def oaconvolve(in1, in2, mode: str = "full", axes=None, *,
               interleaved: Optional[bool] = None):
    """Block-streamed convolution for long-signal/short-kernel workloads
    (scipy.signal.oaconvolve's role).  Same semantics as
    :func:`fftconvolve`; the plan layer selects its overlap-save block
    route by itself for a 1-D convolved axis with a short kernel and a long
    signal (``plans/fftconv.py``), so this is an alias kept for scipy API
    familiarity.  ND convolved axes run the standard spectrum pipeline."""
    return fftconvolve(in1, in2, mode, axes, interleaved=interleaved)


def convolve(in1, in2, mode: str = "full", method: str = "auto", *,
             interleaved: Optional[bool] = None):
    """ND convolution (scipy.signal.convolve semantics over all axes).

    ``method`` accepts scipy's vocabulary; 'direct' and 'auto' both run
    the FFT route: the package has no separate direct kernel to pick
    (values match scipy's to float32 precision either way).  Integer
    inputs round to the nearest integer like scipy's fft method."""
    if method not in ("auto", "fft", "direct"):
        raise PlanError(f"method must be auto|fft|direct, got {method!r}")
    int_in = _is_integer(in1) and _is_integer(in2)
    y = fftconvolve(in1, in2, mode, interleaved=interleaved)
    return torch.round(y) if int_in else y


def _reverse_conj(x, interleaved, device=None):
    """Time-reverse over every data axis and conjugate (the correlate ->
    convolve kernel map)."""
    k = asinterleaved(x, interleaved, device=device)
    if k.ndim > 1:
        k = torch.flip(k, tuple(range(k.ndim - 1)))
    return _conj(k)


def correlate(in1, in2, mode: str = "full", method: str = "auto", *,
              interleaved: Optional[bool] = None):
    """ND cross-correlation (scipy.signal.correlate semantics):
    convolution of ``in1`` with the reversed conjugate of ``in2``, over
    all axes.  See :func:`convolve` for the ``method`` note."""
    if method not in ("auto", "fft", "direct"):
        raise PlanError(f"method must be auto|fft|direct, got {method!r}")
    complex_in = (_is_complex(in1) or _is_complex(in2)
                  or (interleaved is True))
    int_in = _is_integer(in1) and _is_integer(in2)
    dev = _device_of(in1, in2)
    k = _reverse_conj(in2, interleaved if complex_in else False, dev)
    y = fftconvolve(asinterleaved(in1, interleaved if complex_in else False,
                                  device=dev),
                    k, mode, interleaved=True)
    if not complex_in:
        y = y[..., 0]
    return torch.round(y) if int_in else y


def correlation_lags(in1_len: int, in2_len: int,
                     mode: str = "full") -> np.ndarray:
    """Lag indices for :func:`correlate` (scipy.signal.correlation_lags)."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lo = mid - in1_len // 2
        return lags[lo:lo + in1_len]
    if mode == "valid":
        lag_bound = in1_len - in2_len
        return (np.arange(lag_bound + 1) if lag_bound >= 0
                else np.arange(lag_bound, 1))
    raise PlanError(f"mode must be full|same|valid, got {mode!r}")


def _conv2d_impl(x, k, mode: str, boundary: str, fillvalue, same_off):
    """Shared convolve2d/correlate2d machinery on interleaved 2-D inputs.

    scipy's boundary handling reduces to: extend ``x`` by (K-1) on each
    side with the boundary rule, take the valid convolution (= the
    boundary-aware full result), then crop per ``mode``.  ``same_off``
    gives the same-mode crop offset as a function of the kernel dim
    (convolution uses (K-1)//2, correlation K//2: scipy centers the two
    differently for even kernels).
    """
    if mode not in ("full", "same", "valid"):
        raise PlanError(f"mode must be full|same|valid, got {mode!r}")
    if boundary not in ("fill", "wrap", "symm"):
        raise PlanError(f"boundary must be fill|wrap|symm, got {boundary!r}")
    if x.ndim != 3 or k.ndim != 3:
        raise PlanError("convolve2d/correlate2d inputs must be 2-D")
    K0, K1 = k.shape[0], k.shape[1]
    if mode == "valid":
        # the kernel never overhangs, so the boundary rule is irrelevant;
        # fftconvolve's valid route also covers the commuted in2-larger case
        return fftconvolve(x, k, "valid", interleaved=True)
    if boundary == "fill" and fillvalue == 0 and mode == "full":
        return fftconvolve(x, k, "full", interleaved=True)
    fv = complex(fillvalue)
    if boundary == "fill" and fv == 0:
        full = fftconvolve(x, k, "full", interleaved=True)
    else:
        if boundary == "fill":
            # per-lane constant: pad (x - fv) with zeros, then add fv back
            fvec = _const([fv.real, fv.imag], x)
            xp = _zero_pad(_zero_pad(x - fvec, 0, K0 - 1, K0 - 1),
                           1, K1 - 1, K1 - 1) + fvec
        else:
            pm = {"wrap": "wrap", "symm": "symmetric"}[boundary]
            xp = _pad_axis(_pad_axis(x, 0, K0 - 1, K0 - 1, pm),
                           1, K1 - 1, K1 - 1, pm)
        full = fftconvolve(xp, k, "valid", interleaved=True)
    if mode == "full":
        return full
    i0, j0 = same_off(K0), same_off(K1)
    return full[i0:i0 + x.shape[0], j0:j0 + x.shape[1]]


def convolve2d(in1, in2, mode: str = "full", boundary: str = "fill",
               fillvalue=0, *, interleaved: Optional[bool] = None):
    """2-D convolution with scipy.signal.convolve2d's boundary modes:
    'fill' (pad with ``fillvalue``), 'wrap' (circular), 'symm'
    (edge-symmetric reflection).  The boundary extension is two pads
    feeding the package's fftconv plan."""
    complex_in = (_is_complex(in1) or _is_complex(in2)
                  or (interleaved is True) or isinstance(fillvalue, complex))
    dev = _device_of(in1, in2)
    x = asinterleaved(in1, interleaved if complex_in else False, device=dev)
    k = asinterleaved(in2, interleaved if complex_in else False, device=dev)
    y = _conv2d_impl(x, k, mode, boundary, fillvalue,
                     same_off=lambda K: (K - 1) // 2)
    return y if complex_in else y[..., 0]


def correlate2d(in1, in2, mode: str = "full", boundary: str = "fill",
                fillvalue=0, *, interleaved: Optional[bool] = None):
    """2-D cross-correlation (scipy.signal.correlate2d semantics):
    convolution of ``in1`` with the reversed conjugate of ``in2``, with
    the same boundary modes as :func:`convolve2d`.  Note scipy centers
    correlation's 'same' crop at K//2 (vs convolution's (K-1)//2)."""
    complex_in = (_is_complex(in1) or _is_complex(in2)
                  or (interleaved is True) or isinstance(fillvalue, complex))
    dev = _device_of(in1, in2)
    x = asinterleaved(in1, interleaved if complex_in else False, device=dev)
    k = _reverse_conj(in2, interleaved if complex_in else False, dev)
    y = _conv2d_impl(x, k, mode, boundary, fillvalue,
                     same_off=lambda K: K // 2)
    return y if complex_in else y[..., 0]


def deconvolve(signal, divisor):
    """Polynomial long division: (quotient, remainder) with
    signal = convolve(divisor, quotient) + remainder
    (scipy.signal.deconvolve semantics).

    Runs on the HOST in float64: deconvolution is an inherently
    sequential recursion (scipy implements it as an IIR lfilter), and its
    inputs are typically short filter responses."""
    num = np.atleast_1d(np.asarray(_to_numpy(signal), np.float64))
    den = np.atleast_1d(np.asarray(_to_numpy(divisor), np.float64))
    if num.ndim != 1 or den.ndim != 1:
        raise PlanError("deconvolve takes 1-D signal and divisor")
    if den.size == 0 or den[0] == 0:
        raise PlanError("divisor must have a non-zero leading coefficient")
    N, D = num.size, den.size
    if D > N:
        return np.zeros(1), num.copy()
    quot = np.zeros(N - D + 1)
    rem = num.copy()
    for i in range(N - D + 1):
        q = rem[i] / den[0]
        quot[i] = q
        rem[i:i + D] -= q * den
    return quot, rem


def detrend(data, axis: int = -1, type: str = "linear", bp=0):
    """Remove a constant or per-segment linear trend along ``axis``
    (scipy.signal.detrend semantics, breakpoints included)."""
    if type not in ("linear", "constant", "l", "c"):
        raise PlanError(f"type must be 'linear' or 'constant', got {type!r}")
    x = _f32(data)
    ax = _axes_list(x.ndim, (axis,), False)[0]
    n = x.shape[ax]
    if type in ("constant", "c"):
        return x - x.mean(dim=ax, keepdim=True)
    bps = np.sort(np.unique(np.concatenate(
        [[0], np.atleast_1d(np.asarray(bp, np.int64)).ravel(), [n]])))
    if np.any(bps > n) or np.any(bps < 0):
        raise PlanError("breakpoints must lie within the axis length")
    x = torch.movedim(x, ax, -1)
    parts = []
    for lo, hi in zip(bps[:-1], bps[1:]):
        m = int(hi - lo)
        if m == 0:
            continue
        seg = _slice(x, int(lo), int(hi), -1)
        tc = _const(np.arange(m) - (m - 1) / 2.0, x)
        denom = float(np.sum((np.arange(m) - (m - 1) / 2.0) ** 2)) or 1.0
        b = (seg * tc).sum(dim=-1, keepdim=True) / denom
        a = seg.mean(dim=-1, keepdim=True)
        parts.append(seg - (a + b * tc))
    y = torch.cat(parts, dim=-1)
    return torch.movedim(y, -1, ax)


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """Window samples (scipy.signal.get_window semantics: string, (name,
    param) tuple, or a float Kaiser beta; ``fftbins=True`` gives the
    periodic form used by the spectral estimators).  Resolved through
    the package's own window zoo (``windows.py``): no scipy dependency at
    runtime."""
    from .windows import get_window as _gw
    return np.asarray(_gw(window, int(Nx), fftbins=fftbins), np.float32)


# ---------------------------------------------------------------- stft

def _get_window(window, W: int) -> np.ndarray:
    if isinstance(window, (str, tuple)):
        from .windows import get_window as _gw
        return np.asarray(_gw(window, W), np.float32)
    w = np.asarray(_to_numpy(window), np.float32)
    if w.shape != (W,):
        raise PlanError(f"window must have length nperseg ({W}), "
                        f"got {w.shape}")
    return w


def _stft_hop(what: str, nperseg, noverlap) -> Tuple[int, int]:
    """(nperseg, hop) with basic validation."""
    W = int(nperseg)
    H = W - (int(noverlap) if noverlap is not None else W // 2)
    if H <= 0:
        raise PlanError(
            f"{what} needs noverlap < nperseg (hop={H}, nperseg={W})")
    return W, H


# the block overlap-add bails to index_add when the window spans this many
# blocks (W // gcd(W, H) strided passes over the output)
_FRAME_MAX_BLOCKS = 64


def _frame_geometry(W: int, H: int):
    """(g, wg, hg, use_blocks): gcd-block geometry of the overlap-add.
    Every hop start is a multiple of g = gcd(W, H), so frames decompose
    into wg block-columns, column j landing on a stride-hg slice of the
    output's block grid."""
    g = math.gcd(W, H)
    wg, hg = W // g, H // g
    use_blocks = W % H == 0 or (g > 1 and wg <= _FRAME_MAX_BLOCKS)
    return g, wg, hg, use_blocks


def _frame_segments(xp, W: int, H: int, nb: int):
    """(..., L) -> overlapping frames (..., nb, W), as a VIEW
    (``Tensor.unfold``): frame p is ``xp[..., p*H : p*H + W]``.  Nothing is
    copied here; the window multiply (or detrend) that every caller applies
    next reads each sample W/H times and writes the frames once."""
    fr = xp.unfold(-1, W, H)
    if fr.shape[-2] < nb:
        raise PlanError(f"signal of length {xp.shape[-1]} holds "
                        f"{fr.shape[-2]} frames, {nb} wanted")
    return fr if fr.shape[-2] == nb else fr.narrow(-2, 0, nb)


def _overlap_add(frames, W: int, H: int):
    """(..., nb, W) frames -> (..., (nb-1)*H + W) hop overlap-add, the
    inverse of ``_frame_segments``.

    On g = gcd(W, H) blocks frame m's column-block j lands at output block
    m*hg + j, so each of the wg columns adds as a zero-interleave + shift:
    wg deterministic strided adds, no atomics.  Framings whose window spans
    more than ``_FRAME_MAX_BLOCKS`` blocks use one ``index_add``."""
    lead = tuple(frames.shape[:-2])
    nb = frames.shape[-2]
    total = (nb - 1) * H + W
    g, wg, hg, use_blocks = _frame_geometry(W, H)
    if use_blocks:
        out_blocks = (nb - 1) * hg + wg
        content = (nb - 1) * hg + 1   # trailing interleave blocks are 0
        acc = None
        for j in range(wg):
            seg = frames[..., j * g:(j + 1) * g]          # (..., nb, g)
            if hg > 1:
                seg = _zero_pad(seg.unsqueeze(-2), -2, 0, hg - 1)
                seg = seg.reshape(*lead, nb * hg, g).narrow(-2, 0, content)
            seg = _zero_pad(seg, -2, j, out_blocks - j - content)
            acc = seg if acc is None else acc + seg
        return acc.reshape(*lead, out_blocks * g)
    idx = (np.arange(nb)[:, None] * H + np.arange(W)[None, :]).reshape(-1)
    src = frames.reshape(*lead, nb * W)
    zeros = torch.zeros_like(src[..., :1]).expand(*lead, total)
    return zeros.index_add(-1, torch.as_tensor(idx, device=frames.device),
                           src)


def stft(x, fs: float = 1.0, window="hann", nperseg: int = 256,
         noverlap: Optional[int] = None, nfft: Optional[int] = None,
         boundary: str = "zeros", padded: bool = True, axis: int = -1):
    """Short-time Fourier transform of a REAL signal
    (scipy.signal.stft semantics: detrend off, one-sided, 'spectrum'
    scaling: Zxx scaled by 1/win.sum()).

    Returns (f, t, Zxx) with Zxx interleaved (..., nfft//2+1, nb, 2).
    The frames are an ``unfold`` view of the padded signal; the window
    multiply makes the one copy that the r2c plan then transforms.
    """
    if boundary not in ("zeros", None):
        raise PlanError("stft supports boundary='zeros' or None")
    x = _f32(x)
    axes = _axes_list(x.ndim, (axis,), False)
    x, undo = _move_to_trailing(x, axes, comp=False)
    W, H = _stft_hop("stft", nperseg, noverlap)
    m = int(nfft) if nfft is not None else W
    if m < W:
        raise PlanError("nfft must be >= nperseg")
    win = _get_window(window, W)
    n = x.shape[-1]
    lpad = W // 2 if boundary == "zeros" else 0
    L = n + 2 * lpad
    if L < W or padded or (L - W) % H == 0:
        nb = max(-(-(L - W) // H) + 1, 1)     # pad up to frame-aligned
    else:
        nb = (L - W) // H + 1                 # padded=False: truncate tail
    total = (nb - 1) * H + W
    # the boundary pad is lpad on the LEFT only; the right side absorbs
    # the second boundary pad plus frame alignment (or truncates when
    # padded=False leaves a partial tail)
    right = total - n - lpad
    xp = _zero_pad(x, -1, lpad, max(right, 0))
    if right < 0:
        xp = _slice(xp, 0, total, -1)
    frames = _frame_segments(xp, W, H, nb) * _const(win, x)   # (..., nb, W)
    if m > W:
        frames = _zero_pad(frames, -1, 0, m - W)
    Z = rfft(frames, axis=-1) / float(win.sum())          # (..., nb, f, 2)
    Z = Z.transpose(-3, -2)                               # (..., f, nb, 2)
    f = np.fft.rfftfreq(m, 1.0 / fs)
    t = (np.arange(nb) * H + W // 2 - lpad) / fs   # scipy uses the floor
    return f, t, _restore_axes(Z, undo, comp=True)


def istft(Zxx, fs: float = 1.0, window="hann", nperseg: Optional[int] = None,
          noverlap: Optional[int] = None, nfft: Optional[int] = None,
          boundary: bool = True, *, interleaved: Optional[bool] = None):
    """Inverse STFT (scipy.signal.istft semantics for one-sided input
    produced by :func:`stft`): windowed overlap-add with the COLA
    win^2 normalization.  Zxx: (..., f, t[, 2]); returns (t_axis, x).
    """
    Z = asinterleaved(Zxx, interleaved)
    m_bins = Z.shape[-3]
    nb = Z.shape[-2]
    m = int(nfft) if nfft is not None else 2 * (m_bins - 1)
    W, H = _stft_hop("istft", nperseg if nperseg is not None else m,
                     noverlap)
    if W > m:
        raise PlanError(f"nfft ({m}) must be >= nperseg ({W})")
    win = _get_window(window, W)
    Zt = Z.transpose(-3, -2)                              # (..., nb, f, 2)
    frames = irfft(Zt, n=m, axis=-1, interleaved=True) * float(win.sum())
    frames = frames[..., :W] * _const(win, frames)        # (..., nb, W)
    total_out = (nb - 1) * H + W
    w2 = win.astype(np.float64) ** 2
    # steady-state overlap profile built from the window alone (the
    # H-periodic sum every interior sample sees with unbounded frames):
    # independent of nb, so short signals with a valid hop are not
    # false-positived and every hop phase is checked (NOLA gate below)
    full = np.array([w2[p::H].sum() for p in range(H)])
    y = _overlap_add(frames, W, H)
    g, wg, hg, use_blocks = _frame_geometry(W, H)
    if use_blocks:
        # COLA win^2 normalization: interior output blocks see the
        # hg-periodic steady-state block profile; only the first wg-1
        # and last wg-1 blocks differ: O(wg^2 g) host work regardless
        # of signal length
        out_blocks = (nb - 1) * hg + wg
        w2b = w2.reshape(wg, g)
        ss = np.zeros((hg, g))
        for j in range(wg):
            ss[j % hg] += w2b[j]
        norm_blocks = np.tile(ss, (-(-out_blocks // hg), 1))[:out_blocks]
        edge = sorted(set(range(min(wg - 1, out_blocks)))
                      | set(range(min(nb * hg, out_blocks), out_blocks)))
        for p in edge:
            tot = np.zeros(g)
            for j in range(p % hg, min(wg, p + 1), hg):
                if 0 <= (p - j) // hg < nb:
                    tot += w2b[j]
            norm_blocks[p] = tot
        norm = norm_blocks.reshape(-1)
    else:
        idx = (np.arange(nb)[:, None] * H
               + np.arange(W)[None, :]).reshape(-1)
        norm = np.zeros(total_out)
        np.add.at(norm, idx, np.tile(w2, nb))
    lpad = W // 2 if boundary else 0
    n_out = total_out - 2 * lpad
    # NOLA gate on the STEADY-STATE overlap profile (`full`: what every
    # interior hop sees, scipy check_NOLA's criterion): a window/hop whose
    # win^2 overlap-add vanishes there cannot be inverted; raise instead
    # of quietly dividing by 1 and returning garbage.  Edge blocks are
    # legitimately partial (tapered reconstruction, like scipy's).
    if full.min() <= 1e-10 * max(full.max(), 1e-30):
        raise PlanError(
            f"istft: window/hop fails the NOLA constraint (steady-state "
            f"win^2 overlap-add has zeros; nperseg={W}, hop={H}): "
            "reconstruction is impossible for this framing")
    norm = np.where(norm > 1e-10, norm, 1.0)
    y = y / _const(norm, y)
    if lpad:
        y = _slice(y, lpad, lpad + n_out, -1)
    t = np.arange(y.shape[-1]) / fs
    return t, y


def _segment_spectra(x, fs, window, nperseg, noverlap, nfft, scaling,
                     axis, what):
    """Windowed mean-detrended segment rffts for the Welch estimators.

    Returns (Z, scale_vec, undo, f): Z interleaved (..., nb, f, 2), the
    one-sided PSD scale vector (doubling folded in), the axis-restore
    token, and the frequency grid.
    """
    if scaling not in ("density", "spectrum"):
        raise PlanError("scaling must be 'density' or 'spectrum'")
    x = _f32(x)
    axes = _axes_list(x.ndim, (axis,), False)
    x, undo = _move_to_trailing(x, axes, comp=False)
    W, H = _stft_hop(what, nperseg, noverlap)
    m = int(nfft) if nfft is not None else W
    if m < W:
        raise PlanError("nfft must be >= nperseg")
    win = _get_window(window, W)
    n = x.shape[-1]
    if n < W:
        raise PlanError(f"signal shorter than nperseg ({n} < {W})")
    nb = (n - W) // H + 1                 # scipy: trailing partial dropped
    frames = _frame_segments(x, W, H, nb)
    frames = frames - frames.mean(dim=-1, keepdim=True)   # detrend
    frames = frames * _const(win, x)
    if m > W:
        frames = _zero_pad(frames, -1, 0, m - W)
    Z = rfft(frames, axis=-1)                          # (..., nb, f, 2)
    # one-sided doubling (all bins except DC and, for even m, Nyquist)
    dbl = np.full(m // 2 + 1, 2.0, np.float32)
    dbl[0] = 1.0
    if m % 2 == 0:
        dbl[-1] = 1.0
    if scaling == "density":
        s = 1.0 / (fs * float(np.sum(win.astype(np.float64) ** 2)))
    else:
        s = 1.0 / float(np.sum(win.astype(np.float64))) ** 2
    sv = _const(dbl * np.float32(s), Z)
    return Z, sv, undo, np.fft.rfftfreq(m, 1.0 / fs)


def spectrogram(x, fs: float = 1.0, window=("tukey", 0.25),
                nperseg: int = 256, noverlap: Optional[int] = None,
                nfft: Optional[int] = None, scaling: str = "density",
                axis: int = -1):
    """Per-segment PSD spectrogram of a REAL signal
    (scipy.signal.spectrogram semantics, mode='psd': Welch scaling but
    NOT averaged over segments; scipy's noverlap default nperseg//8).

    Returns (f, t, Sxx) with Sxx (..., f, nb) real.
    """
    if noverlap is None:
        noverlap = int(nperseg) // 8
    Z, sv, undo, f = _segment_spectra(x, fs, window, nperseg, noverlap,
                                      nfft, scaling, axis, "spectrogram")
    S = (Z[..., 0] ** 2 + Z[..., 1] ** 2) * sv         # (..., nb, f)
    S = S.transpose(-2, -1)                            # (..., f, nb)
    W = int(nperseg)
    H = W - int(noverlap)
    nb = Z.shape[-3]
    t = (np.arange(nb) * H + W / 2) / fs
    return f, t, _restore_axes(S, undo, comp=True)


def welch(x, fs: float = 1.0, window="hann", nperseg: int = 256,
          noverlap: Optional[int] = None, nfft: Optional[int] = None,
          scaling: str = "density", axis: int = -1):
    """Welch power-spectral-density estimate of a REAL signal
    (scipy.signal.welch semantics with detrend='constant'): averaged
    one-sided periodograms of overlapping windowed segments.

    Returns (f, Pxx).  Built on the stft framing.
    """
    Z, sv, undo, f = _segment_spectra(x, fs, window, nperseg, noverlap,
                                      nfft, scaling, axis, "welch")
    P = (Z[..., 0] ** 2 + Z[..., 1] ** 2).mean(dim=-2) * sv
    return f, _restore_axes(P, undo, comp=False)


def _pair_spectra(x, y, fs, window, nperseg, noverlap, nfft, scaling,
                  axis, what):
    """Segment spectra of a signal pair on one common framing (scipy
    zero-pads the shorter input to the longer along the axis)."""
    dev = _device_of(x, y)
    x = _f32(x, dev)
    y = _f32(y, dev)
    ax = _axes_list(x.ndim, (axis,), False)[0]
    if x.shape[ax] != y.shape[ax]:
        n = max(x.shape[ax], y.shape[ax])
        x = _crop_or_pad(x, n, ax)
        y = _crop_or_pad(y, n, ax)
    Zx, sv, undo, f = _segment_spectra(x, fs, window, nperseg, noverlap,
                                       nfft, scaling, axis, what)
    Zy, _, _, _ = _segment_spectra(y, fs, window, nperseg, noverlap,
                                   nfft, scaling, axis, what)
    if Zx.shape != Zy.shape:
        raise PlanError(
            f"{what} inputs must frame identically, got spectra "
            f"{tuple(Zx.shape)} vs {tuple(Zy.shape)}")
    return Zx, Zy, sv, undo, f


def _cross_mean(Zx, Zy, sv):
    """(Pxy_re, Pxy_im) = segment-averaged conj(X)*Y, scaled."""
    xr, xi = Zx[..., 0], Zx[..., 1]
    yr, yi = Zy[..., 0], Zy[..., 1]
    pr = (xr * yr + xi * yi).mean(dim=-2)              # Re(conj(X) Y)
    pi = (xr * yi - xi * yr).mean(dim=-2)              # Im(conj(X) Y)
    return pr * sv, pi * sv


def csd(x, y, fs: float = 1.0, window="hann", nperseg: int = 256,
        noverlap: Optional[int] = None, nfft: Optional[int] = None,
        scaling: str = "density", axis: int = -1):
    """Cross-spectral density of two REAL signals
    (scipy.signal.csd semantics: Pxy = averaged conj(X)*Y of the
    windowed segments, Welch scaling, shorter input zero-padded).
    Returns (f, Pxy) with Pxy interleaved (..., f, 2): ``ascomplex``
    for a numpy complex array.
    """
    Zx, Zy, sv, undo, f = _pair_spectra(x, y, fs, window, nperseg,
                                        noverlap, nfft, scaling, axis,
                                        "csd")
    pr, pi = _cross_mean(Zx, Zy, sv)
    return f, _restore_axes(torch.stack([pr, pi], dim=-1), undo, comp=True)


def coherence(x, y, fs: float = 1.0, window="hann", nperseg: int = 256,
              noverlap: Optional[int] = None, nfft: Optional[int] = None,
              axis: int = -1):
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx * Pyy)
    (scipy.signal.coherence semantics).  Returns (f, Cxy).  Pxx/Pyy are
    computed from the same segment spectra as Pxy: one framing + FFT
    pass per signal, not two."""
    Zx, Zy, sv, undo, f = _pair_spectra(x, y, fs, window, nperseg,
                                        noverlap, nfft, "density", axis,
                                        "coherence")
    pr, pi = _cross_mean(Zx, Zy, sv)
    Pxx = (Zx[..., 0] ** 2 + Zx[..., 1] ** 2).mean(dim=-2) * sv
    Pyy = (Zy[..., 0] ** 2 + Zy[..., 1] ** 2).mean(dim=-2) * sv
    C = (pr ** 2 + pi ** 2) / (Pxx * Pyy)
    return f, _restore_axes(C, undo, comp=False)


def periodogram(x, fs: float = 1.0, window="boxcar",
                nfft: Optional[int] = None, scaling: str = "density",
                axis: int = -1):
    """Single-segment PSD estimate (scipy.signal.periodogram semantics
    with detrend='constant'): Welch with one full-length segment.
    ``nfft`` shorter than the signal crops the signal to ``nfft`` first
    (scipy's behavior), longer zero-pads the spectrum."""
    x = _f32(x)
    n = x.shape[axis]
    if nfft is not None and int(nfft) < n:
        n = int(nfft)
        x = _slice(x, 0, n, axis)
        nfft = None
    if isinstance(window, str) and window == "boxcar":
        window = np.ones(n, np.float32)
    return welch(x, fs=fs, window=window, nperseg=n, noverlap=0,
                 nfft=nfft, scaling=scaling, axis=axis)


def czt(x, m: Optional[int] = None, w=None, a=1 + 0j, *, axis: int = -1,
        interleaved: Optional[bool] = None):
    """Chirp-Z transform along ``axis`` (scipy.signal.czt semantics):
    X[k] = sum_n x[n] a^{-n} w^{nk} for k < m, evaluated via the
    Bluestein convolution at a smooth padded length: the general form
    of the spiral-contour z-transform (the FFT is the w=exp(-2j pi/n),
    a=1 special case).  Returns interleaved (..., m, 2).

    Accuracy note: unit-modulus contours (|w| = 1, the zoom-FFT case)
    match scipy at float32 precision.  Decaying/growing spirals make the
    chirp tables span orders of magnitude, which the float32 device math
    resolves only loosely; use scipy on the host for f64 spirals.
    """
    x = asinterleaved(x, interleaved)
    nd = x.ndim - 1
    axes = _axes_list(nd, (axis,), False)
    x, undo = _move_to_trailing(x, axes, comp=True)
    n = x.shape[-2]
    m = int(m) if m is not None else n
    if m < 1:
        raise PlanError("czt m must be >= 1")
    w = complex(w) if w is not None else np.exp(-2j * np.pi / m)
    a = complex(a)
    # Bluestein: w^{nk} = w^{(n^2 + k^2 - (k-n)^2)/2}, so the transform
    # is a pre-chirp multiply, a linear convolution with w^{-j^2/2}, and
    # a post-chirp multiply: all host-precomputed tables (float64)
    from .core.cplx import cmul_const, const_pair
    k2 = np.arange(max(m, n), dtype=np.float64) ** 2 / 2.0
    ypre = np.power(a, -np.arange(n, dtype=np.float64)) * np.power(w, k2[:n])
    L = factors.next_smooth_at_least(m + n - 1)
    v = np.zeros(L, np.complex128)
    v[:m] = np.power(w, -k2[:m])
    v[L - n + 1:] = np.power(w, -k2[1:n][::-1])
    pa, pb = const_pair(ypre)
    va, vb = const_pair(np.fft.fft(v))
    oa, ob = const_pair(np.power(w, k2[:m]))
    y = cmul_const(x, _const(pa, x), _const(pb, x))
    y = _zero_pad(y, -2, 0, L - n)
    Y = cmul_const(fft(y, axis=-1, interleaved=True),
                   _const(va, x), _const(vb, x))
    g = ifft(Y, axis=-1, interleaved=True)
    g = _slice(g, 0, m, -2)
    out = cmul_const(g, _const(oa, x), _const(ob, x))
    return _restore_axes(out, undo, comp=True)


def zoom_fft(x, fn, m: Optional[int] = None, *, fs: float = 2.0,
             axis: int = -1, interleaved: Optional[bool] = None):
    """Zoomed FFT over the band [fn[0], fn[1]] (scipy.signal.zoom_fft
    semantics, endpoint=False; scalar fn means [0, fn]): frequencies
    f1 + (f2-f1)*k/m for k < m."""
    if np.isscalar(fn):
        f1, f2 = 0.0, float(fn)
    else:
        f1, f2 = float(fn[0]), float(fn[1])
    xx = asinterleaved(x, interleaved)
    n = xx.shape[_axes_list(xx.ndim - 1, (axis,), False)[0]]
    m = int(m) if m is not None else n
    w = np.exp(-2j * np.pi * (f2 - f1) / (fs * m))
    a = np.exp(2j * np.pi * f1 / fs)
    return czt(xx, m=m, w=w, a=a, axis=axis, interleaved=True)


def resample(x, num: int, axis: int = -1):
    """Fourier-method resampling of a REAL signal to ``num`` samples
    (scipy.signal.resample semantics: crop or zero-pad the spectrum,
    with the Nyquist-bin split/merge scipy applies)."""
    x = _f32(x)
    axes = _axes_list(x.ndim, (axis,), False)
    x, undo = _move_to_trailing(x, axes, comp=False)
    n = x.shape[-1]
    num = int(num)
    if num < 1:
        raise PlanError("resample num must be >= 1")
    X = rfft(x, axis=-1)                        # (..., n//2+1, 2)
    nb_in, nb_out = n // 2 + 1, num // 2 + 1
    if nb_out <= nb_in:
        Y = _slice(X, 0, nb_out, -2)
        if num % 2 == 0 and nb_out - 1 < nb_in - 1 + (n % 2):
            # the new Nyquist bin aggregates its conjugate pair: double
            # the real part, drop the imaginary (scipy's merge; the
            # enclosing guard already excludes a source-Nyquist passthrough)
            mask = np.ones((nb_out, 2), np.float32)
            mask[-1, 0] = 2.0
            mask[-1, 1] = 0.0
            Y = Y * _const(mask, Y)
    else:
        if n % 2 == 0:
            # the source Nyquist bin splits into a conjugate pair:
            # scipy halves it before padding
            mask = np.ones((nb_in, 2), np.float32)
            mask[-1] = 0.5
            X = X * _const(mask, X)
        Y = _zero_pad(X, -2, 0, nb_out - nb_in)
    y = irfft(Y, n=num, axis=-1, interleaved=True) * float(num / n)
    return _restore_axes(y, undo, comp=False)


def _upfirdn_len(len_h: int, n_in: int, up: int, down: int) -> int:
    """Output length of upfirdn (scipy's _output_len)."""
    return ((n_in - 1) * up + len_h + down - 1) // down


_UPFIRDN_PAD = {"symmetric": "symmetric", "reflect": "reflect",
                "edge": "edge", "wrap": "wrap"}


def upfirdn(h, x, up: int = 1, down: int = 1, axis: int = -1,
            mode: str = "constant", cval=0, *,
            interleaved: Optional[bool] = None):
    """Upsample, FIR filter, downsample (scipy.signal.upfirdn semantics).

    The zero-stuff is a stack+reshape, the FIR is the package's FFT
    convolution (mathematically identical to the polyphase form), and the
    downsample a strided slice.  Signal extension modes: 'constant'
    (cval), 'symmetric', 'reflect', 'edge', 'wrap' (scipy's remaining
    modes are host-side spline fits and raise)."""
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise PlanError("up and down must be >= 1")
    if mode != "constant" and mode not in _UPFIRDN_PAD:
        raise PlanError(
            f"upfirdn mode {mode!r} unsupported; available: constant, "
            f"{', '.join(sorted(_UPFIRDN_PAD))}")
    complex_in = (_is_complex(x) or _is_complex(h)
                  or isinstance(cval, complex) or (interleaved is True))
    dev = _device_of(h, x)
    hv = asinterleaved(h, False, device=dev)   # complex interleaves itself
    if hv.ndim != 2:
        raise PlanError("upfirdn filter h must be 1-D")
    xv = asinterleaved(x, interleaved if complex_in else False, device=dev)
    nd = xv.ndim - 1
    axes = _axes_list(nd, (axis,), False)
    xv, undo = _move_to_trailing(xv, axes, comp=True)
    n_in = xv.shape[-2]
    len_h = hv.shape[0]
    # signal extension: K original samples cover the filter's reach
    K = 0
    if not (mode == "constant" and cval == 0):
        K = -(-(len_h - 1) // up)
        if mode == "constant":
            fv = complex(cval)
            fvec = _const([fv.real, fv.imag], xv)
            xv = _zero_pad(xv - fvec, -2, K, K) + fvec
        else:
            if K >= n_in and mode in ("symmetric", "reflect"):
                raise PlanError(
                    f"{mode} extension needs signal length > filter reach")
            xv = _pad_axis(xv, -2, K, K, _UPFIRDN_PAD[mode])
    # zero-stuff by up: (..., n, 2) -> (..., n, up, 2) -> (..., n*up, 2)
    if up > 1:
        ns = xv.shape[-2]
        xv = _zero_pad(xv.unsqueeze(-2), -2, 0, up - 1)
        xv = xv.reshape(*xv.shape[:-3], ns * up, 2)
    kshape = (1,) * (nd - 1) + (len_h,)
    y = fftconvolve(xv, hv.reshape(*kshape, 2), "full", axes=nd - 1,
                    interleaved=True)
    L = (n_in - 1) * up + len_h
    y = _slice(y, K * up, K * up + L, nd - 1)
    y = y[..., ::down, :]
    y = _restore_axes(y, undo, comp=True)
    return y if complex_in else y[..., 0]


def _median(x, dim: int):
    """numpy's median (the two middle values averaged for an even count;
    ``torch.median`` would take the lower one), keepdims."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    return 0.5 * (s.narrow(dim, (n - 1) // 2, 1) + s.narrow(dim, n // 2, 1))


def resample_poly(x, up: int, down: int, axis: int = 0,
                  window=("kaiser", 5.0), padtype: str = "constant",
                  cval=None, *, interleaved: Optional[bool] = None):
    """Polyphase resampling (scipy.signal.resample_poly semantics): the
    signal is upsampled by ``up``, low-pass filtered by a zero-phase FIR
    (designed via firwin unless ``window`` is a precomputed array), and
    downsampled by ``down``.  padtype 'constant' (cval) plus the
    background-subtraction types mean/median/maximum/minimum and the
    pad-mode types symmetric/reflect/edge/wrap."""
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise PlanError("up and down must be >= 1")
    if cval is not None and padtype != "constant":
        raise PlanError("cval has no effect unless padtype is 'constant'")
    g = math.gcd(up, down)
    up //= g
    down //= g
    complex_in = _is_complex(x) or (interleaved is True)
    xv = asinterleaved(x, interleaved if complex_in else False)
    if up == down == 1:
        return xv if complex_in else xv[..., 0]
    nd = xv.ndim - 1
    ax = axis % nd
    n_in = xv.shape[ax]
    n_out = n_in * up // down + bool((n_in * up) % down)
    if isinstance(window, (list, torch.Tensor)) or hasattr(window, "ndim"):
        h = np.asarray(_to_numpy(window), np.float64)
        if h.ndim != 1:
            raise PlanError("window array must be 1-D")
        h = h.copy()
        half_len = (h.size - 1) // 2
    else:
        # linear-phase low-pass FIR (scipy's design: cutoff 1/max_rate,
        # half length 10*max_rate)
        max_rate = max(up, down)
        half_len = 10 * max_rate
        try:
            from scipy.signal import firwin
        except ImportError:
            raise PlanError(
                "resample_poly window design needs scipy; pass a "
                "precomputed 1-D window array instead") from None
        h = firwin(2 * half_len + 1, 1.0 / max_rate, window=window)
    h = h * up
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while _upfirdn_len(h.size + n_pre_pad + n_post_pad, n_in,
                       up, down) < n_out + n_pre_remove:
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    h = h.astype(np.float32)
    bg = None
    kw = {"mode": "constant", "cval": 0}
    stats = {"mean": lambda v: v.mean(dim=ax, keepdim=True),
             "median": lambda v: _median(v, ax),
             "minimum": lambda v: v.amin(dim=ax, keepdim=True),
             "maximum": lambda v: v.amax(dim=ax, keepdim=True)}
    if padtype in stats:
        bg = stats[padtype](xv)
        xv = xv - bg
    elif padtype == "constant":
        kw["cval"] = cval if cval is not None else 0
    elif padtype in _UPFIRDN_PAD:
        kw = {"mode": padtype}
    else:
        raise PlanError(
            f"padtype {padtype!r} unsupported; available: constant, "
            f"mean, median, maximum, minimum, "
            f"{', '.join(sorted(_UPFIRDN_PAD))}")
    y = upfirdn(h, xv, up, down, axis=ax, interleaved=True, **kw)
    y = _slice(y, n_pre_remove, n_pre_remove + n_out, ax)
    if bg is not None:
        y = y + bg
    return y if complex_in else y[..., 0]


def decimate(x, q: int, n: Optional[int] = None, ftype: str = "iir",
             axis: int = -1, zero_phase: bool = True, *,
             interleaved: Optional[bool] = None):
    """Downsample after an anti-aliasing filter
    (scipy.signal.decimate's FIR path: ftype='fir', hamming-window
    firwin design, zero-phase via resample_poly).

    ftype='iir' (scipy's default) is an order-8 Chebyshev RECURSION, an
    inherently sequential op that the package does not implement; call
    with ftype='fir' (values then match scipy's FIR path to f32)."""
    q = int(q)
    if q < 1:
        raise PlanError("q must be >= 1")
    if ftype == "iir":
        raise PlanError(
            "decimate ftype='iir' is a sequential IIR recursion, which "
            "this package does not implement; use ftype='fir' for the "
            "firwin/upfirdn path")
    if ftype != "fir":
        raise PlanError(f"ftype must be 'fir' (got {ftype!r})")
    if n is None:
        n = 2 * (10 * q)
    try:
        from scipy.signal import firwin
    except ImportError:
        raise PlanError("decimate filter design needs scipy") from None
    b = firwin(n + 1, 1.0 / q, window="hamming")
    complex_in = _is_complex(x) or (interleaved is True)
    xv = asinterleaved(x, interleaved if complex_in else False)
    nd = xv.ndim - 1
    ax = axis % nd
    if zero_phase:
        y = resample_poly(xv, 1, q, axis=ax, window=b, interleaved=True)
    else:
        n_out = xv.shape[ax] // q + bool(xv.shape[ax] % q)
        y = upfirdn(b, xv, 1, q, axis=ax, interleaved=True)
        y = _slice(y, 0, n_out, ax)
    return y if complex_in else y[..., 0]


def hilbert(x, axis: int = -1):
    """Analytic signal via the frequency-domain method
    (scipy.signal.hilbert semantics).  Returns interleaved (..., 2):
    real part = x, imaginary part = its Hilbert transform."""
    x = _f32(x)
    axes = _axes_list(x.ndim, (axis,), False)
    x, undo = _move_to_trailing(x, axes, comp=False)
    n = x.shape[-1]
    X = fft(x, axis=-1, interleaved=False)      # (..., n, 2)
    h = _const(_hilbert_step(n), X)
    y = ifft(X * h[:, None], axis=-1, interleaved=True)
    return _restore_axes(y, undo, comp=True)


def _hilbert_step(n: int) -> np.ndarray:
    """The frequency-domain analytic-signal weights (1, 2...2, [1])."""
    h = np.zeros(n, np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return h


def hilbert2(x, N=None, axes=(-2, -1)):
    """2-D analytic signal (scipy.signal.hilbert2 semantics): the
    "single-orthant" transform: the 2-D FFT weighted per axis by
    (1, 2, ..., 2, 0, ..., 0), doubling bins 1:(n+1)//2 and zeroing the
    rest (unlike the 1-D :func:`hilbert`, an even-n Nyquist bin is
    ZEROED).  ``N`` (int or 2-tuple) crops-or-pads the FFT shape along
    ``axes``; extra dimensions ride as batch.  Returns interleaved
    (..., 2)."""
    x = _f32(x)
    if x.ndim < 2:
        raise PlanError("hilbert2 needs an at-least-2-D real array")
    if len(axes) != 2 or (axes[0] % x.ndim) == (axes[1] % x.ndim):
        raise PlanError("axes must be two distinct axes")
    ax = tuple(a % x.ndim for a in axes)
    if N is None:
        s = (x.shape[ax[0]], x.shape[ax[1]])
    elif isinstance(N, int):
        s = (N, N)
    else:
        s = tuple(int(n) for n in N)
        if len(s) != 2:
            raise PlanError("N must be an int or a 2-tuple")
    if any(n < 1 for n in s):
        raise PlanError("N must be positive")
    X = fft2(x, s=s, axes=ax, interleaved=False)
    for a, n in zip(ax, s):
        h = np.zeros(n, np.float32)
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
        shape = [1] * X.ndim
        shape[a] = n
        X = X * _const(h.reshape(shape), X)
    return ifft2(X, axes=ax, interleaved=True)


# ---------------------------------------------------------------- FFTLog

_LN2 = float(np.log(2.0))


def _fht_special():
    try:
        from scipy.special import loggamma, poch
    except ImportError as e:  # pragma: no cover
        raise PlanError("fht/ifht/fhtoffset need scipy for the log-gamma "
                        "tables") from e
    return loggamma, poch


def _fht_coeff(n: int, dln: float, mu: float, offset: float, bias: float,
               inverse: bool) -> np.ndarray:
    """FFTLog kernel coefficients u_m = (k_c r_c)^{-2iy_m} U_mu(q + 2iy_m)
    with U_mu(x) = 2^x Gamma((mu+1+x)/2) / Gamma((mu+1-x)/2) and
    y_m = pi m / (n dln)  (Hamilton 2000 eq. 16-19; semantics pinned to
    scipy.fft's fhtcoeff incl. the pole and singular-transform fixups)."""
    loggamma, poch = _fht_special()
    lnkr, q = float(offset), float(bias)
    xp_ = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.linspace(0.0, np.pi * (n // 2) / (n * dln), n // 2 + 1)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        lg = loggamma(xp_ + 1j * y) - np.conj(loggamma(xm + 1j * y))
        u = np.exp(lg + q * _LN2 + 2j * (_LN2 - lnkr) * y)
    if n % 2 == 0:
        u.imag[-1] = 0.0
    if not np.isfinite(u[0]):
        # u_0 = 2^q Gamma(xp)/Gamma(xm); poch() covers the gamma poles
        u[0] = 2.0 ** q * poch(xm, xp_ - xm)
    if np.isinf(u[0]) and not inverse:
        import warnings
        warnings.warn("singular transform; consider changing the bias",
                      stacklevel=3)
        u = u.copy()
        u[0] = 0.0
    elif u[0] == 0 and inverse:
        import warnings
        warnings.warn("singular inverse transform; consider changing the "
                      "bias", stacklevel=3)
        u = u.copy()
        u[0] = np.inf
    return u


def _fht_core(a, dln: float, mu: float, offset: float, bias: float,
              inverse: bool):
    from .core.cplx import to_t4, cmul_t4
    a = _f32(a)
    n = a.shape[-1]
    dln = float(dln)
    j = np.arange(n, dtype=np.float64)
    j_c = (n - 1) / 2
    if bias != 0:
        # power-law bias of the input sequence (a_q(r) = a(r) (r/r_c)^{-q};
        # the inverse biases by (k/k_c)^{+q} (k_c r_c)^{+q})
        pre = (np.exp(bias * ((j - j_c) * dln + offset)) if inverse
               else np.exp(-bias * (j - j_c) * dln))
        a = a * _const(pre, a)
    u = _fht_coeff(n, dln, mu, offset, bias, inverse)
    with np.errstate(invalid="ignore", divide="ignore"):
        mult = (1.0 / np.conj(u)) if inverse else u
    X = rfft(a, axis=-1)                         # (..., n//2+1, 2)
    Y = cmul_t4(X, _const(to_t4(mult), X))
    y = torch.flip(irfft(Y, n, axis=-1, interleaved=True), (-1,))
    if bias != 0:
        post = (np.exp(bias * (j - j_c) * dln) if inverse
                else np.exp(-bias * ((j - j_c) * dln + offset)))
        y = y * _const(post, y)
    return y


def fht(a, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0):
    """Fast Hankel transform of a logarithmically spaced periodic sequence
    over the last axis (FFTLog algorithm; scipy.fft.fht semantics).  Runs
    as bias-table multiply -> rfft plan -> kernel-coefficient complex
    multiply -> irfft plan -> flip, all on the input's device."""
    return _fht_core(a, dln, mu, offset, bias, inverse=False)


def ifht(A, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0):
    """Inverse fast Hankel transform (scipy.fft.ifht semantics): the
    inverse of :func:`fht`, dividing the spectrum by conj(u)."""
    return _fht_core(A, dln, mu, offset, bias, inverse=True)


def fhtoffset(dln: float, mu: float, initial: float = 0.0,
              bias: float = 0.0) -> float:
    """Optimal low-ringing offset for :func:`fht`
    (scipy.fft.fhtoffset semantics; Hamilton 2000 eq. 20)."""
    loggamma, _ = _fht_special()
    lnkr, q = float(initial), float(bias)
    xp_ = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi / (2 * float(dln))
    arg = ((_LN2 - lnkr) / float(dln)
           + (loggamma(xp_ + 1j * y).imag + loggamma(xm + 1j * y).imag)
           / np.pi)
    return lnkr + (arg - np.round(arg)) * float(dln)


# ---------------------------------------------------------------- utilities

def fftfreq(n: int, d: float = 1.0):
    return np.fft.fftfreq(n, d)


def rfftfreq(n: int, d: float = 1.0):
    return np.fft.rfftfreq(n, d)


def _shift(x, axes, sign: int, interleaved):
    """An integer tensor keeps its dtype (a roll moves any dtype); anything
    else enters as float32, complex arrays interleaved."""
    if _is_complex(x):
        x = asinterleaved(x, interleaved)
    elif not isinstance(x, torch.Tensor) or x.is_floating_point():
        x = _f32(x)
    # same heuristic as asinterleaved: a 1-D length-2 real vector is DATA,
    # not an interleaved scalar
    comp = x.ndim >= 2 and x.shape[-1] == 2 and interleaved is not False
    nd = x.ndim - (1 if comp else 0)
    axes = _axes_list(nd, axes, True)
    shifts = [(x.shape[a] // 2) * (1 if sign > 0 else -1) for a in axes]
    return torch.roll(x, shifts, axes) if axes else x


def fftshift(x, axes=None, *, interleaved: Optional[bool] = None):
    """Shift the zero-frequency bin to the center (complex axes only:
    the trailing component dim of interleaved arrays is never shifted)."""
    return _shift(x, axes, 1, interleaved)


def ifftshift(x, axes=None, *, interleaved: Optional[bool] = None):
    return _shift(x, axes, -1, interleaved)


def next_fast_len(n: int) -> int:
    """Smallest radix-supported (smooth) length >= n
    (scipy.fft.next_fast_len analog over the package's radix set)."""
    return factors.next_smooth_at_least(max(int(n), 1))


# ---------------------------------------------------------------------------
# Lomb-Scargle periodogram (unevenly-sampled spectral estimation)
# ---------------------------------------------------------------------------

def lombscargle(x, y, freqs, *, precenter: bool = False,
                normalize=False, weights=None,
                floating_mean: bool = False):
    """Lomb-Scargle periodogram of UNEVENLY sampled data
    (scipy.signal.lombscargle semantics, including the generalized
    weighted / floating-mean form and the three ``normalize`` modes).

    The (nsamples, nfreqs) trig grids are host f64 tables (large phases
    w*t destroy f32 trig); every reduction over samples runs on the device
    as a broadcast multiply and a sum, which is full float32 whatever the
    caller's TF32 matmul flag says (no matmul is involved); the tau
    rotation reuses the same grids through the angle-addition identity
    instead of a second trig evaluation.  ``normalize='amplitude'`` returns
    the best-fit complex amplitudes as an interleaved (nfreqs, 2) tensor
    (``ascomplex`` for a complex array); other modes return (nfreqs,)
    real power.
    """
    dev = _device_of(x, y, freqs, weights)
    x = np.asarray(_to_numpy(x), dtype=np.float64)
    y_in = y
    freqs = np.asarray(_to_numpy(freqs), dtype=np.float64)
    if weights is None:
        w_np = np.ones(x.shape, dtype=np.float64)
    else:
        w_np = np.asarray(_to_numpy(weights), dtype=np.float64)
    if not (x.ndim == 1 and x.size > 0
            and x.shape == tuple(getattr(y_in, "shape", None) or np.shape(y_in))
            == w_np.shape):
        raise PlanError("x, y, weights must be 1-D arrays of equal "
                        "non-zero length")
    if freqs.ndim != 1 or freqs.size == 0:
        raise PlanError("freqs must be a non-empty 1-D array")
    if not (np.all(w_np >= 0) and w_np.sum() > 0):
        raise PlanError("weights must be non-negative and sum > 0")
    if isinstance(normalize, bool):
        normalize = "normalize" if normalize else "power"
    if normalize not in ("power", "normalize", "amplitude"):
        raise PlanError("normalize must be False/'power', "
                        "True/'normalize', or 'amplitude'")
    w_np = w_np / w_np.sum()

    y = _f32(y_in, dev)
    if precenter:
        y = y - y.mean()
    wj = _const(w_np, y)
    if floating_mean:
        # the floating-mean model is shift-invariant in y, so centering
        # by the weighted mean changes nothing mathematically, but it
        # makes Y ~ 0, removing the f32 cancellation in YC - Y*C
        y = y - (wj * y).sum()
    wy = wj * y

    # host f64 trig tables of the phase grid (N, F)
    phase = x[:, None] * freqs[None, :]
    C = _const(np.cos(phase), y)
    S = _const(np.sin(phase), y)

    def wdot(v, M):
        return (v[:, None] * M).sum(dim=0)

    Y = wy.sum()
    CC = wdot(wj, C * C)
    CS = wdot(wj, C * S)
    SS = 1.0 - CC
    if floating_mean:
        Cm = wdot(wj, C)
        Sm = wdot(wj, S)
        CC = CC - Cm * Cm
        SS = SS - Sm * Sm
        CS = CS - Cm * Sm
    tau = 0.5 * torch.atan2(2.0 * CS, CC - SS)
    ct, st = torch.cos(tau), torch.sin(tau)
    # angle addition: cos(p - tau), sin(p - tau) from the same tables
    Ct = C * ct + S * st
    St = S * ct - C * st
    if floating_mean:
        Cm = wdot(wj, Ct)
        Sm = wdot(wj, St)
        # YC - Y*Cm == Sum wy (Ct - Cm) exactly; the centered form avoids
        # the subtraction of two separately-rounded reductions
        YC = wdot(wy, Ct - Cm)
        YS = wdot(wy, St - Sm)
        # centered second moments Sum w (Ct - Cm)^2: algebraically equal
        # to CC - Cm^2 but free of its f32 cancellation where the
        # variance is small (low-frequency bins)
        CC = wdot(wj, (Ct - Cm) ** 2)
        SS = wdot(wj, (St - Sm) ** 2)
    else:
        YC = wdot(wy, Ct)
        YS = wdot(wy, St)
        CC = wdot(wj, Ct * Ct)
        SS = 1.0 - CC
    eps = float(np.finfo(np.float32).epsneg)
    CC = CC.clamp_min(eps)
    SS = SS.clamp_min(eps)
    a = YC / CC
    b = YS / SS
    if normalize == "amplitude":
        # (a + ib) e^(i tau)
        return torch.stack([a * ct - b * st, a * st + b * ct], -1)
    pgram = 2.0 * (a * YC + b * YS)
    if normalize == "power":
        return pgram * (x.shape[0] / 4.0)
    YY = (wy * y).sum()
    if floating_mean:
        YY = YY - Y * Y
    return pgram * (0.5 / YY)


def czt_points(m: int, w=None, a=1 + 0j):
    """The m points on the spiral z-plane contour a * w^-k that
    :func:`czt` evaluates (scipy.signal.czt_points semantics; default w
    walks the unit circle)."""
    m = int(m)
    if m < 1:
        raise PlanError("Invalid number of CZT data points (m <= 0)")
    k = np.arange(m)
    a = 1.0 * a
    if w is None:
        return a * np.exp(2j * np.pi * k / m)
    return a * (1.0 * w) ** -k


def vectorstrength(events, period):
    """Vector strength of event times against one or more periods
    (scipy.signal.vectorstrength semantics): project each event onto the
    unit circle at angle 2*pi*event/period; the resultant's magnitude is
    the strength, its angle the preferred phase.  A device reduction."""
    events = _f32(events)
    period_arr = np.atleast_1d(np.asarray(_to_numpy(period),
                                          dtype=np.float64))
    if events.ndim > 1 or period_arr.ndim > 1:
        raise PlanError("events and period must be one-dimensional")
    if np.any(period_arr <= 0):
        raise PlanError("periods must be positive")
    scalar = np.ndim(period) == 0
    ang = (2 * np.pi) * events[None, :] / _const(period_arr, events)[:, None]
    re = torch.cos(ang).mean(dim=-1)
    im = torch.sin(ang).mean(dim=-1)
    strength = torch.sqrt(re * re + im * im)
    phase = torch.atan2(im, re)
    if scalar:
        return strength[0], phase[0]
    return strength, phase


def envelope(z, bp_in=(1, None), *, n_out: Optional[int] = None,
             squared: bool = False, residual: Optional[str] = "lowpass",
             axis: int = -1):
    """Bandpass envelope + residual split (scipy.signal.envelope
    semantics, mirrored structurally): real input works on the rfft
    half-spectrum with NO hermitian mirror: in-band bins are doubled
    (DC never), the band is cut out as a contiguous slice (fftshift when
    it straddles 0) and ifft'd at ``n_out`` (scipy's truncate/zero-pad
    resampling), and the residual is what remains after zeroing the band
    ('lowpass' additionally zeroes [bp1, (n+1)//2), which leaves an even
    n's Nyquist bin in the residual, scipy's quirk), rebuilt by irfft
    with the min(n, n_out)/2 bin correction.  Complex input uses the
    full spectrum with crop/split Fourier resampling.

    Runs on the plan-layer FFTs.  Returns the envelope alone for
    ``residual=None``, else the stacked ``(2, ...)`` [envelope,
    residual]; real input gives a real residual, complex input
    interleaved outputs.
    """
    if residual not in ("lowpass", "all", None):
        raise PlanError("residual must be 'lowpass', 'all' or None")
    if _is_complex(z):
        real_in = False
        x = asinterleaved(z)
        ax = axis if axis >= 0 else x.ndim - 1 + axis
        x = torch.movedim(x, ax, -2)
        n = x.shape[-2]
    else:
        real_in = True
        x = _f32(z)
        x = torch.movedim(x, axis, -1)
        n = x.shape[-1]
    bp0 = -(n // 2) if bp_in[0] is None else int(bp_in[0])
    bp1 = (n + 1) // 2 if bp_in[1] is None else int(bp_in[1])
    if not -(n // 2) <= bp0 < bp1 <= (n + 1) // 2:
        raise PlanError(f"bp_in={bp_in!r} invalid for n={n}: need "
                        f"-n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2")
    nout = int(n_out) if n_out is not None else n
    fak = nout / n
    straddle = bp0 <= 0 < bp1

    if real_in:
        Xh = rfft(x, axis=-1)                       # (..., n//2+1, 2)
        Z = _zero_pad(Xh, -2, 0, n - Xh.shape[-2])  # upper half zero
        w2 = np.ones(n, np.float32)
        if bp0 > 0:
            w2[bp0:bp1] = 2.0
        elif bp1 > 0:
            w2[1:bp1] = 2.0
        Z = Z * _const(w2[:, None], Z)
    else:
        Z = fft(x, axis=-1, interleaved=True)       # logical last axis

    # ---- envelope: contiguous band slice -> ifft at n_out
    if not straddle:
        band = Z[..., slice(bp0, bp1), :]           # python slicing
    else:
        Zs = torch.roll(Z, n // 2, -2)              # fftshift
        band = Zs[..., bp0 + n // 2:bp1 + n // 2, :]
    blen = band.shape[-2]
    if blen < nout:
        band = _zero_pad(band, -2, 0, nout - blen)
    elif blen > nout:
        band = band[..., :nout, :]
    z_bb = ifft(band, axis=-1, interleaved=True) * fak
    env = z_bb[..., 0] ** 2 + z_bb[..., 1] ** 2
    if not squared:
        env = torch.sqrt(env)
    if residual is None:
        return torch.movedim(env, -1, axis)

    # ---- residual: zero the band, then the lowpass cut
    keep = np.ones(n, np.float32)
    idx = np.arange(n)
    if not straddle:
        keep[idx[slice(bp0, bp1)]] = 0.0
    else:
        keep[:bp1] = 0.0
        keep[idx[slice(bp0, None)]] = 0.0
    if residual == "lowpass":
        if bp1 > 0:
            keep[bp1:(n + 1) // 2] = 0.0
        else:
            keep[idx[slice(bp0, None)]] = 0.0
            keep[0:(n + 1) // 2] = 0.0
    Zr = Z * _const(keep[:, None], Z)
    if real_in:
        m = min(n, nout)
        if nout != n and m % 2 == 0:
            corr = np.ones(n, np.float32)
            corr[m // 2] = 2.0 if nout < n else 0.5
            Zr = Zr * _const(corr[:, None], Zr)
        half = nout // 2 + 1
        if half <= n:
            Zh = Zr[..., :half, :]
        else:
            Zh = _zero_pad(Zr, -2, 0, half - n)
        res = irfft(Zh, n=nout, axis=-1, interleaved=True) * fak
        out = torch.stack([env, res], dim=0)
        return torch.movedim(out, -1, axis if axis < 0 else axis + 1)
    # complex residual: crop/split Fourier resampling (resample
    # domain='freq' semantics)
    if nout != n:
        bins = (np.arange(n) + n // 2) % n - n // 2
        wts = np.ones(n, np.float32)
        keepable = (bins >= -(nout // 2)) & (bins <= nout // 2)
        wts[~keepable] = 0.0
        if nout > n and n % 2 == 0:
            wts[bins == -(n // 2)] = 0.5
        Zr2 = Zr * _const(wts[:, None], Zr)
        dest = np.where(keepable, bins % nout, 0)
        src = Zr2 * _const(keepable.astype(np.float32)[:, None], Zr2)
        placed = torch.zeros_like(Zr2[..., :1, :]).expand(
            *Zr2.shape[:-2], nout, 2)
        placed = placed.index_add(
            -2, torch.as_tensor(dest, device=Zr2.device), src)
        if nout > n and n % 2 == 0:
            extra = Zr2[..., int(np.flatnonzero(bins == -(n // 2))[0]), :]
            placed = placed + _zero_pad(extra.unsqueeze(-2), -2, n // 2,
                                        nout - n // 2 - 1)
        Zr = placed * fak
    res_c = ifft(Zr, axis=-1, interleaved=True)
    out = torch.stack([torch.stack([env, torch.zeros_like(env)], -1), res_c],
                      dim=0)
    return torch.movedim(out, -2, axis - 1 if axis < 0 else axis + 1)


def _check_window_f64(window, nperseg: int) -> np.ndarray:
    """f64 window for the COLA/NOLA checks: the 1e-10 tolerances are
    finer than the f32 device window tables."""
    if isinstance(window, (str, tuple)):
        from .windows import get_window as _gw
        return np.asarray(_gw(window, nperseg), dtype=np.float64)
    win = np.asarray(_to_numpy(window), dtype=np.float64)
    if win.ndim != 1 or win.size != nperseg:
        raise PlanError("window must be 1-D with length nperseg")
    return win


def check_COLA(window, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """Constant-overlap-add check (scipy.signal.check_COLA semantics):
    the hop-shifted window copies must sum to a constant."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise PlanError("nperseg must be a positive integer")
    if not 0 <= noverlap < nperseg:
        raise PlanError("noverlap must be less than nperseg.")
    win = _check_window_f64(window, nperseg)
    step = nperseg - noverlap
    binsums = np.sum([win[ii * step:(ii + 1) * step]
                      for ii in range(nperseg // step)], axis=0)
    if nperseg % step != 0:
        binsums[:nperseg % step] += win[-(nperseg % step):]
    return bool(np.max(np.abs(binsums - np.median(binsums))) < tol)


def check_NOLA(window, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """Nonzero-overlap-add check (scipy.signal.check_NOLA semantics):
    the hop-aliased win^2 profile must stay above tol everywhere."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise PlanError("nperseg must be a positive integer")
    if not 0 <= noverlap < nperseg:
        raise PlanError("noverlap must be less than nperseg")
    win = _check_window_f64(window, nperseg)
    step = nperseg - noverlap
    w2 = win * win
    binsums = np.sum([w2[ii * step:(ii + 1) * step]
                      for ii in range(nperseg // step)], axis=0)
    if nperseg % step != 0:
        binsums[:nperseg % step] += w2[-(nperseg % step):]
    return bool(np.min(binsums) > tol)


def choose_conv_method(in1, in2, mode: str = "full",
                       measure: bool = False):
    """Pick 'fft' or 'direct' like scipy.signal.choose_conv_method.

    In this package every convolution executes through the FFT plan
    layer regardless; this exists so ported code keeps working.  The
    big-O crossover (direct n*m flops vs (n+m) log(n+m)) approximates
    scipy's fitted constants; exact-integer inputs always pick 'direct'
    like scipy (FFT rounding would break exactness).  ``measure=True``
    times both scipy paths on the HOST oracle (the device has no direct
    path to race)."""
    x1 = _to_numpy(in1)
    x2 = _to_numpy(in2)
    if measure:
        import timeit
        from scipy.signal import convolve as _sconv
        times = {}
        for method in ("fft", "direct"):
            times[method] = timeit.timeit(
                lambda m=method: _sconv(x1, x2, mode=mode, method=m),
                number=1)
        chosen = "fft" if times["fft"] < times["direct"] else "direct"
        return chosen, times
    if x1.dtype.kind in "ui" and x2.dtype.kind in "ui" or \
            x1.dtype.kind == "b" or x2.dtype.kind == "b":
        return "direct"
    n1, n2 = x1.size, x2.size
    if n1 == 0 or n2 == 0:
        return "direct"
    big, small = max(n1, n2), min(n1, n2)
    direct_cost = big * small
    L = n1 + n2
    fft_cost = 6.0 * L * np.log2(max(L, 2))
    return "fft" if direct_cost > fft_cost else "direct"


class CZT:
    """Precomputed chirp z-transform operator
    (scipy.signal.CZT semantics): ``CZT(n, m, w, a)(x)`` evaluates the
    length-n transform at m spiral points; plans build once per input
    shape through the package's plan cache."""

    def __init__(self, n: int, m: Optional[int] = None, w=None,
                 a=1 + 0j):
        self.n = int(n)
        if self.n < 1:
            raise PlanError("Invalid number of CZT data points (n <= 0)")
        self.m = self.n if m is None else int(m)
        if self.m < 1:
            raise PlanError("Invalid number of CZT output points (m <= 0)")
        self.w = w
        self.a = a

    def __call__(self, x, *, axis: int = -1):
        return czt(x, self.m, self.w, self.a, axis=axis)

    def points(self) -> np.ndarray:
        """The spiral evaluation points (scipy.signal.CZT.points)."""
        return czt_points(self.m, self.w, self.a)


class ZoomFFT(CZT):
    """Precomputed zoom-FFT operator (scipy.signal.ZoomFFT semantics):
    band [f1, f2] of the length-n spectrum at m points."""

    def __init__(self, n: int, fn, m: Optional[int] = None, *,
                 fs: float = 2, endpoint: bool = False):
        n = int(n)
        fn_arr = np.atleast_1d(np.asarray(fn, dtype=np.float64))
        if fn_arr.size == 2:
            f1, f2 = float(fn_arr[0]), float(fn_arr[1])
        elif fn_arr.size == 1:
            f1, f2 = 0.0, float(fn_arr[0])
        else:
            raise PlanError("fn must be a scalar or a length-2 sequence")
        self.f1, self.f2, self.fs = f1, f2, float(fs)
        m = n if m is None else int(m)
        scale = ((f2 - f1) * m) / (self.fs * (m - 1)) if endpoint \
            else (f2 - f1) / self.fs
        a = np.exp(2j * np.pi * f1 / self.fs)
        wp = np.exp(-2j * np.pi * scale / m)
        super().__init__(n, m=m, w=wp, a=a)


# the modern STFT class lives in shorttime.py (late import: it builds on
# this module's framing/transform machinery)
from .shorttime import ShortTimeFFT, closest_STFT_dual_window  # noqa: E402


def prev_fast_len(n: int, real: bool = False) -> int:
    """Largest radix-supported (smooth) length <= n
    (scipy.fft.prev_fast_len analog over the package's radix set:
    like :func:`next_fast_len`, sizes are plan-fast lengths here, which
    include 13; ``real`` is accepted for signature parity, the r2c path
    supports the same set)."""
    n = int(n)
    if n < 1:
        raise PlanError("n must be a positive integer")
    m = n
    while m > 1 and not factors.is_smooth(m):
        m -= 1
    return m


def hfft2(x, s=None, axes=(-2, -1), norm=None, *,
          interleaved: Optional[bool] = None):
    """2-D FFT of a Hermitian-symmetric (real-spectrum) signal
    (scipy.fft.hfft2 semantics).  Returns a real tensor."""
    return hfftn(x, s=s, axes=axes, norm=norm, interleaved=interleaved)


def ihfft2(x, s=None, axes=(-2, -1), norm=None):
    """Inverse of :func:`hfft2` (scipy.fft.ihfft2)."""
    return ihfftn(x, s=s, axes=axes, norm=norm)


def hfftn(x, s=None, axes=None, norm=None, *,
          interleaved: Optional[bool] = None):
    """N-D Hermitian FFT: the real spectrum of a Hermitian-symmetric
    complex signal (scipy.fft.hfftn semantics): irfftn of the
    conjugate, scaled by the norm-mode factor."""
    z = asinterleaved(x, interleaved)
    # scipy rejects duplicate axes for the hermitian family (irfftn
    # underneath would follow numpy's transform-per-occurrence instead);
    # this also validates the range and the s-vs-rank length
    ax_list = _axes_list(z.ndim - 1, axes, True, s=s)
    y = irfftn(_conj(z), s=s, axes=ax_list, norm="backward",
               interleaved=True)
    # total length along the transformed axes of the OUTPUT
    N = 1
    for a in ax_list:
        N *= y.shape[a]
    if norm in (None, "backward"):
        return y * float(N)
    if norm == "ortho":
        return y * math.sqrt(N)
    if norm == "forward":
        return y
    raise PlanError(f"invalid norm {norm!r}")


def ihfftn(x, s=None, axes=None, norm=None):
    """Inverse N-D Hermitian FFT (scipy.fft.ihfftn semantics):
    conj(rfftn(x)) with the inverse norm factor.  Returns interleaved
    (..., 2)."""
    xr = _f32(x)
    # scipy rejects duplicate axes here (rfftn underneath follows numpy);
    # resolve -1 entries in s against the input BEFORE the norm divisor
    ax_list = _axes_list(xr.ndim, axes, True, s=s)
    if s is not None:
        s = _resolve_s(xr, tuple(s), ax_list)
    Y = rfftn(xr, s=s, axes=ax_list, norm="backward")
    N = 1
    for pos, a in enumerate(ax_list):
        N *= int(s[pos]) if s is not None else xr.shape[a]
    if norm in (None, "backward"):
        fac = 1.0 / N
    elif norm == "ortho":
        fac = 1.0 / math.sqrt(N)
    elif norm == "forward":
        fac = 1.0
    else:
        raise PlanError(f"invalid norm {norm!r}")
    return _conj(Y) * fac


# ------------------------------------------------- scipy.fft compat shims

class _WorkersCtx:
    def __init__(self, n):
        self._n = n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def set_workers(workers: int):
    """scipy.fft.set_workers-compatible context manager.  A plan is one
    stream of device work, so the worker count is accepted and ignored."""
    return _WorkersCtx(int(workers))


def get_workers() -> int:
    """scipy.fft.get_workers analog: the plan layer presents a single
    logical execution stream."""
    return 1


def set_backend(backend, coerce: bool = False, only: bool = False):
    """scipy.fft.set_backend-compatible no-op context manager: this
    package has exactly one FFT backend (its plan layer)."""
    return _WorkersCtx(0)


def skip_backend(backend):
    """scipy.fft.skip_backend-compatible no-op context manager."""
    return _WorkersCtx(0)


def set_global_backend(backend, coerce=False, only=False,
                       try_last=False):
    """scipy.fft.set_global_backend analog: accepted and ignored (one
    backend exists)."""


def register_backend(backend):
    """scipy.fft.register_backend analog: accepted and ignored."""


# ------------------------- oracle signature compatibility (kwargs shims)

def _oracle_kwargs(fn, npos: int):
    """Widen a transform's signature with the oracle libraries' control
    kwargs so mechanically migrated scipy.fft / numpy.fft call sites run
    unmodified: ``overwrite_x`` and ``workers`` are accepted and ignored
    (the plan layer never mutates inputs and owns its own parallelism,
    the same policy as the uarray backend, scipy_backend.py), positionally
    too, in scipy.fft's layout, where they sit right after the ``npos``
    leading params (x/n-or-s/axis-or-axes/norm, plus type for the trig
    family).  A non-None ``plan`` raises scipy.fft's own
    NotImplementedError; a non-None ``out`` raises NotImplementedError
    (outputs are fresh device tensors; numpy.fft's out= contract cannot be
    honored silently)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, overwrite_x: bool = False, workers=None,
                plan=None, out=None, **kwargs):
        if len(args) > npos:
            extra = args[npos:]
            if len(extra) > 2:
                raise TypeError(
                    f"{fn.__name__}() takes at most {npos + 2} "
                    f"positional arguments but {len(args)} were given")
            overwrite_x = extra[0]          # scipy.fft positional layout
            if len(extra) == 2:
                workers = extra[1]
            args = args[:npos]
        if plan is not None:
            raise NotImplementedError(
                "Passing a precomputed plan is not yet supported by "
                "scipy.fft functions")
        if out is not None:
            raise NotImplementedError(
                "out= is not supported: transform outputs are device "
                "tensors and cannot alias a caller-provided buffer")
        del overwrite_x, workers
        return fn(*args, **kwargs)

    return wrapper


for _name in ("fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
              "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
              "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn"):
    globals()[_name] = _oracle_kwargs(globals()[_name], npos=4)
for _name in ("dct", "idct", "dst", "idst",
              "dctn", "idctn", "dstn", "idstn"):
    globals()[_name] = _oracle_kwargs(globals()[_name], npos=5)
del _name
