"""scipy.fft uarray backend: dispatch ``scipy.fft.*`` onto this package.
Port of ``webgpufft_tpu/scipy_backend.py``.

scipy.fft routes every transform through a uarray multimethod layer
(scipy/fft/_backend.py) so third-party libraries can take over the
implementation.  This module implements that protocol for the plan layer,
giving scipy users a zero-code-change migration path::

    import scipy.fft as sf
    import webgpufft_tpu_torch as W

    with sf.set_backend(W.scipy_fft_backend()):
        Y = sf.fft(x)                # numpy in and out, transform on the GPU

    W.install_scipy_fft_backend()    # or permanently, for a process
    Y = sf.rfftn(vol)                # every scipy.fft call dispatches here
    W.uninstall_scipy_fft_backend()  # restore scipy's own implementation

All 28 scipy.fft multimethods (fft/ifft families incl. Hermitian, the
dct/dst families with ``orthogonalize``, and fht/ifht) are served by
``webgpufft_tpu_torch.fftapi``.  ``overwrite_x`` and ``workers`` are
accepted and ignored (the plan layer never mutates inputs and has no host
thread pool); a non-None precomputed ``plan`` argument makes the call fall
back to scipy (uarray ``NotImplemented``), as does any argument combination
the facade rejects.

Semantics notes:

- The device is taken when the backend is made: ``device=None`` (the
  default) means the facade's default device at call time (``"cuda"``,
  which raises without a GPU, unless a ``fftapi.default_device`` block is
  active); ``device="cpu"`` runs the kernels' plain versions.
- Outputs are numpy arrays by default (``as_numpy=True``), complex64 /
  float32: the compute path is f32, so results carry float32 rounding
  against scipy's f64.  Pass ``as_numpy=False`` to receive the facade's
  native outputs instead: tensors on the device, with complex-valued
  transforms in the interleaved (..., 2) float32 layout.
- The backend is stateless and thread-safe apart from the facade's
  process-global device block; plans are cached in the package's default
  plan cache.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import numpy as np

from . import fftapi
from .spec import PlanError

__all__ = [
    "ScipyFftBackend",
    "scipy_fft_backend",
    "install_scipy_fft_backend",
    "uninstall_scipy_fft_backend",
]

# scipy.fft multimethods whose mathematical result is complex-valued;
# the facade returns these interleaved (..., 2) f32 and the backend
# repacks them as complex64 (scipy's contract is a complex ndarray).
_COMPLEX_OUT = fftapi.COMPLEX_VALUED_FFTS

# Accepted-and-ignored scipy parameters: the plan layer never mutates
# its inputs (overwrite_x) and has no host thread pool (workers).
_IGNORED = ("overwrite_x", "workers")


class ScipyFftBackend:
    """uarray backend object for the ``numpy.scipy.fft`` domain."""

    __ua_domain__ = "numpy.scipy.fft"

    def __init__(self, as_numpy: bool = True, device=None):
        self._as_numpy = bool(as_numpy)
        self._device = device
        self._adapters: Dict[str, Any] = {}

    # -- uarray protocol ------------------------------------------------

    def __ua_convert__(self, dispatchables, coerce):
        # The facade accepts numpy/array-like inputs directly, so
        # conversion is a pass-through; refuse only marker types we do
        # not recognize (uarray then tries the next backend).
        out = []
        for d in dispatchables:
            if d.type in (np.ndarray, np.dtype) or d.value is None:
                out.append(d.value)
            elif coerce and d.coercible:
                out.append(d.value)
            else:
                return NotImplemented
        return out

    def __ua_function__(self, method, args, kwargs):
        name = getattr(method, "__name__", None)
        fn = getattr(fftapi, name, None) if name else None
        if fn is None:
            return NotImplemented
        adapter = self._adapters.get(name)
        if adapter is None:
            try:
                adapter = inspect.signature(method)
            except (TypeError, ValueError):  # no introspectable signature
                adapter = False
            self._adapters[name] = adapter
        if adapter is False:
            return NotImplemented
        try:
            bound = adapter.bind(*args, **kwargs)
        except TypeError:
            return NotImplemented
        params = dict(bound.arguments)
        if params.pop("plan", None) is not None:
            return NotImplemented          # precomputed foreign plan
        for k in _IGNORED:
            params.pop(k, None)
        axes = params.get("axes")
        if axes is not None and not isinstance(axes, (int, np.integer)):
            # normalize negatives against the array rank first so
            # mixed-sign duplicates like (1, -1) on a 2-D input are
            # caught too
            ndim = getattr(params.get("x"), "ndim", None)
            t = tuple(a + ndim
                      if (ndim and isinstance(a, (int, np.integer)) and a < 0)
                      else a for a in axes)
            if len(set(t)) != len(t):
                # scipy raises on duplicate axes; the facade follows
                # numpy (transform per occurrence) — decline so scipy's
                # own validation surfaces
                return NotImplemented
        try:
            if self._device is None:
                out = fn(**params)
            else:
                with fftapi.default_device(self._device):
                    out = fn(**params)
        except PlanError:
            return NotImplemented          # graceful fallback to scipy
        if not self._as_numpy:
            return out                     # facade-native device tensors
        if name in _COMPLEX_OUT:
            # the device path computes in f32; report that honestly
            return np.asarray(fftapi.ascomplex(out), dtype=np.complex64)
        return fftapi._to_numpy(out)


_BACKENDS: Dict[Any, ScipyFftBackend] = {}


def scipy_fft_backend(as_numpy: bool = True, device=None) -> ScipyFftBackend:
    """The process-wide backend instance (one per ``as_numpy`` flavor and
    device).

    Use with scipy's own context manager::

        with scipy.fft.set_backend(scipy_fft_backend()):
            scipy.fft.fftn(x)
    """
    key = (bool(as_numpy), None if device is None else str(device))
    b = _BACKENDS.get(key)
    if b is None:
        b = _BACKENDS[key] = ScipyFftBackend(as_numpy=as_numpy, device=device)
    return b


def install_scipy_fft_backend(*, as_numpy: bool = True, coerce: bool = False,
                              only: bool = False,
                              device=None) -> ScipyFftBackend:
    """``scipy.fft.set_global_backend`` this package for the process.

    With the defaults, scipy remains the fallback for anything the
    facade declines (``only=False``).  Returns the installed backend.
    """
    import scipy.fft as sf
    b = scipy_fft_backend(as_numpy=as_numpy, device=device)
    sf.set_global_backend(b, coerce=coerce, only=only)
    return b


def uninstall_scipy_fft_backend() -> None:
    """Restore scipy's own implementation as the global backend."""
    import scipy.fft as sf
    sf.set_global_backend("scipy")
