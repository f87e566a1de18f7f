"""torch.fft-compatible namespace over the plan layer, native to torch.

Mirrors ``torch.fft``'s call conventions (``dim=`` instead of numpy's
``axis=``, ``s=``/``n=``, norm strings) while computing through
``webgpufft_tpu_torch.fftapi``, so torch code migrates by switching one
import::

    # before                      # after
    import torch.fft as tfft      from webgpufft_tpu_torch import torch_fft as tfft
    Y = tfft.rfftn(x)             Y = tfft.rfftn(x)

The JAX package's bridge of the same name crosses the host and cuts
gradients.  This one does neither: tensors stay on their own device (a
CUDA tensor launches the package's CUDA kernels, a CPU tensor runs their
plain versions), complex64 tensors enter and leave as views
(``torch.view_as_real`` / ``torch.view_as_complex``), and
``torch.autograd.grad`` and ``torch.func.grad`` flow through every
function here, because a plan's backward is the adjoint launch of the same
kernel.

The compute path is float32: complex128 / float64 inputs are cast down and
results are ``complex64`` for complex-valued transforms and ``float32``
otherwise.  A real tensor given to a complex transform is real data
whatever its trailing dim (torch has no interleaved convention).  Repeated
dims raise, as in torch.  The full torch.fft surface is covered:
fft/ifft/fft2/ifft2/fftn/ifftn, rfft/irfft (+2/n), hfft/ihfft (+2/n),
fftfreq/rfftfreq, fftshift/ifftshift.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import fftapi
from .spec import PlanError

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_COMPLEX_OUT = fftapi.COMPLEX_VALUED_FFTS
# transforms whose INPUT is real (everything else takes complex data)
_REAL_IN = frozenset({"rfft", "rfft2", "rfftn", "ihfft", "ihfft2", "ihfftn"})


def _call(name: str, input, **kw):
    """Run the facade function on a tensor: complex input as an interleaved
    view, real input marked as real data; complex results as a complex64
    view of the interleaved output."""
    if not isinstance(input, torch.Tensor):
        raise TypeError(f"{name}(): input must be a torch.Tensor, "
                        f"got {type(input).__name__}")
    fn = getattr(fftapi, name)
    if name in _REAL_IN:
        if input.is_complex():
            raise PlanError(f"{name} expects a real input tensor, "
                            f"got {input.dtype}")
        y = fn(input, **kw)
    elif input.is_complex():
        y = fn(fftapi.asinterleaved(input), interleaved=True, **kw)
    else:
        y = fn(input, interleaved=False, **kw)
    if name in _COMPLEX_OUT:
        st = y.stride()
        if st[-1] != 1 or any(v % 2 for v in st[:-1]):
            y = y.contiguous()
        return torch.view_as_complex(y)
    return y


def _wrap1(name: str):
    def f(input, n: Optional[int] = None, dim: int = -1,
          norm: Optional[str] = None):
        return _call(name, input, n=n, axis=dim, norm=norm)

    f.__name__ = name
    f.__qualname__ = name
    f.__doc__ = (f"``{name}`` of ``torch.fft``, computed by "
                 f"webgpufft_tpu_torch.fftapi.{name} (dim= maps to axis=).")
    return f


def _wrapn(name: str, default_dim):
    def f(input, s: Optional[Sequence[int]] = None, dim=default_dim,
          norm: Optional[str] = None):
        if dim is not None and not isinstance(dim, int):
            # torch rejects repeated dims ("FFT dims must be unique")
            # where the facade follows numpy (transform per occurrence)
            nd = getattr(input, "ndim", 0)
            t = tuple(d + nd if d < 0 else d for d in dim)
            if len(set(t)) != len(t):
                raise PlanError("FFT dims must be unique")
        return _call(name, input, s=s, axes=dim, norm=norm)

    f.__name__ = name
    f.__qualname__ = name
    f.__doc__ = (f"``{name}`` of ``torch.fft``, computed by "
                 f"webgpufft_tpu_torch.fftapi.{name} (dim= maps to axes=).")
    return f


fft = _wrap1("fft")
ifft = _wrap1("ifft")
rfft = _wrap1("rfft")
irfft = _wrap1("irfft")
hfft = _wrap1("hfft")
ihfft = _wrap1("ihfft")

fft2 = _wrapn("fft2", (-2, -1))
ifft2 = _wrapn("ifft2", (-2, -1))
rfft2 = _wrapn("rfft2", (-2, -1))
irfft2 = _wrapn("irfft2", (-2, -1))
hfft2 = _wrapn("hfft2", (-2, -1))
ihfft2 = _wrapn("ihfft2", (-2, -1))

fftn = _wrapn("fftn", None)
ifftn = _wrapn("ifftn", None)
rfftn = _wrapn("rfftn", None)
irfftn = _wrapn("irfftn", None)
hfftn = _wrapn("hfftn", None)
ihfftn = _wrapn("ihfftn", None)


def _freq_factory(vals, *, out, dtype, layout, device, requires_grad):
    if out is not None:
        raise TypeError("out= is not supported by this namespace")
    if layout is not None and layout != torch.strided:
        raise TypeError("only torch.strided layout is supported")
    t = torch.from_numpy(np.array(vals, dtype=np.float32))
    t = t.to(dtype=dtype or torch.float32, device=device or "cpu")
    if requires_grad:
        t.requires_grad_(True)
    return t


def fftfreq(n: int, d: float = 1.0, *, out=None, dtype=None, layout=None,
            device=None, requires_grad: bool = False):
    """``fftfreq`` of ``torch.fft`` (sample frequencies), incl. the factory kwargs."""
    return _freq_factory(fftapi.fftfreq(n, d), out=out, dtype=dtype,
                         layout=layout, device=device,
                         requires_grad=requires_grad)


def rfftfreq(n: int, d: float = 1.0, *, out=None, dtype=None, layout=None,
             device=None, requires_grad: bool = False):
    """``rfftfreq`` of ``torch.fft`` (one-sided sample frequencies)."""
    return _freq_factory(fftapi.rfftfreq(n, d), out=out, dtype=dtype,
                         layout=layout, device=device,
                         requires_grad=requires_grad)


def _roll(input, dim, sign: int):
    x = input if isinstance(input, torch.Tensor) else torch.as_tensor(input)
    dims = tuple(range(x.ndim)) if dim is None else (
        (dim,) if isinstance(dim, int) else tuple(dim))
    return torch.roll(x, [sign * (x.shape[d] // 2) for d in dims], dims)


def fftshift(input, dim=None):
    """``fftshift`` of ``torch.fft`` (pure index roll)."""
    return _roll(input, dim, 1)


def ifftshift(input, dim=None):
    """``ifftshift`` of ``torch.fft`` (inverse index roll)."""
    return _roll(input, dim, -1)
