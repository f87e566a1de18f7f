"""FFT-based linear algebra (scipy.linalg parity) on torch tensors: circulant
solves, Toeplitz matvecs and Toeplitz solves over the functional facade.

Port of ``webgpufft_tpu/linalg.py``.  ``solve_circulant`` diagonalizes the
circulant in Fourier space, ``matmul_toeplitz`` applies the Toeplitz
operator through its circulant embedding, and ``solve_toeplitz`` keeps
scipy's semantics with a Gohberg-Semencul factorization: Levinson runs once
on the host (float64, operator data only) to give the two inverse
generators, and every right-hand side is then four triangular-Toeplitz
convolutions, four batched length-p facade transforms (K1 on a CUDA tensor).

Design split, as in the JAX package.  The OPERATOR data (circulant kernel c,
Toeplitz column/row) is usually concrete: its spectrum, the near-singularity
decision and the reciprocal tables are computed on the host in float64 (the
division 1/fc amplifies f32 spectrum error near small bins) and reach the
device through ``fftapi._const`` only.  The DATA path (b, x) runs through the
facade's transforms on the data's device (a tensor where it lives, anything
else on the facade's default device) and may be differentiated.  There is
no device matmul: the only ``@`` is the host Levinson loop.

What the JAX package calls traced is, here, a tensor that ``radix.tracked``
reports (something differentiates or batches through it): such an operator
takes the device-f32 path where the JAX package has one (``matmul_toeplitz``)
and is refused where it has none (``solve_circulant``, ``solve_toeplitz``,
``PlanError``).  Any other operator takes the host-f64 path; a CUDA tensor is
copied to the host for it, as ``np.asarray`` copies a concrete JAX array.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fftapi
from .core import radix
from .spec import PlanError

__all__ = ["solve_circulant", "matmul_toeplitz", "solve_toeplitz"]


def _is_traced(x) -> bool:
    """The port's rule for the JAX package's traced operands (module
    docstring)."""
    return isinstance(x, torch.Tensor) and radix.tracked(x)


def _host(a) -> np.ndarray:
    """An operand as a host numpy array of its own dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().resolve_conj().cpu().numpy()
    return np.asarray(a)


def _data(a):
    """A data operand: a tensor stays where it lives, anything else becomes
    numpy (at least 1-D, as in the JAX package)."""
    if isinstance(a, torch.Tensor):
        return a if a.ndim else a.reshape(1)
    return np.atleast_1d(np.asarray(a))


def _finite(a) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.isfinite(a).all())
    return bool(np.isfinite(a).all())


def _interleaved(a, device: torch.device) -> torch.Tensor:
    """A data operand as an interleaved (..., 2) float32 tensor on
    ``device``: complex data keeps its imaginary part, real data gets a zero
    one (a trailing length-2 axis is never read as re/im)."""
    return fftapi.asinterleaved(a, None if fftapi._is_complex(a) else False, device=device)


def _axis_len(name: str, a, axis: int) -> int:
    try:
        return a.shape[axis]
    except IndexError:
        raise ValueError(f"'{name}axis' entry is out of bounds") from None


def _cmul_table(zi: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Interleaved (..., n, 2) times a broadcastable host complex table
    (..., n): (a+ib)(c+id) with the table's re/im expanded."""
    tr = fftapi._const(np.real(table), zi)[..., None]
    ti = fftapi._const(np.imag(table), zi)[..., None]
    re, im = zi[..., :1], zi[..., 1:]
    return torch.cat([re * tr - im * ti, re * ti + im * tr], dim=-1)


def solve_circulant(c, b, singular: str = "raise", tol=None,
                    caxis: int = -1, baxis: int = 0, outaxis: int = 0):
    """Solve C x = b where C = circulant(c), by Fourier diagonalization
    (scipy.linalg.solve_circulant semantics: same broadcasting over
    ``caxis``/``baxis``/``outaxis``, the matrix_rank-style default tol,
    and ``singular='raise'|'lstsq'``; scipy _basic.py:solve_circulant).

    ``c`` must not be tracked (the near-singularity decision is data-
    dependent); its spectrum and the reciprocal table compute on the host
    in f64.  ``b`` may be complex or real (a real ``b`` means a real
    system; a trailing length-2 axis is never read as re/im) and may be
    differentiated.  Returns a real float32 tensor when both inputs are
    real, else interleaved (..., 2) with the mode axis at ``outaxis``."""
    if _is_traced(c):
        raise PlanError(
            "solve_circulant needs concrete c (the near-singular "
            "decision is data-dependent); only b may be traced")
    if singular not in ("raise", "lstsq"):
        raise ValueError(f"singular option {singular!r} not supported")
    operands = (c, b)
    c = np.atleast_1d(_host(c))
    b = _data(b)
    nc = _axis_len("c", c, caxis)
    nb = _axis_len("b", b, baxis)
    if nc != nb:
        raise ValueError(
            f"Shapes of c {c.shape} and b {tuple(b.shape)} are "
            "incompatible")

    complex_b = fftapi._is_complex(b)
    # host-f64 operator spectrum + scipy's near-singularity policy
    fc = np.fft.fft(np.moveaxis(c.astype(
        np.complex128 if np.iscomplexobj(c) else np.float64), caxis, -1),
        axis=-1)
    abs_fc = np.abs(fc)
    if tol is None:
        tol = abs_fc.max(axis=-1) * nc * np.finfo(np.float64).eps
        tol = np.asarray(tol)[..., None] if np.ndim(tol) else np.atleast_1d(tol)
    near_zeros = abs_fc <= tol
    if np.any(near_zeros):
        if singular == "raise":
            raise np.linalg.LinAlgError("near singular circulant matrix.")
        fc[near_zeros] = 1.0
    inv_fc = 1.0 / fc
    if np.any(near_zeros):
        inv_fc[near_zeros] = 0.0             # q = fb * 0 == scipy's q[mask]=0

    # device data path, the solve axis before the component pair
    bi = _interleaved(b, fftapi._device_of(*operands))
    fb = fftapi.fft(torch.movedim(bi, baxis % b.ndim, -2), interleaved=True)
    q = _cmul_table(fb, inv_fc)
    x = fftapi.ifft(q, interleaved=True)

    complex_out = complex_b or np.iscomplexobj(c)
    if not complex_out:
        x = x[..., 0]                        # real system: drop imag
        if outaxis != -1:
            x = torch.movedim(x, -1, outaxis)
        return x
    if outaxis != -1:
        lnd = x.ndim - 1                     # logical rank (sans re/im)
        dest = outaxis + lnd if outaxis < 0 else outaxis
        if not 0 <= dest < lnd:
            raise np.exceptions.AxisError(outaxis, lnd)
        x = torch.movedim(x, -2, dest)
    return x


def matmul_toeplitz(c_or_cr, x, check_finite: bool = False, workers=None):
    """Toeplitz matrix-vector/matrix product via circulant embedding
    (scipy.linalg.matmul_toeplitz semantics: ``c_or_cr`` is the first
    column c or the tuple (c, r); a bare c implies r = conj(c); r[0]
    is ignored in favor of c[0]; scipy _basic.py:_matmul_toepltiz).

    ``x``: (n_cols,) or (n_cols, m); returns (n_rows,) or (n_rows, m).
    Real in, real out (f32); complex operands/data return interleaved
    (..., 2).  A tracked operator takes the device path in f32 (and
    differentiates); ``workers`` is accepted for signature parity and
    ignored."""
    if isinstance(c_or_cr, tuple):
        c, r = c_or_cr
    else:
        c = c_or_cr
        r = c.conj() if _is_traced(c) else np.conjugate(_host(c))
    operands = (c, r, x)
    traced_op = _is_traced(c) or _is_traced(r)
    if not traced_op:
        c, r = np.atleast_1d(_host(c)), np.atleast_1d(_host(r))
    if c.ndim != 1 or r.ndim != 1:
        raise ValueError("c and r must be one-dimensional")
    if c.shape[0] == 0 or r.shape[0] == 0:
        raise ValueError("c and r must be nonempty")
    if check_finite and not traced_op:
        if not (np.isfinite(c).all() and np.isfinite(r).all()):
            raise ValueError("array must not contain infs or NaNs")

    n_rows, n_cols = int(c.shape[0]), int(r.shape[0])
    p = n_rows + n_cols - 1

    x = x if isinstance(x, torch.Tensor) else np.asarray(x)
    complex_any = (fftapi._is_complex(c) or fftapi._is_complex(r)
                   or fftapi._is_complex(x))
    one_d = x.ndim == 1
    if x.ndim not in (1, 2):
        raise PlanError(
            f"x must be 1-D or 2-D, got shape {tuple(x.shape)}")
    if x.shape[0] != n_cols:
        raise ValueError(
            f"x has {x.shape[0]} rows but the Toeplitz operator has "
            f"{n_cols} columns")
    if check_finite and not _is_traced(x) and not _finite(x):
        raise ValueError("array must not contain infs or NaNs")

    # data path: conv axis before the component pair
    device = fftapi._device_of(*operands)
    fx = fftapi.fft(torch.movedim(_interleaved(x, device), 0, -2), n=p,
                    interleaved=True)           # (..., p, 2)
    if not traced_op:
        # circulant embedding spectrum on the host in f64
        dt = np.complex128 if complex_any else np.float64
        femb = np.fft.fft(np.concatenate((c.astype(dt), r[-1:0:-1].astype(dt))))
        prod = _cmul_table(fx, femb)
    else:
        ci, ri = _interleaved(c, device), _interleaved(r, device)
        emb = torch.cat([ci, torch.flip(ri[1:], (0,))])
        fe = fftapi.fft(emb, interleaved=True)
        re, im = fx[..., :1], fx[..., 1:]
        er, ei = fe[..., :1], fe[..., 1:]
        prod = torch.cat([re * er - im * ei, re * ei + im * er], dim=-1)
    y = fftapi.ifft(prod, interleaved=True)[..., :n_rows, :]
    if not complex_any:
        y = y[..., 0]
        return y if one_d else torch.movedim(y, -1, 0)
    return y if one_d else torch.movedim(y, -2, 0)


def _levinson_generators(c: np.ndarray, r: np.ndarray):
    """General (nonsymmetric) Levinson recursion on the host in
    f64/c128: returns ``u`` solving T u = e_1 and ``g`` solving
    T g = e_n for the Toeplitz matrix with first column ``c`` and first
    row ``r`` (r[0] taken from c[0]).  Raises
    ``numpy.linalg.LinAlgError('Singular principal minor')`` exactly
    where scipy's Levinson does (every leading principal minor must be
    nonsingular)."""
    n = c.shape[0]
    if c[0] == 0:
        raise np.linalg.LinAlgError("Singular principal minor")
    dt = np.complex128 if (np.iscomplexobj(c) or np.iscomplexobj(r)) \
        else np.float64
    c = c.astype(dt)
    r = r.astype(dt)
    f = np.zeros(n, dtype=dt)
    g = np.zeros(n, dtype=dt)
    f[0] = g[0] = 1.0 / c[0]
    for k in range(1, n):
        ef = c[1:k + 1][::-1] @ f[:k]        # new-last-row residual of [f;0]
        eb = r[1:k + 1] @ g[:k]              # new-first-row residual of [0;g]
        denom = 1.0 - ef * eb
        if denom == 0:
            raise np.linalg.LinAlgError("Singular principal minor")
        fk = f[:k + 1].copy()                # old [f; 0], length k+1
        f[1:k + 1] -= ef * g[:k]
        f[:k + 1] /= denom
        g[1:k + 1] = (g[:k] - eb * fk[1:]) / denom
        g[0] = -eb * fk[0] / denom
    return f, g


def solve_toeplitz(c_or_cr, b, check_finite: bool = True):
    """Solve T x = b for Toeplitz T (scipy.linalg.solve_toeplitz
    semantics: ``c_or_cr`` is the first column c or the tuple (c, r),
    bare c implies r = conj(c), r[0] is ignored in favor of c[0], b is
    (n,) or (n, m), LinAlgError('Singular principal minor') when any
    leading principal minor is singular — scipy _basic.py /
    _solve_toeplitz.pyx).

    The operator must not be tracked: the Levinson recursion producing the
    Gohberg-Semencul generators is data-dependent and runs on the host
    in f64.  ``b`` may be differentiated; the application is
        T^{-1} b = (1/u_0) [ L(u) U(g~) - L(g^) U(u^) ] b
    (u = T^{-1}e_1, g = T^{-1}e_n), evaluated as two rounds of circulant
    embedding with host-f64 spectra: four length-p facade transforms (the
    two triangular factors of each round share ONE batch-2 transform),
    batched over b's columns.  Real in, real out (f32); any complex input
    returns interleaved (..., 2)."""
    ops = c_or_cr if isinstance(c_or_cr, tuple) else (c_or_cr,)
    if any(_is_traced(v) for v in ops):
        raise PlanError(
            "solve_toeplitz needs a concrete operator (the Levinson "
            "generators are data-dependent); only b may be traced")
    operands = (*ops, b)
    if isinstance(c_or_cr, tuple):
        c = np.atleast_1d(_host(c_or_cr[0]))
        r = np.atleast_1d(_host(c_or_cr[1]))
    else:
        c = np.atleast_1d(_host(c_or_cr))
        r = np.conjugate(c)
    b = _data(b)
    if c.ndim != 1 or r.ndim != 1 or c.shape[0] != r.shape[0] \
            or b.shape[0] != c.shape[0] or b.ndim not in (1, 2):
        raise ValueError("Incompatible dimensions.")
    if check_finite:
        if not (np.isfinite(c).all() and np.isfinite(r).all()):
            raise ValueError("array must not contain infs or NaNs")
        if not _is_traced(b) and not _finite(b):
            raise ValueError("array must not contain infs or NaNs")
    n = int(c.shape[0])
    complex_op = bool(np.iscomplexobj(c) or np.iscomplexobj(r))
    complex_out = complex_op or fftapi._is_complex(b)
    one_d = b.ndim == 1
    device = fftapi._device_of(*operands)

    if n == 0 or (not one_d and b.shape[1] == 0):
        # scipy returns the empty solution for empty systems / RHS sets
        shape = tuple(b.shape) + ((2,) if complex_out else ())
        return torch.zeros(shape, dtype=torch.float32, device=device)

    u, g = _levinson_generators(c, r)
    p = fftapi.next_fast_len(2 * n - 1)

    def _tri_spectrum(col, row):
        """Host-f64 length-p spectrum of the circulant embedding of the
        triangular Toeplitz with first column ``col`` / first row
        ``row`` (matmul_toeplitz's concat(c, r[-1:0:-1]) convention)."""
        emb = np.zeros(p, dtype=np.complex128)
        emb[:n] = col
        if n > 1:
            emb[p - (n - 1):] = row[-1:0:-1]
        return np.fft.fft(emb)

    zeros = np.zeros(n)
    inv_u0 = 1.0 / u[0]
    f1 = _tri_spectrum(u, np.r_[u[0], zeros[1:]]) * inv_u0   # L(u)/u0
    f2 = _tri_spectrum(np.r_[g[-1], zeros[1:]], g[::-1])     # U(g~)
    f3 = _tri_spectrum(np.r_[0.0, g[:-1]], zeros) * inv_u0   # L(g^)/u0
    f4 = _tri_spectrum(zeros, np.r_[0.0, u[:0:-1]])          # U(u^)

    # data path: solve axis before the component pair, (..., p, 2) throughout
    fb = fftapi.fft(torch.movedim(_interleaved(b, device), 0, -2), n=p,
                    interleaved=True)
    # both pairs ride ONE batch-2 transform each (a leading pair axis):
    # 4 transforms in all instead of 6
    nd = fb.ndim - 2                     # extra batch dims beyond (p, 2)

    def _pair(ta, tb):
        return np.stack([ta, tb]).reshape((2,) + (1,) * nd + (p,))

    z = fftapi.ifft(_cmul_table(fb[None], _pair(f2, f4)), interleaved=True)
    # truncate to the n valid rows, then the outer triangular pass
    mask = fftapi._const(np.concatenate([np.ones(n), np.zeros(p - n)]), z)[..., None]
    fz = fftapi.fft(z * mask, interleaved=True)
    spec = _cmul_table(fz, _pair(f1, -f3)).sum(dim=0)
    x = fftapi.ifft(spec, interleaved=True)[..., :n, :]

    if not complex_out:
        x = x[..., 0]
        return x if one_d else torch.movedim(x, -1, 0)
    return x if one_d else torch.movedim(x, -2, 0)
