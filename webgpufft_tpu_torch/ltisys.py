"""scipy.signal LTI-system toolbox: representation conversions,
discretization, and simulation.

Port of ``webgpufft_tpu/ltisys.py``, the port's own copy.  Conversion and
discretization math is host float64 table precompute (matrix
exponentials, companion forms, characteristic polynomials must match
scipy to rounding), copied as it is; the SIMULATION recurrence of
lsim/dlsim (and the step/impulse responses built on them) runs on the
facade's default device (``fftapi.default_device``; ``"cuda"`` unless a
block names another), as the JAX package runs it as a ``lax.scan``.

Eager PyTorch has no device loop, and the JAX package has no associative
form of this recurrence, so ``_scan_ss`` is a loop over time steps driven
from the host: two torch calls a step (``addmv`` of the state update, which
copies its addend first, and one add into the output row), the input terms
of every step computed before the loop in two matrix products.  The loop never waits for the device (no
``.item()``, no host copy, no branch on a tensor); the one copy back is the
result.  The products run in full float32 (``core.precision.full_f32``),
as the JAX package's do.

Tuple-based scipy.signal call surface (``(num, den)``, ``(z, p, k)``,
``(A, B, C, D)``, discrete forms with a trailing ``dt``); numpy in and out;
pinned against scipy.signal and the JAX package in
tests/test_torch_ltisys.py.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from . import fftapi
from .core.precision import full_f32
from .spec import PlanError
from .iirdesign import tf2zpk, zpk2tf

__all__ = [
    "normalize", "tf2ss", "ss2tf", "zpk2ss", "ss2zpk",
    "cont2discrete", "lsim", "dlsim", "step", "impulse",
    "dstep", "dimpulse", "findfreqs", "freqs", "freqs_zpk",
    "freqresp", "bode", "dfreqresp", "dbode",
    "unique_roots", "residue", "residuez", "invres", "invresz",
    "abcd_normalize",
    "lti", "dlti", "TransferFunction", "ZerosPolesGain", "StateSpace",
    "place_poles", "BadCoefficients",
]


# ---------------------------------------------------------- normalization

def normalize(b, a):
    """Normalize a transfer function to ``a[0] == 1`` and strip leading
    numerator columns that round to zero (scipy.signal.normalize
    semantics, including the badly-conditioned warning)."""
    num = np.atleast_2d(np.asarray(b, dtype=np.float64))
    den = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if den.ndim != 1:
        raise PlanError("Denominator polynomial must be rank-1 array.")
    if num.ndim > 2:
        raise PlanError("Numerator polynomial must be rank-1 or rank-2 "
                        "array.")
    if np.all(den == 0):
        raise PlanError("Denominator must have at least one nonzero "
                        "element.")
    # strip leading zeros of the denominator
    nz = np.flatnonzero(den)
    den = den[nz[0]:]
    num = num / den[0]
    den = den / den[0]
    # strip leading near-zero numerator columns (scipy tolerance
    # atol=1e-14); warn even when the single remaining column is ~zero
    leading = 0
    for col in num.T:
        if np.allclose(col, 0, atol=1e-14):
            leading += 1
        else:
            break
    if leading > 0:
        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless", stacklevel=2)
        if leading == num.shape[1]:
            leading -= 1
        num = num[:, leading:]
    if np.ndim(b) == 1:
        num = num[0]
    return num, den


# ------------------------------------------------------------ conversions

def tf2ss(num, den):
    """Transfer function -> controller-canonical state space
    (scipy.signal.tf2ss semantics; MIMO-in-one-den rank-2 num allowed)."""
    num, den = normalize(num, den)
    num = np.atleast_2d(num)
    K = den.size
    M = num.shape[1]
    if M > K:
        raise PlanError("Improper transfer function. `num` is longer "
                        "than `den`.")
    if M == 0 or K == 0:
        return (np.zeros((0, 0)), np.zeros((0, 0)),
                np.zeros((0, 0)), np.zeros((0, 0)))
    num = np.hstack([np.zeros((num.shape[0], K - M)), num])
    D = np.atleast_2d(num[:, 0]).reshape(-1, 1)
    if K == 1:
        return (np.zeros((0, 0)), np.zeros((0, 1)),
                np.zeros((D.shape[0], 0)), D)
    A = np.vstack([-den[1:][None, :], np.eye(K - 2, K - 1)])
    B = np.eye(K - 1, 1)
    C = num[:, 1:] - np.outer(num[:, 0], den[1:])
    return A, B, C, D


def _atleast_ss(A, B, C, D):
    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    B = np.atleast_2d(np.asarray(B, dtype=np.float64))
    C = np.atleast_2d(np.asarray(C, dtype=np.float64))
    D = np.atleast_2d(np.asarray(D, dtype=np.float64))
    n = A.shape[0]
    if A.shape != (n, n):
        raise PlanError("A must be square")
    if B.shape[0] != n and B.size:
        raise PlanError("A and B must have the same number of rows")
    if C.shape[1] != n and C.size:
        raise PlanError("A and C must have the same number of columns")
    return A, B, C, D


def ss2tf(A, B, C, D, input: int = 0):
    """State space -> transfer function via the characteristic-polynomial
    identity num_k = poly(A - B C_k) + (D_k - 1) poly(A)
    (scipy.signal.ss2tf semantics)."""
    A, B, C, D = _atleast_ss(A, B, C, D)
    nin = D.shape[1]
    if input >= nin:
        raise PlanError("System does not have the input specified.")
    B = B[:, input:input + 1]
    D = D[:, input:input + 1]
    if A.size == 0:
        den = np.ones(1)
        num = D.reshape(D.shape[0], 1)
        return num, den
    den = np.poly(A)
    nout = D.shape[0]
    num = np.zeros((nout, A.shape[0] + 1))
    for k in range(nout):
        Ck = np.atleast_2d(C[k])
        num[k] = np.poly(A - B @ Ck) + (D[k, 0] - 1) * den
    return num, den


def zpk2ss(z, p, k):
    """Zero-pole-gain -> state space (via tf; scipy.signal.zpk2ss)."""
    return tf2ss(*zpk2tf(z, p, k))


def ss2zpk(A, B, C, D, input: int = 0):
    """State space -> zero-pole-gain (via tf; scipy.signal.ss2zpk).
    Single-output systems only (zpk has no output dimension)."""
    num, den = ss2tf(A, B, C, D, input=input)
    num = np.atleast_2d(num)
    if num.shape[0] != 1:
        raise PlanError("zpk form is single-output; use ss2tf for "
                        "multi-output systems")
    # normalize strips the near-zero leading numerator coefficients the
    # poly() round-trip leaves behind (scipy does the same)
    num_n, den_n = normalize(num[0], den)
    return tf2zpk(num_n, den_n)


def _system_to_ss(system):
    """Accept a continuous system tuple: (num, den), (z, p, k) or
    (A, B, C, D)."""
    if not isinstance(system, (tuple, list)):
        raise PlanError("system must be a tuple (num, den), (z, p, k) "
                        "or (A, B, C, D)")
    if len(system) == 2:
        return _atleast_ss(*tf2ss(*system))
    if len(system) == 3:
        return _atleast_ss(*zpk2ss(*system))
    if len(system) == 4:
        return _atleast_ss(*system)
    raise PlanError("system tuple must have 2 (tf), 3 (zpk) or 4 (ss) "
                    "elements")


def _dsystem_to_ss(system):
    """Discrete system tuple with trailing dt: (num, den, dt),
    (z, p, k, dt) or (A, B, C, D, dt).  Returns (A, B, C, D, dt)."""
    if not isinstance(system, (tuple, list)):
        raise PlanError("system must be a tuple ending in dt")
    if len(system) == 3:
        ss = tf2ss(system[0], system[1])
    elif len(system) == 4:
        ss = zpk2ss(system[0], system[1], system[2])
    elif len(system) == 5:
        ss = system[:4]
    else:
        raise PlanError("discrete system tuple must have 3 (tf), 4 (zpk) "
                        "or 5 (ss) elements, dt last")
    dt = float(system[-1])
    return _atleast_ss(*ss) + (dt,)


# ---------------------------------------------------------- discretization

def _c2d_ss(a, b, c, d, dt: float, method: str, alpha):
    from scipy.linalg import expm
    n = a.shape[0]
    m = b.shape[1]
    if method == "gbt":
        if alpha is None:
            raise PlanError("Alpha parameter must be specified for the "
                            "generalized bilinear transform (gbt) method")
        if not 0 <= alpha <= 1:
            raise PlanError("Alpha must be within the interval [0, 1]")
    alpha = {"bilinear": 0.5, "tustin": 0.5, "euler": 0.0,
             "forward_diff": 0.0, "backward_diff": 1.0}.get(method, alpha)
    if method in ("gbt", "bilinear", "tustin", "euler", "forward_diff",
                  "backward_diff"):
        ima = np.eye(n) - alpha * dt * a
        ad = np.linalg.solve(ima, np.eye(n) + (1.0 - alpha) * dt * a)
        bd = np.linalg.solve(ima, dt * b)
        cd = np.linalg.solve(ima.T, c.T).T
        dd = d + alpha * (c @ bd)
        return ad, bd, cd, dd
    if method == "zoh":
        em = np.zeros((n + m, n + m))
        em[:n, :n] = a * dt
        em[:n, n:] = b * dt
        ms = expm(em)
        return ms[:n, :n], ms[:n, n:], c, d
    if method == "foh":
        em = np.zeros((n + 2 * m, n + 2 * m))
        em[:n, :n] = a * dt
        em[:n, n:n + m] = b * dt
        em[n:n + m, n + m:] = np.eye(m)
        ms = expm(em)
        phi = ms[:n, :n]
        g1 = ms[:n, n:n + m]
        g2 = ms[:n, n + m:]
        ad = phi
        bd = g1 + phi @ g2 - g2
        cd = c
        dd = d + c @ g2
        return ad, bd, cd, dd
    if method == "impulse":
        if not np.allclose(d, 0):
            raise PlanError("Impulse method is only applicable to strictly "
                            "proper systems")
        ad = expm(a * dt)
        bd = ad @ b * dt
        cd = c
        dd = c @ b * dt
        return ad, bd, cd, dd
    raise PlanError(f"Unknown transformation method '{method}'")


def cont2discrete(system, dt: float, method: str = "zoh", alpha=None):
    """Discretize a continuous system (scipy.signal.cont2discrete
    semantics): tf/zpk tuples round-trip through state space; methods
    gbt / bilinear / euler / backward_diff / zoh / foh / impulse."""
    dt = float(dt)
    if len(system) == 2:
        a, b, c, d = tf2ss(*system)
        ad, bd, cd, dd = _c2d_ss(*_atleast_ss(a, b, c, d), dt, method,
                                 alpha)
        num, den = ss2tf(ad, bd, cd, dd)
        return num, den, dt
    if len(system) == 3:
        a, b, c, d = zpk2ss(*system)
        ad, bd, cd, dd = _c2d_ss(*_atleast_ss(a, b, c, d), dt, method,
                                 alpha)
        z, p, k = ss2zpk(ad, bd, cd, dd)
        return z, p, k, dt
    if len(system) == 4:
        ad, bd, cd, dd = _c2d_ss(*_atleast_ss(*system), dt, method, alpha)
        return ad, bd, cd, dd, dt
    raise PlanError("First argument must either be a tuple of 2 (tf), "
                    "3 (zpk), or 4 (ss) arrays.")


# -------------------------------------------------------------- simulation

def _scan_ss(Ad, Bd0, Bd1, x0, U) -> np.ndarray:
    """Device recurrence x[i] = Ad x[i-1] + Bd0 u[i-1] + Bd1 u[i] in
    float32 on the facade's default device, summed in the JAX package's
    order (``x @ Ad.T + u_prev @ Bd0.T + u_cur @ Bd1.T``).  U has shape
    (n_steps, m); returns xout (n_steps, n) as float64 numpy."""
    dev = fftapi._default_device()
    Uj = fftapi._f32(U, dev)
    x = fftapi._f32(x0, dev)
    A = fftapi._const(Ad, x)
    with full_f32():
        prev = Uj[:-1] @ fftapi._const(Bd0.T, x)
        cur = Uj[1:] @ fftapi._const(Bd1.T, x)
        xs = torch.empty((Uj.shape[0], x.shape[0]), dtype=torch.float32, device=dev)
        xs[0] = x
        for i in range(Uj.shape[0] - 1):
            x = torch.add(torch.addmv(prev[i], A, x), cur[i], out=xs[i + 1])
    return fftapi._to_numpy(xs).astype(np.float64)


def lsim(system, U, T, X0=None, interp: bool = True):
    """Simulate a continuous LTI system over uniformly spaced ``T``
    (scipy.signal.lsim semantics): exact matrix-exponential
    discretization on the host (FOH when ``interp`` else ZOH), then the
    state recurrence as a device scan.  Returns ``(T, yout, xout)``."""
    A, B, C, D = _system_to_ss(system)
    n = A.shape[0]
    m = B.shape[1] if B.size else 0
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    if T.ndim != 1:
        raise PlanError("T must be a rank-1 array")
    n_steps = T.size
    if n_steps < 2:
        raise PlanError("T must have at least 2 elements")
    dt = T[1] - T[0]
    if not np.allclose(np.diff(T), dt):
        raise PlanError("Time steps are not equally spaced.")
    x0 = np.zeros(n) if X0 is None else \
        np.asarray(X0, dtype=np.float64).reshape(n)
    no_input = U is None or (np.asarray(U).ndim == 0 and
                             float(np.asarray(U)) == 0.0)
    if no_input:
        U_arr = np.zeros((n_steps, max(m, 1) if m else 1))
        method = "zoh"
    else:
        U_arr = np.atleast_1d(np.asarray(U, dtype=np.float64))
        if U_arr.ndim == 1:
            U_arr = U_arr[:, None]
        if U_arr.shape[0] != n_steps:
            raise PlanError("U must have the same number of rows as "
                            "elements in T.")
        if U_arr.shape[1] != m:
            raise PlanError(f"System does not define that many inputs "
                            f"(got {U_arr.shape[1]}, expected {m})")
        method = "foh" if interp else "zoh"
    from scipy.linalg import expm
    if no_input or m == 0:
        Ad = expm(A * dt)
        Bd0 = np.zeros((n, 1))
        Bd1 = np.zeros((n, 1))
        U_run = np.zeros((n_steps, 1))
    elif method == "foh":
        # linear input interpolation: x[i] = Ad x[i-1] + (g1 - g2) u[i-1]
        # + g2 u[i], with g1/g2 the first/second integrated-exponential
        # blocks of the augmented matrix
        em = np.zeros((n + 2 * m, n + 2 * m))
        em[:n, :n] = A * dt
        em[:n, n:n + m] = B * dt
        em[n:n + m, n + m:] = np.eye(m)
        ms = expm(em)
        Ad = ms[:n, :n]
        g2 = ms[:n, n + m:]
        Bd1 = g2
        Bd0 = ms[:n, n:n + m] - g2
        U_run = U_arr
    else:
        Ad, Bd, _, _ = _c2d_ss(A, B, C, D, dt, "zoh", None)
        Bd0, Bd1 = Bd, np.zeros_like(Bd)
        U_run = U_arr
    xout = _scan_ss(Ad, Bd0, Bd1, x0, U_run)
    yout = xout @ C.T
    if m and not no_input:
        yout = yout + U_arr @ D.T
    return T, np.squeeze(yout), xout


def dlsim(system, u, t=None, x0=None):
    """Simulate a discrete LTI system (scipy.signal.dlsim semantics):
    the state recurrence runs as a device scan.  Returns
    ``(tout, yout, xout)`` (xout only for state-space input, matching
    scipy)."""
    A, B, C, D, dt = _dsystem_to_ss(system)
    n = A.shape[0]
    m = B.shape[1] if B.size else 0
    u_arr = np.atleast_1d(np.asarray(u, dtype=np.float64))
    if u_arr.ndim == 1:
        u_arr = u_arr[:, None]
    n_steps = u_arr.shape[0]
    if m and u_arr.shape[1] != m:
        raise PlanError(f"System does not define that many inputs "
                        f"(got {u_arr.shape[1]}, expected {m})")
    if t is None:
        tout = np.arange(n_steps) * dt
    else:
        tout = np.atleast_1d(np.asarray(t, dtype=np.float64))
        if tout.size != n_steps:
            raise PlanError("t must have the same length as u")
    x0v = np.zeros(n) if x0 is None else \
        np.asarray(x0, dtype=np.float64).reshape(n)
    if n == 0:
        xout = np.zeros((n_steps, 0))
        yout = u_arr @ D.T
    else:
        if m:
            B0, U_run = B, u_arr
        else:
            B0, U_run = np.zeros((n, 1)), np.zeros((n_steps, 1))
        xout = _scan_ss(A, B0, np.zeros_like(B0), x0v, U_run)
        yout = xout @ C.T + (u_arr @ D.T if m else 0.0)
    if len(system) == 5:
        return tout, yout, xout
    return tout, yout


def _default_response_times(A, n: int):
    """scipy's heuristic horizon: 7 time constants of the slowest
    (least-damped) pole, 100 points by default."""
    vals = np.linalg.eigvals(A) if A.size else np.array([-1.0])
    r = np.min(np.abs(np.real(vals)))
    if r == 0.0:
        r = 1.0
    tc = 1.0 / r
    return np.linspace(0.0, 7 * tc, n)


def step(system, X0=None, T=None, N: Optional[int] = None):
    """Unit-step response of a continuous system (scipy.signal.step
    semantics).  Returns ``(T, yout)``."""
    A, B, C, D = _system_to_ss(system)
    if N is None:
        N = 100
    if T is None:
        T = _default_response_times(A, N)
    else:
        T = np.asarray(T, dtype=np.float64)
    U = np.ones((T.size, B.shape[1] if B.size else 1))
    tout, yout, _ = lsim((A, B, C, D), U, T, X0=X0)
    return tout, yout


def impulse(system, X0=None, T=None, N: Optional[int] = None):
    """Impulse response of a continuous system (scipy.signal.impulse
    semantics: the impulse enters as initial state ``B``; ``D`` does not
    contribute).  Returns ``(T, yout)``."""
    A, B, C, D = _system_to_ss(system)
    if X0 is None:
        X = np.squeeze(B)
    else:
        X = np.squeeze(B) + np.squeeze(np.asarray(X0, dtype=np.float64))
    if N is None:
        N = 100
    if T is None:
        T = _default_response_times(A, N)
    else:
        T = np.asarray(T, dtype=np.float64)
    tout, yout, _ = lsim((A, B, C, D), None, T,
                         X0=np.atleast_1d(X) if A.size else None)
    return tout, yout


def dstep(system, x0=None, t=None, n: Optional[int] = None):
    """Step response of a discrete system (scipy.signal.dstep semantics:
    one output array per input).  Returns ``(tout, (yout, ...))``."""
    A, B, C, D, dt = _dsystem_to_ss(system)
    if n is None:
        n = 100
    if t is None:
        t = np.arange(n) * dt
    else:
        t = np.asarray(t, dtype=np.float64)
    m = B.shape[1] if B.size else 1
    youts = []
    for i in range(m):
        u = np.zeros((t.size, m))
        u[:, i] = 1.0
        out = dlsim((A, B, C, D, dt), u, t=t, x0=x0)
        youts.append(np.atleast_1d(out[1]).reshape(t.size, -1))
    return t, tuple(youts)


def dimpulse(system, x0=None, t=None, n: Optional[int] = None):
    """Impulse response of a discrete system (scipy.signal.dimpulse
    semantics).  Returns ``(tout, (yout, ...))``."""
    A, B, C, D, dt = _dsystem_to_ss(system)
    if n is None:
        n = 100
    if t is None:
        t = np.arange(n) * dt
    else:
        t = np.asarray(t, dtype=np.float64)
    m = B.shape[1] if B.size else 1
    youts = []
    for i in range(m):
        u = np.zeros((t.size, m))
        u[0, i] = 1.0
        out = dlsim((A, B, C, D, dt), u, t=t, x0=x0)
        youts.append(np.atleast_1d(out[1]).reshape(t.size, -1))
    return t, tuple(youts)


# ------------------------------------------------------ frequency response

def findfreqs(num, den, N: int, kind: str = "ba"):
    """Log-spaced frequency grid covering a system's interesting range
    (scipy.signal.findfreqs semantics, pole/zero-driven decades)."""
    if kind == "ba":
        ep = np.atleast_1d(np.roots(np.asarray(den, dtype=np.float64)))
        tz = np.atleast_1d(np.roots(np.asarray(num, dtype=np.float64)))
    elif kind == "zp":
        ep = np.atleast_1d(np.asarray(den))
        tz = np.atleast_1d(np.asarray(num))
    else:
        raise PlanError("input must be one of {'ba', 'zp'}")
    if len(ep) == 0:
        ep = np.atleast_1d(-1000.0) + 0j
    ez = np.r_[ep[ep.imag >= 0],
               tz[(np.abs(tz) < 1e5) & (tz.imag >= 0)]]
    integ = np.abs(ez) < 1e-10
    hfreq = np.round(np.log10(np.max(3 * np.abs(ez.real + integ)
                                     + 1.5 * ez.imag)) + 0.5)
    lfreq = np.round(np.log10(0.1 * np.min(np.abs((ez + integ).real)
                                           + 2 * ez.imag)) - 0.5)
    return np.logspace(lfreq, hfreq, N)


def freqs(b, a, worN: int | np.ndarray = 200, plot=None):
    """Analog filter frequency response H(jw)
    (scipy.signal.freqs semantics)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if np.ndim(worN) == 0:
        w = findfreqs(b, a, int(worN))
    else:
        w = np.atleast_1d(np.asarray(worN, dtype=np.float64))
    s = 1j * w
    h = np.polyval(b, s) / np.polyval(a, s)
    if plot is not None:
        plot(w, h)
    return w, h


def freqs_zpk(z, p, k, worN: int | np.ndarray = 200):
    """Analog zpk frequency response (scipy.signal.freqs_zpk)."""
    z = np.atleast_1d(np.asarray(z))
    p = np.atleast_1d(np.asarray(p))
    if np.ndim(worN) == 0:
        w = findfreqs(z, p, int(worN), kind="zp")
    else:
        w = np.atleast_1d(np.asarray(worN, dtype=np.float64))
    s = 1j * w
    num = np.prod(s[:, None] - z[None, :], axis=-1) if z.size else 1.0
    den = np.prod(s[:, None] - p[None, :], axis=-1) if p.size else 1.0
    return w, k * num / den


def _system_to_zpk(system):
    if len(system) == 2:
        return tf2zpk(*normalize(*system))
    if len(system) == 3:
        return system
    if len(system) == 4:
        return ss2zpk(*system)
    raise PlanError("system tuple must have 2 (tf), 3 (zpk) or 4 (ss) "
                    "elements")


def freqresp(system, w=None, n: int = 10000):
    """Continuous-system frequency response over a default log grid
    (scipy.signal.freqresp semantics; evaluation in zpk form for
    numerical range).  Returns ``(w, H)``."""
    z, p, k = _system_to_zpk(system)
    return freqs_zpk(z, p, k, worN=w if w is not None else n)


def bode(system, w=None, n: int = 100):
    """Bode magnitude/phase of a continuous system
    (scipy.signal.bode semantics: dB and unwrapped degrees)."""
    w, y = freqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.abs(y))
    phase = np.unwrap(np.angle(y)) * 180.0 / np.pi
    return w, mag, phase


def dfreqresp(system, w=None, n: int = 10000, whole: bool = False):
    """Discrete-system frequency response (scipy.signal.dfreqresp
    semantics: w in rad/SAMPLE, z = exp(j w); dt only matters for
    dbode's rad/time-unit scaling)."""
    if len(system) == 5:
        z, p, k = ss2zpk(*system[:4])
        dt = float(system[4])
    elif len(system) == 4:
        z, p, k = system[:3]
        dt = float(system[3])
    elif len(system) == 3:
        z, p, k = tf2zpk(*normalize(system[0], system[1]))
        dt = float(system[2])
    else:
        raise PlanError("discrete system tuple must have 3 (tf), 4 (zpk) "
                        "or 5 (ss) elements, dt last")
    if w is None:
        wn = np.linspace(0, 2 * np.pi if whole else np.pi, n,
                         endpoint=False)
    else:
        wn = np.atleast_1d(np.asarray(w, dtype=np.float64))
    zv = np.exp(1j * wn)
    z = np.atleast_1d(np.asarray(z))
    p = np.atleast_1d(np.asarray(p))
    num = np.prod(zv[:, None] - z[None, :], axis=-1) if z.size else 1.0
    den = np.prod(zv[:, None] - p[None, :], axis=-1) if p.size else 1.0
    return wn, k * num / den


def dbode(system, w=None, n: int = 100):
    """Bode magnitude/phase of a discrete system (scipy.signal.dbode:
    input w in rad/sample like dfreqresp; RETURNED w is rad/time-unit,
    i.e. divided by dt)."""
    dt = float(system[-1])
    wn, y = dfreqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.abs(y))
    phase = np.unwrap(np.angle(y)) * 180.0 / np.pi
    return wn / dt, mag, phase


# -------------------------------------------------------- partial fractions

def unique_roots(p, tol: float = 1e-3, rtype: str = "min"):
    """Cluster near-coincident roots (scipy.signal.unique_roots
    semantics): roots within ``tol`` merge; the representative is the
    min/max/avg of each cluster per ``rtype``."""
    if rtype in ("max", "maximum"):
        reduce_ = np.max
    elif rtype in ("min", "minimum"):
        reduce_ = np.min
    elif rtype in ("avg", "mean"):
        reduce_ = np.mean
    else:
        raise PlanError("`rtype` must be one of {'max', 'maximum', 'min', "
                        "'minimum', 'avg', 'mean'}")
    p = np.atleast_1d(np.asarray(p))
    uniq, mult = [], []
    used = np.zeros(p.size, bool)
    for i in range(p.size):
        if used[i]:
            continue
        grp = np.abs(p - p[i]) < tol
        grp &= ~used
        used |= grp
        members = p[grp]
        uniq.append(reduce_(members.real) + (1j * reduce_(members.imag)
                                             if np.iscomplexobj(p) else 0))
        mult.append(int(members.size))
    return np.asarray(uniq), np.asarray(mult, np.intp)


def _taylor_at(poly, p, order: int):
    """First ``order`` Taylor coefficients poly^{(j)}(p)/j! at p."""
    c = np.atleast_1d(np.asarray(poly, dtype=complex))
    out = np.empty(order, complex)
    fact = 1.0
    for j in range(order):
        out[j] = np.polyval(c, p) / fact
        c = np.polyder(c)
        fact *= (j + 1)
    return out


def _series_div(num_t, den_t, order: int):
    """Leading ``order`` coefficients of the Taylor quotient num/den."""
    f = np.empty(order, complex)
    for j in range(order):
        acc = num_t[j]
        for i in range(j):
            acc -= f[i] * den_t[j - i]
        f[j] = acc / den_t[0]
    return f


def _residue_core(b, a, tol, rtype):
    """Shared residue machinery: returns (residues, poles-in-order,
    direct-quotient) for b(s)/a(s).  Residue ordering per pole group is
    ascending power: r/(s-p), r/(s-p)^2, ..."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if np.all(a == 0):
        raise PlanError("Denominator `a` is zero.")
    a = np.trim_zeros(a, "f")
    b = np.trim_zeros(b, "f") if np.any(b) else np.zeros(1)
    if b.size >= a.size:
        k, b_rem = np.polydiv(b, a)
        b_rem = np.atleast_1d(b_rem)
    else:
        k, b_rem = np.zeros(0), b
    poles = np.roots(a)
    upoles, mult = unique_roots(poles, tol=tol, rtype=rtype)
    residues = []
    out_poles = []
    for idx, (p, m) in enumerate(zip(upoles, mult)):
        # denominator with this pole's factor removed, rebuilt from the
        # clustered representatives so repeated roots stay exact
        others = np.concatenate([
            np.repeat(upoles[j], mult[j])
            for j in range(upoles.size) if j != idx]) \
            if upoles.size > 1 else np.zeros(0, complex)
        q = a[0] * np.atleast_1d(np.poly(others)) if others.size \
            else np.atleast_1d(a[0] + 0j)
        num_t = _taylor_at(b_rem, p, m)
        den_t = _taylor_at(q, p, m)
        f = _series_div(num_t, den_t, m)
        # ascending power: 1/(s-p) gets f[m-1], ..., 1/(s-p)^m gets f[0]
        residues.extend(f[::-1])
        out_poles.extend([p] * m)
    return (np.asarray(residues), np.asarray(out_poles),
            np.atleast_1d(k) if k.size else np.zeros(0))


def residue(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion of b(s)/a(s)
    (scipy.signal.residue semantics: ascending powers within a repeated
    pole group, direct polynomial term ``k``)."""
    return _residue_core(b, a, tol, rtype)


def residuez(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion of b(z)/a(z) in powers of z^-1
    (scipy.signal.residuez semantics): terms r/(1 - p z^-1)^j plus a
    direct polynomial in z^-1.

    Reduction to the s-domain machinery: with w = z^-1,
    b(z)/a(z) = B(w)/A(w) where B/A are the REVERSED coefficient lists;
    each r/(1 - p w)^j term maps to r (-p)^-j / (w - 1/p)^j."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] == 0:
        raise PlanError("First coefficient of determinant `a` must be "
                        "non-zero.")
    rb, rp, rk = _residue_core(b[::-1], a[::-1], tol, rtype)
    # rp are roots in w = 1/z; z-poles are their reciprocals
    res, poles = [], []
    i = 0
    while i < rp.size:
        # group length = run of identical poles (ascending powers)
        j = i
        while j + 1 < rp.size and rp[j + 1] == rp[i]:
            j += 1
        m = j - i + 1
        pw = rp[i]
        pz = 1.0 / pw
        for t in range(m):
            power = t + 1
            res.append(rb[i + t] * (-pw) ** (-power))
            poles.append(pz)
        i = j + 1
    return (np.asarray(res), np.asarray(poles),
            rk[::-1] if rk.size else rk)


def invres(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Reassemble b(s)/a(s) from a partial-fraction expansion
    (scipy.signal.invres semantics)."""
    r = np.atleast_1d(np.asarray(r))
    p = np.atleast_1d(np.asarray(p))
    k = np.atleast_1d(np.asarray(k)) if np.size(k) else np.zeros(0)
    upoles, mult = unique_roots(p, tol=tol, rtype=rtype)
    a = np.atleast_1d(np.poly(np.concatenate(
        [np.repeat(up, m) for up, m in zip(upoles, mult)])))
    b = np.polymul(k, a) if k.size else np.zeros(1)
    i = 0
    for up, m in zip(upoles, mult):
        others = np.concatenate(
            [np.repeat(upoles[j], mult[j])
             for j in range(upoles.size) if j != upoles.tolist().index(up)]
        ) if upoles.size > 1 else np.zeros(0, complex)
        for t in range(m):
            power = t + 1
            # r/(s-up)^power contributes r * prod_others * (s-up)^(m-power)
            term = np.poly(np.concatenate(
                [others, np.repeat(up, m - power)])) if \
                (others.size or m - power) else np.ones(1)
            b = np.polyadd(b, r[i] * np.atleast_1d(term))
            i += 1
    # scipy keeps the full (possibly complex) coefficient vector —
    # no leading-zero trim, no realification
    return np.atleast_1d(b), a


def invresz(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Reassemble b(z)/a(z) from a z^-1 partial-fraction expansion
    (scipy.signal.invresz semantics)."""
    r = np.atleast_1d(np.asarray(r))
    p = np.atleast_1d(np.asarray(p))
    k = np.atleast_1d(np.asarray(k)) if np.size(k) else np.zeros(0)
    upoles, mult = unique_roots(p, tol=tol, rtype=rtype)
    # a(z^-1) = prod (1 - p z^-1)^m  -> coefficients in z^-1
    a = np.ones(1, complex)
    for up, m in zip(upoles, mult):
        for _ in range(m):
            a = np.polymul(a, np.array([1.0, -up]))
    b = np.polymul(k, a) if k.size else np.zeros(1)
    # align: k is a polynomial in z^-1 of low order; polymul in these
    # coefficient lists is already z^-1-ordered
    i = 0
    for gi, (up, m) in enumerate(zip(upoles, mult)):
        others = np.ones(1, complex)
        for j in range(upoles.size):
            if j == gi:
                continue
            for _ in range(mult[j]):
                others = np.polymul(others, np.array([1.0, -upoles[j]]))
        for t in range(m):
            power = t + 1
            term = others.copy()
            for _ in range(m - power):
                term = np.polymul(term, np.array([1.0, -up]))
            # r/(1 - up z^-1)^power: multiply out the remaining factors
            contrib = r[i] * term
            # z^-1 polynomials accumulate aligned at the CONSTANT term
            width = max(b.size, contrib.size)
            bb = np.zeros(width, complex)
            bb[:b.size] = b
            bb[:contrib.size] += contrib
            b = bb
            i += 1
    # scipy keeps the full coefficient vector (trailing zeros included)
    if not (np.iscomplexobj(np.asarray(r)) or np.iscomplexobj(
            np.asarray(p))):
        b, a = b.real, a.real
    return b, a


def abcd_normalize(A=None, B=None, C=None, D=None):
    """Fill in missing state-space matrices from the shapes of the given
    ones (scipy.signal.abcd_normalize semantics): the state dimension
    comes from A/B/C, input count from B/D, output count from C/D;
    missing matrices become zeros; inconsistent shapes raise."""
    def shape2(M):
        if M is None:
            return None
        M = np.atleast_2d(np.asarray(M, dtype=np.float64))
        if M.ndim > 2:
            raise PlanError("state-space matrices must be 2-D")
        return M
    A, B, C, D = map(shape2, (A, B, C, D))
    p = next((v for v in (
        A.shape[0] if A is not None else None,
        A.shape[1] if A is not None else None,
        B.shape[0] if B is not None else None,
        C.shape[1] if C is not None else None) if v is not None), None)
    q = next((v for v in (
        B.shape[1] if B is not None else None,
        D.shape[1] if D is not None else None) if v is not None), None)
    r = next((v for v in (
        C.shape[0] if C is not None else None,
        D.shape[0] if D is not None else None) if v is not None), None)
    if p is None or q is None or r is None:
        raise PlanError("Not enough information on the system.")
    A = np.zeros((p, p)) if A is None else A
    B = np.zeros((p, q)) if B is None else B
    C = np.zeros((r, p)) if C is None else C
    D = np.zeros((r, q)) if D is None else D
    if A.shape != (p, p) or B.shape != (p, q) or C.shape != (r, p) \
            or D.shape != (r, q):
        raise PlanError("A, B, C, D have incompatible shapes: "
                        f"{A.shape}, {B.shape}, {C.shape}, {D.shape}")
    return A, B, C, D


# ------------------------------------------------------------ LTI classes

class _LtiBase:
    """Shared machinery of the tuple-form system classes
    (scipy.signal lti/dlti semantics: ``dt is None`` means continuous;
    any other value — including True — means discrete)."""

    dt = None

    @property
    def is_discrete(self) -> bool:
        return self.dt is not None

    def _dt_tail(self):
        return () if self.dt is None else (self.dt,)

    # system-form accessors implemented by subclasses: _as_tf/_as_zpk/_as_ss

    def to_tf(self):
        num, den = self._as_tf()
        return TransferFunction(num, den, dt=self.dt)

    def to_zpk(self):
        z, p, k = self._as_zpk()
        return ZerosPolesGain(z, p, k, dt=self.dt)

    def to_ss(self):
        A, B, C, D = self._as_ss()
        return StateSpace(A, B, C, D, dt=self.dt)

    def to_discrete(self, dt: float, method: str = "zoh", alpha=None):
        if self.is_discrete:
            raise PlanError("to_discrete only applies to continuous "
                            "systems")
        out = cont2discrete(self._tuple(), dt, method=method, alpha=alpha)
        return type(self)(*out[:-1], dt=out[-1])

    @property
    def zeros(self):
        return self._as_zpk()[0]

    @property
    def poles(self):
        return self._as_zpk()[1]

    @property
    def inputs(self) -> int:
        return self._as_ss()[3].shape[1]

    @property
    def outputs(self) -> int:
        return self._as_ss()[3].shape[0]

    # ------------------------------------------------- response methods

    def freqresp(self, w=None, n: int = 10000):
        if self.is_discrete:
            return dfreqresp(self._tuple() + (self._num_dt(),), w=w, n=n)
        return freqresp(self._tuple(), w=w, n=n)

    def bode(self, w=None, n: int = 100):
        if self.is_discrete:
            return dbode(self._tuple() + (self._num_dt(),), w=w, n=n)
        return bode(self._tuple(), w=w, n=n)

    def _num_dt(self) -> float:
        return 1.0 if self.dt is True else float(self.dt)

    def step(self, X0=None, T=None, N=None, **kw):
        if self.is_discrete:
            t, ys = dstep(self._tuple() + (self._num_dt(),),
                          x0=kw.get("x0", X0), t=T,
                          n=kw.get("n", N))
            return t, ys
        return step(self._tuple(), X0=X0, T=T, N=N)

    def impulse(self, X0=None, T=None, N=None, **kw):
        if self.is_discrete:
            t, ys = dimpulse(self._tuple() + (self._num_dt(),),
                             x0=kw.get("x0", X0), t=T,
                             n=kw.get("n", N))
            return t, ys
        return impulse(self._tuple(), X0=X0, T=T, N=N)

    def output(self, U, T, X0=None):
        if self.is_discrete:
            return dlsim(self._tuple() + (self._num_dt(),), U, t=T,
                         x0=X0)
        return lsim(self._tuple(), U, T, X0=X0)

    def __repr__(self):
        kind = "dt: {!r}".format(self.dt) if self.is_discrete \
            else "continuous-time"
        return f"{type(self).__name__}({kind})"


class TransferFunction(_LtiBase):
    """Transfer-function system (scipy.signal.TransferFunction
    semantics: coefficients normalized on construction)."""

    def __init__(self, num, den, *, dt=None):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.num, self.den = normalize(num, den)
        # single-output systems keep a 1-D num (scipy flattens the
        # (1, k) row that e.g. cont2discrete's tf path produces)
        num2 = np.atleast_2d(self.num)
        if num2.shape[0] == 1:
            self.num = num2[0]
        self.dt = dt

    def _tuple(self):
        return (self.num, self.den)

    def _as_tf(self):
        return self.num, self.den

    def _as_zpk(self):
        return tf2zpk(np.atleast_1d(self.num), self.den)

    def _as_ss(self):
        return _atleast_ss(*tf2ss(self.num, self.den))

    def to_tf(self):
        return self


class ZerosPolesGain(_LtiBase):
    """Zero-pole-gain system (scipy.signal.ZerosPolesGain)."""

    def __init__(self, zeros, poles, gain, *, dt=None):
        self.zeros = np.atleast_1d(np.asarray(zeros))
        self.poles = np.atleast_1d(np.asarray(poles))
        self.gain = float(np.real(gain)) if np.isrealobj(gain) \
            else complex(gain)
        self.dt = dt

    # zeros/poles are plain attributes here
    zeros = None
    poles = None

    def _tuple(self):
        return (self.zeros, self.poles, self.gain)

    def _as_tf(self):
        return zpk2tf(self.zeros, self.poles, self.gain)

    def _as_zpk(self):
        return self.zeros, self.poles, self.gain

    def _as_ss(self):
        return _atleast_ss(*zpk2ss(self.zeros, self.poles, self.gain))

    def to_zpk(self):
        return self


class StateSpace(_LtiBase):
    """State-space system (scipy.signal.StateSpace)."""

    def __init__(self, A, B, C, D, *, dt=None):
        self.A, self.B, self.C, self.D = abcd_normalize(A, B, C, D)
        self.dt = dt

    def _tuple(self):
        return (self.A, self.B, self.C, self.D)

    def _as_tf(self):
        num, den = ss2tf(self.A, self.B, self.C, self.D)
        return np.atleast_2d(num)[0], den

    def _as_zpk(self):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ss2zpk(self.A, self.B, self.C, self.D)

    def _as_ss(self):
        return self.A, self.B, self.C, self.D

    def to_ss(self):
        return self


def _system_factory(args, dt):
    if len(args) == 2:
        return TransferFunction(*args, dt=dt)
    if len(args) == 3:
        return ZerosPolesGain(*args, dt=dt)
    if len(args) == 4:
        return StateSpace(*args, dt=dt)
    raise PlanError("needs 2 (tf), 3 (zpk) or 4 (ss) system arguments")


def lti(*system):
    """Continuous-time system factory (scipy.signal.lti semantics):
    dispatches on argument count to TransferFunction / ZerosPolesGain /
    StateSpace with ``dt=None``."""
    return _system_factory(system, None)


def dlti(*system, dt=True):
    """Discrete-time system factory (scipy.signal.dlti semantics;
    ``dt=True`` means unspecified-but-discrete)."""
    return _system_factory(system, dt)


class BadCoefficients(UserWarning):
    """Warning about badly conditioned filter coefficients
    (scipy.signal.BadCoefficients analog; raised by normalize)."""


class _Bunch:
    """Attribute bag matching scipy's place_poles return object."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __repr__(self):
        keys = ", ".join(sorted(self.__dict__))
        return f"Bunch({keys})"


def _order_complex_poles(poles: np.ndarray) -> np.ndarray:
    """scipy's pole ordering: real poles ascending first, then complex
    conjugate pairs (each pair adjacent, negative-imag first by sort);
    raises unless complex poles pair up."""
    ordered = np.sort(poles[np.isreal(poles)])
    cplx = np.sort_complex(poles[np.imag(poles) != 0])
    # multiplicity-aware pairing: each pole must pair with its adjacent
    # conjugate in the sorted order
    if cplx.size % 2:
        raise PlanError("Complex poles must come with their conjugates")
    for i in range(0, cplx.size, 2):
        if not np.isclose(cplx[i], np.conj(cplx[i + 1])):
            raise PlanError("Complex poles must come with their "
                            "conjugates")
    return np.concatenate([ordered, cplx])


def place_poles(A, B, poles, method: str = "YT", rtol: float = 1e-3,
                maxiter: int = 30):
    """Full-state-feedback pole placement: gain K with
    eig(A - B K) = poles (scipy.signal.place_poles call surface).

    SISO systems use Ackermann's formula (exact); MIMO systems solve the
    Sylvester equation A X - X Lambda = B G for a randomized real G
    (Bhattacharyya-de Souza parametrization), retrying until X is well
    conditioned.  The placed POLES match scipy's to the same rtol
    contract; the gain matrix itself is one valid member of the
    non-unique MIMO solution family and may differ from scipy's
    KNV/Tits-Yang iterate.  Returns a Bunch(gain_matrix, computed_poles,
    requested_poles, X, rtol, nb_iter)."""
    if method not in ("YT", "KNV0"):
        raise PlanError("method must be 'YT' or 'KNV0'")
    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    B = np.atleast_2d(np.asarray(B, dtype=np.float64))
    n = A.shape[0]
    if A.shape != (n, n):
        raise PlanError("A must be square")
    if B.shape[0] != n:
        raise PlanError("A and B must have the same number of rows")
    poles = np.atleast_1d(np.asarray(poles))
    if poles.size != n:
        raise PlanError("poles must have the same length as the state "
                        "dimension (A.shape[0])")
    poles = _order_complex_poles(poles)
    rankB = np.linalg.matrix_rank(B)
    if rankB == 0:
        raise PlanError("B must not be all zeros")
    vals, counts = np.unique(np.round(poles, 10), return_counts=True)
    if np.any(counts > rankB):
        raise PlanError("at most rank(B) repetitions of a pole are "
                        "placeable")
    m = B.shape[1]
    if m == 1 or rankB == 1:
        # Ackermann: K = e_n^T C^-1 phi(A) with phi the target
        # characteristic polynomial
        bvec = B[:, :1]
        C = np.hstack([np.linalg.matrix_power(A, k) @ bvec
                       for k in range(n)])
        if np.linalg.matrix_rank(C) < n:
            raise PlanError("the system is not controllable from the "
                            "given B")
        phi = np.real(np.poly(poles))
        phiA = np.zeros_like(A)
        for c in phi:
            phiA = phiA @ A + c * np.eye(n)
        krow = np.linalg.solve(C.T, np.eye(n)[:, -1]).T @ phiA
        K = np.zeros((m, n))
        # distribute onto the effective input direction
        if m == 1:
            K[0] = krow
        else:
            # rank-1 B: write B = b u^T, place through the range
            u, s, vt = np.linalg.svd(B)
            bvec = u[:, :1] * s[0]
            C = np.hstack([np.linalg.matrix_power(A, k) @ bvec
                           for k in range(n)])
            krow = np.linalg.solve(C.T, np.eye(n)[:, -1]).T @ phiA
            K = vt[:1].T @ krow[None, :]
        X = np.eye(n)
        nb_iter = 0
    else:
        # real block-diagonal Lambda: 2x2 blocks for conjugate pairs
        Lam = np.zeros((n, n))
        i = 0
        for p in poles:
            if np.imag(p) == 0:
                Lam[i, i] = np.real(p)
                i += 1
            elif np.imag(p) < 0:
                re, im = np.real(p), np.imag(p)
                Lam[i, i] = Lam[i + 1, i + 1] = re
                Lam[i, i + 1] = -im
                Lam[i + 1, i] = im
                i += 2
        from scipy.linalg import solve_sylvester
        rng = np.random.default_rng(0)
        best = None
        nb_iter = 0
        for it in range(int(maxiter)):
            nb_iter = it + 1
            G = rng.standard_normal((m, n))
            try:
                X = solve_sylvester(A, -Lam, -B @ G)
            except Exception:
                continue
            cond = np.linalg.cond(X)
            if best is None or cond < best[0]:
                best = (cond, X, G)
            if cond < 1e6:
                break
        if best is None:
            raise PlanError("pole placement failed: could not solve the "
                            "Sylvester parametrization")
        _, X, G = best
        # A X - X Lam = -B G  =>  eig(A + B G X^-1) = Lam
        # => K = -G X^-1 so that eig(A - B K) = Lam
        K = -np.real(G @ np.linalg.inv(X))
    computed = np.linalg.eigvals(A - B @ K)
    computed = _order_complex_poles(
        np.where(np.abs(np.imag(computed)) < 1e-10,
                 np.real(computed) + 0j, computed))
    # rtol contract: relative mismatch of placed poles, aligned in one
    # consistent sort order (sort_complex for BOTH diff and denominator)
    comp_s = np.sort_complex(computed)
    req_s = np.sort_complex(poles)
    denom = np.where(np.abs(req_s) > 0, np.abs(req_s), 1.0)
    achieved_rtol = float(np.max(np.abs(comp_s - req_s) / denom))
    return _Bunch(gain_matrix=np.atleast_2d(K),
                  computed_poles=computed,
                  requested_poles=poles,
                  X=X, rtol=achieved_rtol, nb_iter=nb_iter)
