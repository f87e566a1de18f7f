"""IIR filter design (scipy.signal semantics): host-side table math.

Port of ``webgpufft_tpu/iirdesign.py``, the port's own copy (the JAX
package's module imports no JAX, but the port imports nothing of it).
Classical analog-prototype design: Butterworth / Chebyshev I + II /
elliptic / Bessel lowpass prototypes in zpk form, frequency transforms,
bilinear discretization, and conversions (tf / zpk / sos), plus the
order-selection helpers.  Everything here is pure host numpy: filters
are COEFFICIENT TABLES, like the window and twiddle tables elsewhere in
the package; the device work happens when the result is applied.

Pinned function-by-function against scipy.signal and the JAX package in
tests/test_torch_iirdesign.py (the classical formulas follow Orfanidis'
lecture notes and Parks-Burrus; where scipy makes a discretionary choice
(sos pole-zero pairing order, band-stop edge optimization) the same
choice is made so arrays match, not just responses).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .spec import PlanError

__all__ = [
    "butter", "cheby1", "cheby2", "ellip", "bessel", "iirfilter",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "buttord", "cheb1ord", "cheb2ord", "ellipord",
    "bilinear", "bilinear_zpk",
    "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk",
    "lp2lp", "lp2hp", "lp2bp", "lp2bs", "band_stop_obj",
    "zpk2tf", "tf2zpk", "zpk2sos", "sos2zpk", "sos2tf", "tf2sos",
    "iirnotch", "iirpeak", "iircomb", "iirdesign", "gammatone",
]


def _pow10m1(x: float) -> float:
    """10**x - 1, accurate near zero."""
    return math.expm1(x * math.log(10))


# ----------------------------------------------------- analog prototypes

def buttap(N: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """Butterworth lowpass analog prototype: N poles on the unit
    circle's left half, unit gain."""
    N = _check_order(N)
    m = np.arange(-N + 1, N, 2)
    p = -np.exp(1j * np.pi * m / (2 * N))
    return np.array([], dtype=complex), p, 1.0


def cheb1ap(N: int, rp: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Chebyshev type I prototype: ``rp`` dB passband ripple."""
    N = _check_order(N)
    if N == 0:
        return (np.array([], dtype=complex), np.array([], dtype=complex),
                10 ** (-rp / 20))
    eps = math.sqrt(_pow10m1(0.1 * rp))
    mu = math.asinh(1.0 / eps) / N
    m = np.arange(-N + 1, N, 2)
    theta = np.pi * m / (2 * N)
    p = -np.sinh(mu + 1j * theta)
    k = float(np.prod(-p).real)
    if N % 2 == 0:
        k /= math.sqrt(1 + eps * eps)
    return np.array([], dtype=complex), p, k


def cheb2ap(N: int, rs: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Chebyshev type II (inverse Chebyshev) prototype: ``rs`` dB of
    stopband attenuation, equiripple stopband."""
    N = _check_order(N)
    if N == 0:
        return (np.array([], dtype=complex), np.array([], dtype=complex),
                1.0)
    de = 1.0 / math.sqrt(_pow10m1(0.1 * rs))
    mu = math.asinh(1.0 / de) / N
    if N % 2:
        m = np.concatenate([np.arange(-N + 1, 0, 2), np.arange(2, N, 2)])
    else:
        m = np.arange(-N + 1, N, 2)
    z = -np.conjugate(1j / np.sin(m * np.pi / (2.0 * N)))
    p = -np.exp(1j * np.pi * np.arange(-N + 1, N, 2) / (2.0 * N))
    p = np.sinh(mu) * p.real + 1j * np.cosh(mu) * p.imag
    p = 1.0 / p
    k = float((np.prod(-p) / np.prod(-z)).real)
    return z, p, k


_ELLIPDEG_MMAX = 7
_ARC_JAC_SN_MAXITER = 10


def _ellip_special():
    try:
        from scipy.special import ellipj, ellipk, ellipkm1
    except ImportError as e:  # pragma: no cover
        raise PlanError("elliptic filter design needs scipy (install the "
                        "'signal' extra) for the elliptic integrals") from e
    return ellipj, ellipk, ellipkm1


def _ellipdeg(n: int, m1: float) -> float:
    """Solve the elliptic degree equation n K(m)/K'(m) = K1(m1)/K1'(m1)
    for m via nome expansion (Orfanidis eq. 49)."""
    _, ellipk, ellipkm1 = _ellip_special()
    K1 = ellipk(m1)
    K1p = ellipkm1(m1)
    q1 = np.exp(-np.pi * K1p / K1)
    q = q1 ** (1.0 / n)
    mnum = np.arange(_ELLIPDEG_MMAX + 1)
    mden = np.arange(1, _ELLIPDEG_MMAX + 2)
    num = np.sum(q ** (mnum * (mnum + 1)))
    den = 1 + 2 * np.sum(q ** (mden ** 2))
    return 16 * q * (num / den) ** 4


def _arc_jac_sn(w: complex, m: float) -> complex:
    """Inverse Jacobi sn via descending Landen transforms
    (Orfanidis eq. 56)."""
    def compl(kx):
        return ((1 - kx) * (1 + kx)) ** 0.5

    k = m ** 0.5
    if k > 1:
        return np.nan
    if k == 1:
        return np.arctanh(w)
    ks = [k]
    while ks[-1] != 0:
        k_ = ks[-1]
        ks.append((1 - compl(k_)) / (1 + compl(k_)))
        if len(ks) > _ARC_JAC_SN_MAXITER + 1:
            raise PlanError("Landen transformation not converging")
    K = float(np.prod(1 + np.array(ks[1:]))) * np.pi / 2
    wn = w
    for kn, knext in zip(ks[:-1], ks[1:]):
        wn = 2 * wn / ((1 + knext) * (1 + compl(kn * wn)))
    return K * (2 / np.pi * np.arcsin(wn))


def _arc_jac_sc1(w: float, m: float) -> float:
    """Real inverse Jacobi sc with complementary modulus:
    sc(z, m) = -i sn(i z, 1-m)."""
    zc = _arc_jac_sn(1j * w, m)
    if abs(zc.real) > 1e-14:
        raise PlanError("inverse Jacobi sc did not come out real")
    return zc.imag


def ellipap(N: int, rp: float, rs: float) \
        -> Tuple[np.ndarray, np.ndarray, float]:
    """Elliptic (Cauer) prototype: ``rp`` dB passband ripple, ``rs`` dB
    stopband attenuation, equiripple in both bands."""
    N = _check_order(N)
    if N == 0:
        return (np.array([], dtype=complex), np.array([], dtype=complex),
                10 ** (-rp / 20))
    if N == 1:
        p = -math.sqrt(1.0 / _pow10m1(0.1 * rp))
        return (np.array([], dtype=complex),
                np.array([p], dtype=complex), -p)
    ellipj, ellipk, _ = _ellip_special()
    eps_sq = _pow10m1(0.1 * rp)
    eps = math.sqrt(eps_sq)
    ck1_sq = eps_sq / _pow10m1(0.1 * rs)
    if ck1_sq == 0:
        raise PlanError("cannot design an elliptic filter with the given "
                        "rp and rs")
    capk1 = ellipk(ck1_sq)
    m = _ellipdeg(N, ck1_sq)
    capk = ellipk(m)
    j = np.arange(1 - N % 2, N, 2)
    s, c, d, _ = ellipj(j * capk / N, m * np.ones(len(j)))
    tiny = 2e-16
    snew = s[np.abs(s) > tiny]
    z = 1j / (np.sqrt(m) * snew)
    z = np.concatenate([z, np.conjugate(z)])
    r = _arc_jac_sc1(1.0 / eps, ck1_sq)
    v0 = capk * r / (N * capk1)
    sv, cv, dv, _ = ellipj(v0, 1 - m)
    p = -(c * d * sv * cv + 1j * s * dv) / (1 - (d * sv) ** 2.0)
    if N % 2:
        scale = tiny * math.sqrt(float(np.sum(p * np.conjugate(p)).real))
        newp = p[np.abs(p.imag) > scale]
        p = np.concatenate([p, np.conjugate(newp)])
    else:
        p = np.concatenate([p, np.conjugate(p)])
    k = float((np.prod(-p) / np.prod(-z)).real)
    if N % 2 == 0:
        k /= math.sqrt(1 + eps_sq)
    return z, p, float(k)


def _bessel_poly_coeffs(N: int) -> np.ndarray:
    """REVERSE Bessel polynomial theta_N coefficients, highest power
    first: a_k = (2N-k)! / (2^(N-k) k! (N-k)!); its roots ARE the
    unit-delay-normalized Bessel poles."""
    out = np.empty(N + 1, dtype=np.float64)
    for k in range(N + 1):
        out[N - k] = (math.factorial(2 * N - k)
                      / (2 ** (N - k) * math.factorial(k)
                         * math.factorial(N - k)))
    return out


def besselap(N: int, norm: str = "phase") \
        -> Tuple[np.ndarray, np.ndarray, float]:
    """Bessel/Thomson prototype (scipy.signal.besselap semantics):
    maximally flat group delay.  Poles are the inverted zeros of the
    ordinary Bessel polynomial, Newton-polished from np.roots seeds;
    'phase' / 'delay' / 'mag' normalizations as in scipy."""
    N = _check_order(N)
    if N == 0:
        return np.array([], dtype=complex), np.array([], dtype=complex), 1.0
    coeffs = _bessel_poly_coeffs(N)
    p = np.roots(coeffs).astype(complex)
    # Newton polish (np.roots' companion-matrix eigenvalues drift
    # ~1e-8 by N~20)
    dcoeffs = np.polyder(coeffs)
    for _ in range(3):
        p = p - np.polyval(coeffs, p) / np.polyval(dcoeffs, p)
    a_last = math.factorial(2 * N) // (2 ** N * math.factorial(N))
    if norm in ("delay", "mag"):
        k = float(a_last)
        if norm == "mag":
            w = 1.5  # secant iteration for the -3 dB point
            for _ in range(60):
                g = abs(k / np.prod(1j * w - p)) - 1 / math.sqrt(2)
                dw = 1e-6
                gd = (abs(k / np.prod(1j * (w + dw) - p))
                      - abs(k / np.prod(1j * w - p))) / dw
                step = g / gd
                w = w - step
                if abs(step) < 1e-13:
                    break
            p = p / w
            k = float(w ** -N * a_last)
    elif norm == "phase":
        p = p * 10 ** (-math.log10(a_last) / N)
        k = 1.0
    else:
        raise PlanError("norm must be 'phase', 'delay' or 'mag'")
    return np.array([], dtype=complex), np.asarray(p, dtype=complex), k


# ----------------------------------------------------------- conversions

def zpk2tf(z, p, k) -> Tuple[np.ndarray, np.ndarray]:
    """Zeros/poles/gain -> transfer-function (b, a) polynomials."""
    z = np.atleast_1d(np.asarray(z))
    p = np.atleast_1d(np.asarray(p))
    b = np.atleast_1d(k * np.poly(z))
    a = np.atleast_1d(np.poly(p))
    return _real_if_conjugate(b, z), _real_if_conjugate(a, p)


def _real_if_conjugate(coeffs: np.ndarray, roots: np.ndarray) -> np.ndarray:
    if np.isrealobj(coeffs):
        return coeffs
    pos = np.sort_complex(roots[roots.imag > 0])
    neg = np.sort_complex(np.conjugate(roots[roots.imag < 0]))
    if len(pos) == len(neg) and np.allclose(pos, neg):
        return coeffs.real
    return coeffs


def tf2zpk(b, a) -> Tuple[np.ndarray, np.ndarray, float]:
    """Transfer function -> zeros/poles/gain (np.roots on host)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    b, a = np.trim_zeros(b, "f"), np.trim_zeros(a, "f")
    if a.size == 0 or a[0] == 0:
        raise PlanError("a must have a nonzero leading coefficient")
    k = b[0] / a[0]
    return np.roots(b / b[0]) if b.size else np.array([]), \
        np.roots(a / a[0]), float(k)


def _cplxreal(z: np.ndarray, tol: Optional[float] = None):
    """Split a conjugate-symmetric root set into (one of each conjugate
    pair, sorted by real part then |imag|) and (sorted reals)."""
    z = np.atleast_1d(z)
    if z.size == 0:
        return z, z
    if tol is None:
        tol = 100 * np.finfo((1.0 * z).dtype).eps
    z = z[np.lexsort((abs(z.imag), z.real))]
    real_mask = abs(z.imag) <= tol * abs(z)
    zr = z[real_mask].real
    z = z[~real_mask]
    if z.size == 0:
        return np.array([], dtype=complex), zr
    zp = z[z.imag > 0]
    zn = z[z.imag < 0]
    if len(zp) != len(zn):
        raise PlanError("complex roots must come in conjugate pairs")
    # within runs of equal real part, order both halves by |imag|
    same_real = np.diff(zp.real) <= tol * abs(zp[:-1])
    diffs = np.diff(np.concatenate(([0], same_real, [0])))
    for start, stop in zip(np.nonzero(diffs > 0)[0],
                           np.nonzero(diffs < 0)[0] + 1):
        zp[start:stop] = zp[start:stop][
            np.lexsort([abs(zp[start:stop].imag)])]
        zn[start:stop] = zn[start:stop][
            np.lexsort([abs(zn[start:stop].imag)])]
    if np.any(abs(zp - zn.conj()) > tol * abs(zn)):
        raise PlanError("complex roots must come in conjugate pairs")
    return (zp + zn.conj()) / 2, zr


def _nearest_idx(fro: np.ndarray, to: complex, which: str) -> int:
    order = np.argsort(np.abs(fro - to))
    if which == "any":
        return int(order[0])
    mask = np.isreal(fro[order])
    if which == "complex":
        mask = ~mask
    return int(order[np.nonzero(mask)[0][0]])


def _section_from_zpk(z, p) -> np.ndarray:
    sos = np.zeros(6)
    b, a = zpk2tf(np.asarray(z, dtype=complex),
                  np.asarray(p, dtype=complex), 1.0)
    sos[3 - len(b):3] = b
    sos[6 - len(a):6] = a
    return sos


def zpk2sos(z, p, k, pairing: Optional[str] = None,
            *, analog: bool = False) -> np.ndarray:
    """Zeros/poles/gain -> second-order sections, scipy's 'nearest'
    pairing rules (worst pole last, nearest zero paired) so the arrays
    match scipy.signal.zpk2sos, not merely the response."""
    z = np.atleast_1d(np.asarray(z, dtype=complex))
    p = np.atleast_1d(np.asarray(p, dtype=complex))
    if pairing is None:
        pairing = "minimal" if analog else "nearest"
    if pairing not in ("nearest", "keep_odd", "minimal"):
        raise PlanError("pairing must be 'nearest', 'keep_odd' or "
                        "'minimal'")
    if analog and pairing != "minimal":
        raise PlanError("analog conversion requires pairing='minimal'")
    if len(z) == len(p) == 0:
        return (np.array([[0.0, 0.0, k, 0.0, 0.0, 1.0]]) if analog
                else np.array([[k, 0.0, 0.0, 1.0, 0.0, 0.0]]))
    if pairing != "minimal":
        p = np.concatenate([p, np.zeros(max(len(z) - len(p), 0))])
        z = np.concatenate([z, np.zeros(max(len(p) - len(z), 0))])
        n_sections = (max(len(p), len(z)) + 1) // 2
        if len(p) % 2 == 1 and pairing == "nearest":
            p = np.concatenate([p, [0.0]])
            z = np.concatenate([z, [0.0]])
    else:
        if len(p) < len(z):
            raise PlanError("analog conversion needs len(p) >= len(z)")
        n_sections = (len(p) + 1) // 2
    z = np.concatenate(_cplxreal(z))
    p = np.concatenate(_cplxreal(p))
    if abs(np.imag(k)) > 0:
        raise PlanError("k must be real")
    k = float(np.real(k))

    def idx_worst(pool):
        # digital: nearest the unit circle; analog: nearest the jw axis
        return (int(np.argmin(np.abs(np.real(pool)))) if analog
                else int(np.argmin(np.abs(1 - np.abs(pool)))))

    sos = np.zeros((n_sections, 6))
    for si in range(n_sections - 1, -1, -1):
        p1_idx = idx_worst(p)
        p1 = p[p1_idx]
        p = np.delete(p, p1_idx)
        if np.isreal(p1) and np.isreal(p).sum() == 0:
            # last remaining real pole
            if pairing != "minimal":
                z1_idx = _nearest_idx(z, p1, "real")
                z1 = z[z1_idx]
                z = np.delete(z, z1_idx)
                sos[si] = _section_from_zpk([z1, 0], [p1, 0])
            elif len(z) > 0:
                z1_idx = _nearest_idx(z, p1, "real")
                z1 = z[z1_idx]
                z = np.delete(z, z1_idx)
                sos[si] = _section_from_zpk([z1], [p1])
            else:
                sos[si] = _section_from_zpk([], [p1])
        elif (len(p) + 1 == len(z) and not np.isreal(p1)
              and np.isreal(p).sum() == 1 and np.isreal(z).sum() == 1):
            # one real pole + one real zero left over an equal pool:
            # this complex pole MUST take a complex zero
            z1_idx = _nearest_idx(z, p1, "complex")
            z1 = z[z1_idx]
            z = np.delete(z, z1_idx)
            sos[si] = _section_from_zpk([z1, z1.conj()], [p1, p1.conj()])
        else:
            if np.isreal(p1):
                realidx = np.flatnonzero(np.isreal(p))
                p2_idx = realidx[idx_worst(p[realidx])]
                p2 = p[p2_idx]
                p = np.delete(p, p2_idx)
            else:
                p2 = p1.conj()
            if len(z) > 0:
                z1_idx = _nearest_idx(z, p1, "any")
                z1 = z[z1_idx]
                z = np.delete(z, z1_idx)
                if not np.isreal(z1):
                    sos[si] = _section_from_zpk([z1, z1.conj()], [p1, p2])
                elif len(z) > 0:
                    z2_idx = _nearest_idx(z, p1, "real")
                    z2 = z[z2_idx]
                    z = np.delete(z, z2_idx)
                    sos[si] = _section_from_zpk([z1, z2], [p1, p2])
                else:
                    sos[si] = _section_from_zpk([z1], [p1, p2])
            else:
                sos[si] = _section_from_zpk([], [p1, p2])
    assert len(p) == len(z) == 0
    sos[0, :3] *= k
    return sos


def sos2zpk(sos) -> Tuple[np.ndarray, np.ndarray, float]:
    """Second-order sections -> zeros/poles/gain."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    n = sos.shape[0]
    z = np.empty(2 * n, dtype=complex)
    p = np.empty(2 * n, dtype=complex)
    k = 1.0
    for i, sec in enumerate(sos):
        zi, pi, ki = tf2zpk(sec[:3], sec[3:])
        z[2 * i:2 * i + len(zi)] = zi
        z[2 * i + len(zi):2 * (i + 1)] = 0.0
        p[2 * i:2 * i + len(pi)] = pi
        p[2 * i + len(pi):2 * (i + 1)] = 0.0
        k *= ki
    return z, p, k


def sos2tf(sos) -> Tuple[np.ndarray, np.ndarray]:
    """Second-order sections -> one (b, a) polynomial pair."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    b, a = np.array([1.0]), np.array([1.0])
    for sec in sos:
        b = np.polymul(b, np.trim_zeros(sec[:3], "f"))
        a = np.polymul(a, np.trim_zeros(sec[3:], "f"))
    return b, a


def bilinear_zpk(z, p, k, fs: float) \
        -> Tuple[np.ndarray, np.ndarray, float]:
    """Tustin discretization in zpk form: s -> 2 fs (z-1)/(z+1)."""
    z = np.atleast_1d(np.asarray(z, dtype=complex))
    p = np.atleast_1d(np.asarray(p, dtype=complex))
    fs2 = 2.0 * float(fs)
    degree = _relative_degree(z, p)
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    z_d = np.append(z_d, -np.ones(degree))
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return z_d, p_d, float(k_d)


def bilinear(b, a, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """Tustin discretization on (b, a) polynomials."""
    z, p, k = tf2zpk(b, a)
    return zpk2tf(*bilinear_zpk(z, p, k, fs))


def _relative_degree(z: np.ndarray, p: np.ndarray) -> int:
    degree = len(p) - len(z)
    if degree < 0:
        raise PlanError("improper transfer function: more zeros than "
                        "poles")
    return degree


# -------------------------------------------------- frequency transforms

def lp2lp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass prototype -> lowpass at cutoff ``wo`` (zpk form)."""
    z = np.atleast_1d(np.asarray(z, dtype=complex))
    p = np.atleast_1d(np.asarray(p, dtype=complex))
    degree = _relative_degree(z, p)
    return z * wo, p * wo, float(k * wo ** degree)


def lp2hp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass prototype -> highpass at cutoff ``wo`` (zpk form)."""
    z = np.atleast_1d(np.asarray(z, dtype=complex))
    p = np.atleast_1d(np.asarray(p, dtype=complex))
    degree = _relative_degree(z, p)
    z_hp = wo / z if z.size else z
    p_hp = wo / p
    z_hp = np.append(z_hp, np.zeros(degree))
    k_hp = k * np.real(np.prod(-z) / np.prod(-p))
    return z_hp, p_hp, float(k_hp)


def lp2bp_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandpass centered at ``wo``, bandwidth
    ``bw`` (zpk form)."""
    z = np.atleast_1d(np.asarray(z, dtype=complex))
    p = np.atleast_1d(np.asarray(p, dtype=complex))
    degree = _relative_degree(z, p)
    z_lp = z * bw / 2
    p_lp = p * bw / 2
    z_bp = np.concatenate([z_lp + np.sqrt(z_lp ** 2 - wo ** 2),
                           z_lp - np.sqrt(z_lp ** 2 - wo ** 2)])
    p_bp = np.concatenate([p_lp + np.sqrt(p_lp ** 2 - wo ** 2),
                           p_lp - np.sqrt(p_lp ** 2 - wo ** 2)])
    z_bp = np.append(z_bp, np.zeros(degree))
    return z_bp, p_bp, float(k * bw ** degree)


def lp2bs_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandstop centered at ``wo``, bandwidth
    ``bw`` (zpk form)."""
    z = np.atleast_1d(np.asarray(z, dtype=complex))
    p = np.atleast_1d(np.asarray(p, dtype=complex))
    degree = _relative_degree(z, p)
    z_hp = (bw / 2) / z if z.size else z
    p_hp = (bw / 2) / p
    z_bs = np.concatenate([z_hp + np.sqrt(z_hp ** 2 - wo ** 2),
                           z_hp - np.sqrt(z_hp ** 2 - wo ** 2)])
    p_bs = np.concatenate([p_hp + np.sqrt(p_hp ** 2 - wo ** 2),
                           p_hp - np.sqrt(p_hp ** 2 - wo ** 2)])
    z_bs = np.concatenate([z_bs, np.full(degree, 1j * wo),
                           np.full(degree, -1j * wo)])
    k_bs = k * np.real(np.prod(-z) / np.prod(-p))
    return z_bs, p_bs, float(k_bs)


# --------------------------------------------------------------- designs

_BAND_ALIASES = {
    "band": "bandpass", "bandpass": "bandpass", "pass": "bandpass",
    "bp": "bandpass",
    "bs": "bandstop", "bandstop": "bandstop", "bands": "bandstop",
    "stop": "bandstop",
    "l": "lowpass", "low": "lowpass", "lowpass": "lowpass",
    "lp": "lowpass",
    "high": "highpass", "highpass": "highpass", "h": "highpass",
    "hp": "highpass",
}

_FTYPE_ALIASES = {
    "butter": "butter", "butterworth": "butter",
    "cheby1": "cheby1", "chebyshev1": "cheby1", "cheby_1": "cheby1",
    "cheby2": "cheby2", "chebyshev2": "cheby2", "cheby_2": "cheby2",
    "ellip": "ellip", "elliptic": "ellip", "cauer": "ellip",
    "bessel": "bessel", "bessel_phase": "bessel_phase",
    "bessel_delay": "bessel_delay", "bessel_mag": "bessel_mag",
}

_BESSEL_NORMS = {"bessel": "phase", "bessel_phase": "phase",
                 "bessel_delay": "delay", "bessel_mag": "mag"}


def _check_order(N) -> int:
    if abs(int(N)) != N:
        raise PlanError("filter order must be a nonnegative integer")
    return int(N)


def iirfilter(N: int, Wn, rp: Optional[float] = None,
              rs: Optional[float] = None, btype: str = "band",
              analog: bool = False, ftype: str = "butter",
              output: str = "ba", fs: Optional[float] = None):
    """IIR design given order and critical points
    (scipy.signal.iirfilter semantics): analog prototype -> frequency
    transform -> bilinear -> requested output form."""
    Wn = np.asarray(Wn, dtype=np.float64)
    if fs is not None:
        if analog:
            raise PlanError("fs cannot be specified for an analog filter")
        Wn = Wn / (fs / 2)
    if np.any(Wn <= 0):
        raise PlanError("filter critical frequencies must be positive")
    if Wn.ndim == 1 and Wn.size > 1 and not Wn[0] < Wn[1]:
        raise PlanError("Wn[0] must be less than Wn[1]")
    try:
        btype = _BAND_ALIASES[btype.lower()]
    except KeyError:
        raise PlanError(f"{btype!r} is an invalid band type") from None
    try:
        ftype = _FTYPE_ALIASES[ftype.lower()]
    except KeyError:
        raise PlanError(f"{ftype!r} is not a valid IIR filter type") \
            from None
    if output not in ("ba", "zpk", "sos"):
        raise PlanError("output must be 'ba', 'zpk' or 'sos'")
    if rp is not None and rp < 0:
        raise PlanError("passband ripple (rp) must be positive")
    if rs is not None and rs < 0:
        raise PlanError("stopband attenuation (rs) must be positive")
    if ftype == "butter":
        z, p, k = buttap(N)
    elif ftype == "cheby1":
        if rp is None:
            raise PlanError("cheby1 needs the passband ripple rp")
        z, p, k = cheb1ap(N, rp)
    elif ftype == "cheby2":
        if rs is None:
            raise PlanError("cheby2 needs the stopband attenuation rs")
        z, p, k = cheb2ap(N, rs)
    elif ftype == "ellip":
        if rp is None or rs is None:
            raise PlanError("ellip needs both rp and rs")
        z, p, k = ellipap(N, rp, rs)
    else:
        z, p, k = besselap(N, norm=_BESSEL_NORMS[ftype])
    if not analog:
        if np.any(Wn <= 0) or np.any(Wn >= 1):
            raise PlanError(
                "digital filter critical frequencies must satisfy "
                "0 < Wn < 1 (or 0 < Wn < fs/2 with fs given)")
        fs2 = 2.0
        warped = 2 * fs2 * np.tan(np.pi * Wn / fs2)
    else:
        warped = Wn
    if btype in ("lowpass", "highpass"):
        if Wn.size != 1:
            raise PlanError("lowpass/highpass needs a single critical "
                            "frequency")
        wo = float(warped)
        z, p, k = (lp2lp_zpk(z, p, k, wo) if btype == "lowpass"
                   else lp2hp_zpk(z, p, k, wo))
    else:
        if Wn.size != 2:
            raise PlanError("bandpass/bandstop needs two critical "
                            "frequencies")
        bw = float(warped[1] - warped[0])
        wo = float(np.sqrt(warped[0] * warped[1]))
        z, p, k = (lp2bp_zpk(z, p, k, wo, bw) if btype == "bandpass"
                   else lp2bs_zpk(z, p, k, wo, bw))
    if not analog:
        z, p, k = bilinear_zpk(z, p, k, fs=fs2)
    if output == "zpk":
        return z, p, k
    if output == "ba":
        return zpk2tf(z, p, k)
    return zpk2sos(z, p, k, analog=analog)


def butter(N, Wn, btype="low", analog=False, output="ba", fs=None):
    """Butterworth design (scipy.signal.butter semantics)."""
    return iirfilter(N, Wn, btype=btype, analog=analog, output=output,
                     ftype="butter", fs=fs)


def cheby1(N, rp, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev type I design (scipy.signal.cheby1 semantics)."""
    return iirfilter(N, Wn, rp=rp, btype=btype, analog=analog,
                     output=output, ftype="cheby1", fs=fs)


def cheby2(N, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev type II design (scipy.signal.cheby2 semantics)."""
    return iirfilter(N, Wn, rs=rs, btype=btype, analog=analog,
                     output=output, ftype="cheby2", fs=fs)


def ellip(N, rp, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Elliptic (Cauer) design (scipy.signal.ellip semantics)."""
    return iirfilter(N, Wn, rp=rp, rs=rs, btype=btype, analog=analog,
                     output=output, ftype="ellip", fs=fs)


def bessel(N, Wn, btype="low", analog=False, output="ba", norm="phase",
           fs=None):
    """Bessel/Thomson design (scipy.signal.bessel semantics)."""
    if norm not in ("phase", "delay", "mag"):
        raise PlanError("norm must be 'phase', 'delay' or 'mag'")
    return iirfilter(N, Wn, btype=btype, analog=analog, output=output,
                     ftype="bessel_" + norm, fs=fs)


# -------------------------------------------------------- order selection

def _validate_gpass_gstop(gpass: float, gstop: float) -> None:
    if gpass <= 0.0:
        raise PlanError("gpass should be larger than 0.0")
    if gstop <= 0.0:
        raise PlanError("gstop should be larger than 0.0")
    if gpass > gstop:
        raise PlanError("gpass should be smaller than gstop")


def _wp_ws(wp, ws, fs, analog):
    wp = np.atleast_1d(np.asarray(wp, dtype=np.float64))
    ws = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    if fs is not None:
        if analog:
            raise PlanError("fs cannot be specified for an analog filter")
        wp = 2 * wp / fs
        ws = 2 * ws / fs
    filter_type = 2 * (len(wp) - 1) + 1
    if wp[0] >= ws[0]:
        filter_type += 1
    if not analog:
        passb = np.tan(np.pi * wp / 2.0)
        stopb = np.tan(np.pi * ws / 2.0)
    else:
        passb, stopb = wp, ws
    return passb, stopb, filter_type


def _golden_min(f, a: float, b: float, xtol: float = 1e-8) -> float:
    """Bounded scalar minimization (golden section; stands in for
    scipy.optimize.fminbound in the band-stop edge search)."""
    invphi = (math.sqrt(5) - 1) / 2
    c = b - (b - a) * invphi
    d = a + (b - a) * invphi
    fc, fd = f(c), f(d)
    while abs(b - a) > xtol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - (b - a) * invphi
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + (b - a) * invphi
            fd = f(d)
    return (a + b) / 2


def _band_stop_order(wp: float, ind: int, passb: np.ndarray,
                     stopb: np.ndarray, gpass: float, gstop: float,
                     kind: str) -> float:
    """Non-integer order of an analog band-stop design with one edge
    moved to wp — the objective minimized when tightening the passband
    (scipy.signal.band_stop_obj semantics)."""
    pb = passb.copy()
    pb[ind] = wp
    nat = float(np.min(np.abs((stopb * (pb[0] - pb[1]))
                              / (stopb ** 2 - pb[0] * pb[1]))))
    GSTOP = 10 ** (0.1 * abs(gstop))
    GPASS = 10 ** (0.1 * abs(gpass))
    if kind == "butter":
        return (math.log10((GSTOP - 1.0) / (GPASS - 1.0))
                / (2 * math.log10(nat)))
    if kind == "cheby":
        return (math.acosh(math.sqrt((GSTOP - 1.0) / (GPASS - 1.0)))
                / math.acosh(nat))
    # elliptic
    _, ellipk, ellipkm1 = _ellip_special()
    arg1 = math.sqrt((10 ** (0.1 * gpass) - 1.0)
                     / (10 ** (0.1 * gstop) - 1.0))
    arg0 = 1.0 / nat
    d00, d01 = ellipk(arg0 ** 2), ellipk(1 - arg0 ** 2)
    d10, d11 = ellipk(arg1 ** 2), ellipk(1 - arg1 ** 2)
    return d00 * d11 / (d01 * d10)


def _nat_freq(passb: np.ndarray, stopb: np.ndarray, gpass: float,
              gstop: float, filter_type: int, kind: str):
    if filter_type == 1:
        nat = stopb / passb
    elif filter_type == 2:
        nat = passb / stopb
    elif filter_type == 3:
        wp0 = _golden_min(
            lambda w: _band_stop_order(w, 0, passb, stopb, gpass, gstop,
                                       kind),
            passb[0], stopb[0] - 1e-12)
        wp1 = _golden_min(
            lambda w: _band_stop_order(w, 1, passb, stopb, gpass, gstop,
                                       kind),
            stopb[1] + 1e-12, passb[1])
        passb = np.array([wp0, wp1])
        nat = ((stopb * (passb[0] - passb[1]))
               / (stopb ** 2 - passb[0] * passb[1]))
    else:
        nat = ((stopb ** 2 - passb[0] * passb[1])
               / (stopb * (passb[0] - passb[1])))
    return float(np.min(np.abs(nat))), passb


def _finish_wn(WN, analog: bool, fs: Optional[float]):
    WN = np.atleast_1d(np.asarray(WN, dtype=np.float64))
    wn = WN if analog else np.arctan(WN) * 2.0 / np.pi
    if len(wn) == 1:
        wn = wn[0]
    if fs is not None:
        wn = wn * fs / 2
    return wn


def buttord(wp, ws, gpass: float, gstop: float, analog: bool = False,
            fs: Optional[float] = None):
    """Minimum Butterworth order meeting band specs
    (scipy.signal.buttord semantics): returns (ord, wn)."""
    _validate_gpass_gstop(gpass, gstop)
    passb, stopb, ftype = _wp_ws(wp, ws, fs, analog)
    nat, passb = _nat_freq(passb, stopb, gpass, gstop, ftype, "butter")
    GSTOP = 10 ** (0.1 * abs(gstop))
    GPASS = 10 ** (0.1 * abs(gpass))
    ord_ = int(math.ceil(math.log10((GSTOP - 1.0) / (GPASS - 1.0))
                         / (2 * math.log10(nat))))
    if ord_ == 0:
        W0 = 1.0
    else:
        W0 = (GPASS - 1.0) ** (-1.0 / (2.0 * ord_))
    if ftype == 1:
        WN = W0 * passb
    elif ftype == 2:
        WN = passb / W0
    elif ftype == 3:
        discr = math.sqrt((passb[1] - passb[0]) ** 2
                          + 4 * W0 ** 2 * passb[0] * passb[1])
        WN = np.sort(np.abs(np.array(
            [((passb[1] - passb[0]) + discr) / (2 * W0),
             ((passb[1] - passb[0]) - discr) / (2 * W0)])))
    else:
        W0v = np.array([-W0, W0])
        WN = np.sort(np.abs(
            -W0v * (passb[1] - passb[0]) / 2.0
            + np.sqrt(W0v ** 2 / 4.0 * (passb[1] - passb[0]) ** 2
                      + passb[0] * passb[1])))
    return ord_, _finish_wn(WN, analog, fs)


def cheb1ord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs: Optional[float] = None):
    """Minimum Chebyshev-I order meeting band specs
    (scipy.signal.cheb1ord semantics)."""
    _validate_gpass_gstop(gpass, gstop)
    passb, stopb, ftype = _wp_ws(wp, ws, fs, analog)
    nat, passb = _nat_freq(passb, stopb, gpass, gstop, ftype, "cheby")
    GSTOP = 10 ** (0.1 * abs(gstop))
    GPASS = 10 ** (0.1 * abs(gpass))
    v = math.acosh(math.sqrt((GSTOP - 1.0) / (GPASS - 1.0)))
    ord_ = int(math.ceil(v / math.acosh(nat)))
    return ord_, _finish_wn(passb, analog, fs)


def cheb2ord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs: Optional[float] = None):
    """Minimum Chebyshev-II order meeting band specs
    (scipy.signal.cheb2ord semantics)."""
    _validate_gpass_gstop(gpass, gstop)
    passb, stopb, ftype = _wp_ws(wp, ws, fs, analog)
    nat, passb = _nat_freq(passb, stopb, gpass, gstop, ftype, "cheby")
    GSTOP = 10 ** (0.1 * abs(gstop))
    GPASS = 10 ** (0.1 * abs(gpass))
    v = math.acosh(math.sqrt((GSTOP - 1.0) / (GPASS - 1.0)))
    ord_ = int(math.ceil(v / math.acosh(nat)))
    new_freq = 1.0 / math.cosh(v / ord_)
    if ftype == 1:
        WN = passb / new_freq
    elif ftype == 2:
        WN = passb * new_freq
    elif ftype == 3:
        nat0 = (new_freq / 2.0 * (passb[0] - passb[1])
                + math.sqrt(new_freq ** 2 * (passb[1] - passb[0]) ** 2
                            / 4.0 + passb[1] * passb[0]))
        WN = np.array([nat0, passb[1] * passb[0] / nat0])
    else:
        nat0 = (1.0 / (2.0 * new_freq) * (passb[0] - passb[1])
                + math.sqrt((passb[1] - passb[0]) ** 2
                            / (4.0 * new_freq ** 2)
                            + passb[1] * passb[0]))
        WN = np.array([nat0, passb[0] * passb[1] / nat0])
    return ord_, _finish_wn(WN, analog, fs)


def ellipord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs: Optional[float] = None):
    """Minimum elliptic order meeting band specs
    (scipy.signal.ellipord semantics)."""
    _validate_gpass_gstop(gpass, gstop)
    _, ellipk, ellipkm1 = _ellip_special()
    passb, stopb, ftype = _wp_ws(wp, ws, fs, analog)
    nat, passb = _nat_freq(passb, stopb, gpass, gstop, ftype, "ellip")
    arg1_sq = _pow10m1(0.1 * gpass) / _pow10m1(0.1 * gstop)
    arg0 = 1.0 / nat
    d00, d01 = ellipk(arg0 ** 2), ellipkm1(arg0 ** 2)
    d10, d11 = ellipk(arg1_sq), ellipkm1(arg1_sq)
    ord_ = int(math.ceil(d00 * d11 / (d01 * d10)))
    return ord_, _finish_wn(passb, analog, fs)


# ----------------------------------------------------- notch / peak / comb

def _notch_peak(w0: float, Q: float, fs: float, peak: bool):
    """Second-order notch/peak biquad at -3 dB bandwidth w0/Q
    (Orfanidis ch. 11 parametric equalizer with GB = 1/sqrt(2); the
    scipy.signal.iirnotch/iirpeak designs)."""
    fs = float(fs)
    w0 = 2.0 * float(w0) / fs               # normalized (1 = Nyquist)
    if not 0 < w0 < 1:
        raise PlanError(f"w0 must lie in (0, fs/2), got {w0 * fs / 2}")
    bw = (w0 / float(Q)) * math.pi
    w0 *= math.pi
    # GB = 1/sqrt(2) makes sqrt((1-GB^2)/GB^2) == 1, so beta = tan(bw/2)
    beta = math.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    if peak:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    else:
        b = gain * np.array([1.0, -2.0 * math.cos(w0), 1.0])
    a = np.array([1.0, -2.0 * gain * math.cos(w0), 2.0 * gain - 1.0])
    return b, a


def iirnotch(w0: float, Q: float, fs: float = 2.0):
    """Second-order IIR notch filter (scipy.signal.iirnotch semantics)."""
    return _notch_peak(w0, Q, fs, peak=False)


def iirpeak(w0: float, Q: float, fs: float = 2.0):
    """Second-order IIR peaking filter (scipy.signal.iirpeak semantics)."""
    return _notch_peak(w0, Q, fs, peak=True)


def iircomb(w0: float, Q: float, ftype: str = "notch", fs: float = 2.0, *,
            pass_zero: bool = False):
    """Notching or peaking comb filter (scipy.signal.iircomb semantics):
    order-N single-repeated-pole comb, N = fs/w0 teeth (Orfanidis ch. 11
    comb design at GB = 1/sqrt(2))."""
    w0, Q, fs = float(w0), float(Q), float(fs)
    ftype = ftype.lower()
    if not 0 < w0 < fs / 2:
        raise PlanError(f"w0 must be between 0 and {fs / 2} (Nyquist), "
                        f"got {w0}")
    if ftype not in ("notch", "peak"):
        raise PlanError("ftype must be 'notch' or 'peak'")
    N = round(fs / w0)
    if abs(w0 - fs / N) / fs > 1e-14:
        raise PlanError("fs must be divisible by w0")
    wr = 2.0 * math.pi * w0 / fs
    # -3 dB bandwidth wr/Q; at GB=1/sqrt(2) the beta radical is 1
    beta = math.tan(N * (wr / Q) / 4.0)
    g0, g = (1.0, 0.0) if ftype == "notch" else (0.0, 1.0)
    ax = (1.0 - beta) / (1.0 + beta)
    bx = (g0 + g * beta) / (1.0 + beta)
    cx = (g0 - g * beta) / (1.0 + beta)
    # comb teeth on multiples of w0 need b - c z^-N over 1 - a z^-N for a
    # notch (and + for the pass_zero variants)
    sgn = -1.0 if ((ftype == "peak") == bool(pass_zero)) else 1.0
    b = np.zeros(N + 1)
    a = np.zeros(N + 1)
    b[0], b[-1] = bx, sgn * cx
    a[0], a[-1] = 1.0, sgn * ax
    return b, a


def iirdesign(wp, ws, gpass: float, gstop: float, analog: bool = False,
              ftype: str = "ellip", output: str = "ba",
              fs: Optional[float] = None):
    """Complete IIR design from band edges and gain specs
    (scipy.signal.iirdesign semantics): pick the minimum order with the
    family's *ord selector, then design at that order via iirfilter."""
    try:
        ftype_n = _FTYPE_ALIASES[ftype.lower()]
    except KeyError:
        raise PlanError(f"{ftype!r} is not a valid IIR filter type") \
            from None
    ordfunc = {"butter": buttord, "cheby1": cheb1ord,
               "cheby2": cheb2ord, "ellip": ellipord}.get(ftype_n)
    if ordfunc is None:
        raise PlanError(f"{ftype!r} does not have an order-selection rule; "
                        "use iirfilter with an explicit order")
    wp_a = np.atleast_1d(np.asarray(wp, dtype=np.float64))
    ws_a = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    if wp_a.shape != ws_a.shape or wp_a.ndim != 1 or wp_a.size not in (1, 2):
        raise PlanError("wp and ws must match with one or two elements")
    band_type = 2 * (wp_a.size - 1) + 1
    if wp_a[0] >= ws_a[0]:
        band_type += 1
    if wp_a.size == 2:
        # wp inside ws (wp[0] >= ws[0]) is a BANDPASS; wp outside is a
        # bandstop — scipy's band_type 3 is bandstop, 4 is bandpass
        if band_type == 4 and not ws_a[0] < wp_a[0] < wp_a[1] < ws_a[1]:
            raise PlanError("bandpass needs ws[0] < wp[0] < wp[1] < ws[1]")
        if band_type == 3 and not wp_a[0] < ws_a[0] < ws_a[1] < wp_a[1]:
            raise PlanError("bandstop needs wp[0] < ws[0] < ws[1] < wp[1]")
    btype = {1: "lowpass", 2: "highpass",
             3: "bandstop", 4: "bandpass"}[band_type]
    N, Wn = ordfunc(wp, ws, gpass, gstop, analog=analog, fs=fs)
    return iirfilter(N, Wn, rp=gpass, rs=gstop, btype=btype, analog=analog,
                     ftype=ftype_n, output=output, fs=fs)


def tf2sos(b, a, pairing: Optional[str] = None, *, analog: bool = False):
    """Transfer function -> second-order sections
    (scipy.signal.tf2sos semantics: factor via tf2zpk, pair via
    zpk2sos)."""
    return zpk2sos(*tf2zpk(b, a), pairing=pairing, analog=analog)


def band_stop_obj(wp, ind, passb, stopb, gpass, gstop, type):
    """Band-stop order objective (scipy.signal.band_stop_obj semantics):
    the analog filter order needed when passband edge ``ind`` moves to
    ``wp`` — the function the bandstop *ord selectors minimize."""
    return _band_stop_order(float(wp), int(ind),
                            np.asarray(passb, dtype=np.float64),
                            np.asarray(stopb, dtype=np.float64),
                            float(gpass), float(gstop), type)


def _tf_transform(b, a, zpk_fn, *args):
    """Apply a zpk-domain frequency transform to a (b, a) pair
    (scipy's lp2lp/lp2hp/lp2bp/lp2bs tf forms route through zpk here;
    coefficient agreement with scipy's direct polynomial arithmetic is
    to root-finding precision, pinned in tests)."""
    z, p, k = tf2zpk(b, a)
    z2, p2, k2 = zpk_fn(z, p, k, *args)
    return zpk2tf(z2, p2, k2)


def lp2lp(b, a, wo: float = 1.0):
    """Lowpass prototype -> lowpass at wo, tf form (scipy.signal.lp2lp)."""
    return _tf_transform(b, a, lp2lp_zpk, float(wo))


def lp2hp(b, a, wo: float = 1.0):
    """Lowpass prototype -> highpass at wo, tf form (scipy.signal.lp2hp)."""
    return _tf_transform(b, a, lp2hp_zpk, float(wo))


def lp2bp(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandpass (center wo, width bw), tf form."""
    return _tf_transform(b, a, lp2bp_zpk, float(wo), float(bw))


def lp2bs(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandstop (center wo, width bw), tf form."""
    return _tf_transform(b, a, lp2bs_zpk, float(wo), float(bw))


def _hz_to_erb(hz: float) -> float:
    """Glasberg & Moore equivalent rectangular bandwidth."""
    return hz / 9.26449 + 24.7


def gammatone(freq: float, ftype: str, order: Optional[int] = None,
              numtaps: Optional[int] = None, fs: Optional[float] = None):
    """Gammatone auditory filter (scipy.signal.gammatone semantics):
    'fir' samples the gammatone impulse response t^(n-1) e^{-2 pi b t}
    cos(2 pi f t); 'iir' is Slaney's 4th-order design collapsed to one
    (b, a) pair.  Host design tables."""
    import warnings
    import cmath
    freq = float(freq)
    fs = 2.0 if fs is None else float(fs)
    if fs <= 0:
        raise PlanError("fs must be positive")
    if not 0 < freq < fs / 2:
        raise PlanError(f"The frequency must be between 0 and {fs / 2}"
                        f" (Nyquist), but given {freq}.")
    ftype = ftype.lower()
    if ftype == "fir":
        order = 4 if order is None else int(order)
        numtaps = max(int(fs * 0.015), 15) if numtaps is None \
            else int(numtaps)
        if not 0 < order <= 24:
            raise PlanError("Invalid order: order must be > 0 and <= 24.")
        t = np.arange(numtaps) / fs
        bw = 1.019 * _hz_to_erb(freq)
        b = t ** (order - 1) * np.exp(-2 * np.pi * bw * t) \
            * np.cos(2 * np.pi * freq * t)
        scale = 2 * (2 * np.pi * bw) ** order \
            / math.factorial(order - 1) / fs
        return b * scale, np.asarray([1.0])
    if ftype != "iir":
        raise PlanError("ftype must be either fir or iir.")
    if order is not None:
        warnings.warn("order is not used for IIR gammatone filter.",
                      stacklevel=2)
    if numtaps is not None:
        warnings.warn("numtaps is not used for IIR gammatone filter.",
                      stacklevel=2)
    # Slaney (1993): the 8th-order denominator is the 4x repeated
    # complex pole pair; the gain normalizes the response at freq
    T = 1.0 / fs
    bw = 2 * math.pi * 1.019 * _hz_to_erb(freq)
    fr = 2 * freq * math.pi * T
    bwT = bw * T
    g1 = -2 * cmath.exp(2j * fr) * T
    g2 = 2 * cmath.exp(-bwT + 1j * fr) * T
    g3 = math.sqrt(3 + 2 ** 1.5) * math.sin(fr)
    g4 = math.sqrt(3 - 2 ** 1.5) * math.sin(fr)
    g5 = cmath.exp(2j * fr)
    g = (g1 + g2 * (math.cos(fr) - g4)) \
        * (g1 + g2 * (math.cos(fr) + g4)) \
        * (g1 + g2 * (math.cos(fr) - g3)) \
        * (g1 + g2 * (math.cos(fr) + g3))
    g /= (-2 / math.exp(2 * bwT) - 2 * g5
          + 2 * (1 + g5) / math.exp(bwT)) ** 4
    g = math.hypot(g.real, g.imag)
    cs = [math.cos(k * fr) for k in range(5)]
    eb = [math.exp(-k * bwT) for k in range(9)]
    b = np.array([
        T ** 4 / g,
        -4 * T ** 4 * cs[1] * eb[1] / g,
        6 * T ** 4 * cs[2] * eb[2] / g,
        -4 * T ** 4 * cs[3] * eb[3] / g,
        T ** 4 * cs[4] * eb[4] / g,
    ])
    a = np.array([
        1.0,
        -8 * cs[1] * eb[1],
        4 * (4 + 3 * cs[2]) * eb[2],
        -8 * (6 * cs[1] + cs[3]) * eb[3],
        2 * (18 + 16 * cs[2] + cs[4]) * eb[4],
        -8 * (6 * cs[1] + cs[3]) * eb[5],
        4 * (4 + 3 * cs[2]) * eb[6],
        -8 * cs[1] * eb[7],
        eb[8],
    ])
    return b, a
