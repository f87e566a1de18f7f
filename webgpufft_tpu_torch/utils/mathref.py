"""numpy reference math, copied from ``webgpufft_tpu/utils/mathref.py``.

The per-plan scale, the ND FFT oracle, the packed r2c/c2r oracles, the dense
DCT/DST matrices and their ND oracle, the FFT-convolution oracle with its
domain rule, and the direct conv2d oracle.  Host numpy only.

Array convention: a plan with logical ``shape = [N0, N1, ...]`` operates on
arrays of shape ``(batch, N0, N1, ...)`` — logical axis d is array axis 1+d.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def normalize_scale(normalize: str, direction: str, n_total: int) -> float:
    """Per-plan scale factor."""
    if normalize == "none":
        return 1.0
    if normalize == "backward":
        return 1.0 / n_total if direction == "inverse" else 1.0
    if normalize == "unitary":
        return 1.0 / math.sqrt(n_total)
    raise ValueError(f"bad normalize {normalize!r}")


def fft_nd(x: np.ndarray, shape: Sequence[int], direction: str = "forward",
           normalize: str = "none") -> np.ndarray:
    """ND FFT over logical axes (array axes 1..rank); x is (batch, *shape)."""
    rank = len(shape)
    axes = tuple(range(x.ndim - rank, x.ndim))
    if direction == "forward":
        y = np.fft.fftn(x, axes=axes, norm=None)
    elif direction == "inverse":
        y = np.fft.ifftn(x, axes=axes, norm=None) * math.prod(shape)
    else:
        raise ValueError(f"bad direction {direction!r}")
    s = normalize_scale(normalize, direction, math.prod(shape))
    return y * s if s != 1.0 else y


# ---------------------------------------------------------------------------
# Real transforms: packing along logical axis 0 (array axis 1)
# ---------------------------------------------------------------------------

def r2c_packed(x: np.ndarray, shape: Sequence[int], normalize: str = "none") -> np.ndarray:
    """Real (batch, *shape) -> packed complex (batch, floor(N0/2)+1, N1, ...).

    Packed length = floor(N0/2)+1 along logical axis 0
    (reference: docs/API.md:203-208).
    """
    rank = len(shape)
    axes = tuple(range(1, 1 + rank))
    full = np.fft.fftn(x.astype(np.complex128), axes=axes, norm=None)
    n0 = shape[0]
    packed = full[:, : n0 // 2 + 1, ...]
    s = normalize_scale(normalize, "forward", math.prod(shape))
    return packed * s if s != 1.0 else packed


def c2r_packed(xp: np.ndarray, shape: Sequence[int], normalize: str = "none") -> np.ndarray:
    """Packed complex (batch, floor(N0/2)+1, ...) -> real (batch, *shape).

    Reconstructs the Hermitian spectrum with the reference's mirror rule
    X[N-k] = conj(X[k]) along axis 0 (src/utils/math.js:260-289).
    """
    rank = len(shape)
    n0 = shape[0]
    packed_len = n0 // 2 + 1
    assert xp.shape[1] == packed_len, (xp.shape, packed_len)
    k_max_mirror = n0 // 2 - 1 if n0 % 2 == 0 else n0 // 2
    # ND Hermitian symmetry: X[(N - k) mod N] = conj(X[k]) with the index map
    # applied on EVERY axis (axis 0 flips without wrap over the mirrored
    # range; other axes flip with wrap-around, i.e. flip + roll(1)).
    mirror = np.conj(xp[:, 1:k_max_mirror + 1, ...])[:, ::-1, ...]
    for d in range(2, xp.ndim):
        mirror = np.roll(np.flip(mirror, axis=d), 1, axis=d)
    full = np.concatenate([xp, mirror], axis=1)
    assert full.shape[1] == n0
    axes = tuple(range(1, 1 + rank))
    time = np.fft.ifftn(full, axes=axes, norm=None) * math.prod(shape)
    out = np.real(time)
    s = normalize_scale(normalize, "inverse", math.prod(shape))
    return out * s if s != 1.0 else out


# ---------------------------------------------------------------------------
# DCT / DST types 1-4
# ---------------------------------------------------------------------------

def trig_matrix(kind: str, n: int, direction: str = "forward") -> np.ndarray:
    """Dense transform matrix M with out[k] = sum_n M[k, n] x[n]."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    if kind == "dct1":
        if n < 2:
            raise ValueError("dct1 requires N >= 2")
        mat = 2.0 * np.cos(np.pi * m * k / (n - 1))
        mat[:, 0] = 1.0
        mat[:, n - 1] = (-1.0) ** np.arange(n)
        return mat
    if kind == "dst1":
        return np.sin(np.pi * (m + 1) * (k + 1) / (n + 1))
    if kind == "dct4":
        return np.cos(np.pi / n * (m + 0.5) * (k + 0.5))
    if kind == "dst4":
        return np.sin(np.pi / n * (m + 0.5) * (k + 0.5))
    if kind == "dct2":
        if direction == "forward":
            return np.cos(np.pi / n * (m + 0.5) * k)
        # dct2 inverse (= DCT-III up to scale): x[n] = X[0]/2 + sum_{k>=1} ...
        inv = np.cos(np.pi / n * (k + 0.5) * m)  # out idx n (rows), in idx k (cols)
        inv[:, 0] = 0.5
        return inv
    if kind == "dst2":
        if direction == "forward":
            return np.sin(np.pi / n * (m + 0.5) * (k + 1))
        # dst2 inverse (= DST-III up to scale):
        # x[n] = 0.5*(-1)^n X[N-1] + sum_{k=0..N-2} X[k] sin(pi/N (n+1/2)(k+1))
        inv = np.sin(np.pi / n * (k + 0.5) * (m + 1))
        inv[:, n - 1] = 0.5 * (-1.0) ** np.arange(n)
        return inv
    if kind == "dct3":
        return trig_matrix("dct2", n, "inverse" if direction == "forward" else "forward")
    if kind == "dst3":
        return trig_matrix("dst2", n, "inverse" if direction == "forward" else "forward")
    raise ValueError(f"bad trig kind {kind!r}")


_SELF_INVERSE_KINDS = {"dct1", "dst1", "dct4", "dst4"}


def dct_nd(x: np.ndarray, shape: Sequence[int], kind: str, direction: str = "forward",
           normalize: str = "none") -> np.ndarray:
    """ND separable DCT/DST over logical axes; x is (batch, *shape) real.

    Types 1 and 4 are self-inverse up to scale; direction only changes the
    normalize factor for them.
    """
    rank = len(shape)
    y = x.astype(np.float64)
    for d in range(rank):
        n = shape[d]
        ax = 1 + d
        mdir = "forward" if kind in _SELF_INVERSE_KINDS else direction
        mat = trig_matrix(kind, n, mdir)
        y = np.moveaxis(np.einsum("kn,...n->...k", mat, np.moveaxis(y, ax, -1)), -1, ax)
    s = normalize_scale(normalize, direction, math.prod(shape))
    return y * s if s != 1.0 else y


# ---------------------------------------------------------------------------
# FFT convolution
# ---------------------------------------------------------------------------

def fftconv_out_shape(shape: Sequence[int], kernel_shape: Sequence[int], boundary: str):
    """(fft_shape, out_shape, out_offset) per boundary mode."""
    rank = len(shape)
    if boundary == "circular":
        return list(shape), list(shape), [0] * rank
    fft_shape = [shape[d] + kernel_shape[d] - 1 for d in range(rank)]
    if boundary == "linear-full":
        return fft_shape, list(fft_shape), [0] * rank
    if boundary == "linear-same":
        return fft_shape, list(shape), [(kernel_shape[d] - 1) // 2 for d in range(rank)]
    if boundary == "linear-valid":
        out = [shape[d] - kernel_shape[d] + 1 for d in range(rank)]
        if any(o <= 0 for o in out):
            raise ValueError("linear-valid requires kernelShape <= shape")
        return fft_shape, out, [kernel_shape[d] - 1 for d in range(rank)]
    raise ValueError(f"bad boundary {boundary!r}")


def fftconv(x: np.ndarray, kernel: np.ndarray, shape: Sequence[int], *,
            batch: int = 1, mode: str = "convolution", boundary: str = "circular",
            kernel_shape: Optional[Sequence[int]] = None) -> np.ndarray:
    """Batched complex FFT convolution/correlation, one kernel.

    x: (batch, *shape) complex; kernel: (*kernel_shape,) complex.
    Output: (batch, *out_shape) per the boundary rule.  Correlation conjugates
    the kernel spectrum.
    """
    rank = len(shape)
    kshape = list(kernel_shape) if kernel_shape is not None else list(shape)
    if boundary == "circular" and any(kshape[d] > shape[d] for d in range(rank)):
        raise ValueError("kernelShape must be <= shape for circular boundary")
    fft_shape, out_shape, out_off = fftconv_out_shape(shape, kshape, boundary)

    kpad = np.zeros(tuple(fft_shape), dtype=np.complex128)
    kpad[tuple(slice(0, s) for s in kernel.shape)] = kernel
    kf = np.fft.fftn(kpad, norm=None)
    if mode == "correlation":
        kf = np.conj(kf)

    out = np.zeros((batch,) + tuple(out_shape), dtype=np.complex128)
    for b in range(batch):
        xpad = np.zeros(tuple(fft_shape), dtype=np.complex128)
        xpad[tuple(slice(0, s) for s in x[b].shape)] = x[b]
        xf = np.fft.fftn(xpad, norm=None)
        y = np.fft.ifftn(xf * kf, norm=None)  # numpy ifftn is backward-normalized
        out[b] = y[tuple(slice(o, o + s) for o, s in zip(out_off, out_shape))]
    return out


# ---------------------------------------------------------------------------
# Direct small conv2d
# ---------------------------------------------------------------------------

def conv2d_direct(x: np.ndarray, kernel: np.ndarray, *, pad: Sequence[int]) -> np.ndarray:
    """Zero-boundary direct conv, stride 1.  x: (batch, Hin, Win) real or
    complex; kernel: (k, k) real or complex.  pad = [top, bottom, left, right].
    Hout = Hin - k + 1 + top + bottom, Wout likewise.
    """
    k = kernel.shape[0]
    pt, pb, pl_, pr = pad
    batch, hin, win = x.shape
    hout = hin - (k - 1) + pt + pb
    wout = win - (k - 1) + pl_ + pr
    out_dtype = np.complex128 if (np.iscomplexobj(x) or np.iscomplexobj(kernel)) else np.float64
    out = np.zeros((batch, hout, wout), dtype=out_dtype)
    for y in range(hout):
        for xx in range(wout):
            acc = np.zeros((batch,), dtype=out_dtype)
            for ky in range(k):
                for kx in range(k):
                    iy = y + ky - pt
                    ix = xx + kx - pl_
                    if iy < 0 or ix < 0 or iy >= hin or ix >= win:
                        continue
                    acc = acc + x[:, iy, ix] * kernel[ky, kx]
            out[:, y, xx] = acc
    return out
