"""scipy.signal peak finding (find_peaks / prominences / widths / argrel*).

Port of ``webgpufft_tpu/peaks.py``, the port's own copy.  Host numpy
analysis math by design: peak finding returns VARIABLE-LENGTH index sets
(data-dependent output shapes), and in the spectral workflow it consumes
small host-side summaries (a welch PSD, a correlation profile) produced by
the device pipeline.  The canonical chain is

    f, P = wfft.welch(x_on_device, fs)                       # device
    peaks, props = webgpufft_tpu_torch.peaks.find_peaks(P, prominence=...)  # host

so a signal given as a tensor (on any device) is copied to the host first.
Semantics pinned function-by-function against scipy.signal and the JAX
package in tests/test_torch_peaks.py (plateau handling, filter ORDER:
plateau_size, height, threshold, distance, prominence, width, and every
property key).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .spec import PlanError

__all__ = [
    "find_peaks", "peak_prominences", "peak_widths",
    "argrelmin", "argrelmax", "argrelextrema", "find_peaks_cwt",
]


# ------------------------------------------------------------ local maxima

def _host(x, dtype=None) -> np.ndarray:
    """A signal as host numpy: a tensor (on any device) is copied."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _local_maxima_1d(x: np.ndarray):
    """Midpoints/edges of strict local maxima, plateaus allowed
    (run-length formulation of scipy's _local_maxima_1d scan)."""
    n = x.size
    if n < 3:
        e = np.empty(0, np.intp)
        return e, e.copy(), e.copy()
    change = np.flatnonzero(x[1:] != x[:-1]) + 1
    starts = np.concatenate(([0], change))          # run starts
    ends = np.concatenate((change - 1, [n - 1]))    # run ends (inclusive)
    vals = x[starts]
    if starts.size < 3:
        e = np.empty(0, np.intp)
        return e, e.copy(), e.copy()
    interior = np.arange(1, starts.size - 1)
    is_max = (vals[interior] > vals[interior - 1]) \
        & (vals[interior] > vals[interior + 1])
    runs = interior[is_max]
    left = starts[runs]
    right = ends[runs]
    mid = (left + right) // 2
    return mid.astype(np.intp), left.astype(np.intp), right.astype(np.intp)


# ------------------------------------------------------------- prominences

def _prominence_window(n: int, peak: int, wlen: int):
    if wlen > 0:
        half = wlen // 2
        return max(0, peak - half), min(n - 1, peak + half)
    return 0, n - 1


def _arg_wlen(wlen) -> int:
    """scipy's wlen validation: None -> -1 (whole signal); else must
    exceed 1 and is rounded UP to the next odd integer."""
    if wlen is None:
        return -1
    w = float(wlen)
    if w <= 1:
        raise PlanError(f"wlen must be larger than 1, was {wlen}")
    iw = int(math.ceil(w))
    return iw if iw % 2 == 1 else iw + 1


def peak_prominences(x, peaks, wlen=None):
    """Prominence of each peak (scipy.signal.peak_prominences semantics):
    scan outward while the signal stays <= the peak height (bounded by
    the odd ``wlen`` window), take the minimum on each side as the base,
    prominence = peak height - higher base."""
    x = _host(x, np.float64)
    if x.ndim != 1:
        raise PlanError("x must be a 1-D array")
    peaks = np.asarray(peaks)
    if peaks.size and not np.issubdtype(peaks.dtype, np.integer):
        raise PlanError("peaks must be an array of integer indices")
    peaks = peaks.astype(np.intp).ravel()
    n = x.size
    if peaks.size and (peaks.min() < 0 or peaks.max() >= n):
        bad = peaks[(peaks < 0) | (peaks >= n)][0]
        raise PlanError(f"peak {bad} is not a valid index for x")
    wlen = _arg_wlen(wlen)
    prom = np.empty(peaks.size, np.float64)
    lbase = np.empty(peaks.size, np.intp)
    rbase = np.empty(peaks.size, np.intp)
    warn = False
    for k, p in enumerate(peaks):
        i_min, i_max = _prominence_window(n, int(p), wlen)
        hp = x[p]
        i = int(p)
        left_min, lb = hp, int(p)
        while i_min <= i and x[i] <= hp:
            if x[i] < left_min:
                left_min, lb = x[i], i
            i -= 1
        i = int(p)
        right_min, rb = hp, int(p)
        while i <= i_max and x[i] <= hp:
            if x[i] < right_min:
                right_min, rb = x[i], i
            i += 1
        prom[k] = hp - max(left_min, right_min)
        lbase[k], rbase[k] = lb, rb
        if prom[k] == 0:
            warn = True
    if warn:
        import warnings
        warnings.warn("some peaks have a prominence of 0", stacklevel=2)
    return prom, lbase, rbase


def peak_widths(x, peaks, rel_height: float = 0.5, prominence_data=None,
                wlen=None):
    """Width of each peak at ``rel_height`` of its prominence
    (scipy.signal.peak_widths semantics, linear interpolated crossings)."""
    x = _host(x, np.float64)
    if x.ndim != 1:
        raise PlanError("x must be a 1-D array")
    peaks = np.asarray(peaks).astype(np.intp).ravel()
    if rel_height < 0:
        raise PlanError("rel_height must be greater or equal to 0.0")
    if prominence_data is None:
        prominence_data = peak_prominences(x, peaks, wlen)
    prom, lbase, rbase = (np.asarray(v) for v in prominence_data)
    if not (prom.size == lbase.size == rbase.size == peaks.size):
        raise PlanError("arrays in prominence_data must have the same "
                        "size as peaks")
    widths = np.empty(peaks.size, np.float64)
    w_h = np.empty(peaks.size, np.float64)
    l_ip = np.empty(peaks.size, np.float64)
    r_ip = np.empty(peaks.size, np.float64)
    for k, p in enumerate(peaks):
        i_min, i_max = int(lbase[k]), int(rbase[k])
        if not 0 <= i_min <= p <= i_max < x.size:
            raise PlanError(f"prominence data is invalid for peak {p}")
        height = x[p] - prom[k] * rel_height
        w_h[k] = height
        i = int(p)
        while i_min < i and height < x[i]:
            i -= 1
        lp = float(i)
        if x[i] < height:
            lp += (height - x[i]) / (x[i + 1] - x[i])
        i = int(p)
        while i < i_max and height < x[i]:
            i += 1
        rp = float(i)
        if x[i] < height:
            rp -= (height - x[i]) / (x[i - 1] - x[i])
        widths[k] = rp - lp
        l_ip[k], r_ip[k] = lp, rp
    if np.any(prom == 0):
        import warnings
        warnings.warn("some peaks have a prominence of 0", stacklevel=2)
    return widths, w_h, l_ip, r_ip


# -------------------------------------------------------------- find_peaks

def _unpack_interval(interval, peaks):
    """scipy's _unpack_condition_args: scalar/array or (min, max) pair;
    array-valued bounds are indexed at the peaks."""
    try:
        imin, imax = interval
    except (TypeError, ValueError):
        imin, imax = interval, None
    if isinstance(imin, np.ndarray):
        imin = imin[peaks]
    if isinstance(imax, np.ndarray):
        imax = imax[peaks]
    return imin, imax


def _select_interval(values, imin, imax):
    keep = np.ones(values.size, bool)
    if imin is not None:
        keep &= imin <= values
    if imax is not None:
        keep &= values <= imax
    return keep


def _select_by_distance(peaks, priority, distance: int):
    n = peaks.size
    keep = np.ones(n, bool)
    order = np.argsort(priority)
    for idx in order[::-1]:
        if not keep[idx]:
            continue
        k = idx - 1
        while k >= 0 and peaks[idx] - peaks[k] < distance:
            keep[k] = False
            k -= 1
        k = idx + 1
        while k < n and peaks[k] - peaks[idx] < distance:
            keep[k] = False
            k += 1
    return keep


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None, width=None, wlen=None,
               rel_height: float = 0.5, plateau_size=None):
    """Find local maxima subject to the standard condition set
    (scipy.signal.find_peaks semantics and filter ORDER: plateau_size,
    height, threshold, distance, prominence, width).  Returns
    ``(peaks, properties)`` with scipy's property keys."""
    x = _host(x, np.float64)
    if x.ndim != 1:
        raise PlanError("x must be a 1-D array")
    if distance is not None and distance < 1:
        raise PlanError("distance must be greater or equal to 1")
    peaks, ledges, redges = _local_maxima_1d(x)
    props: dict = {}
    if plateau_size is not None:
        pmin, pmax = _unpack_interval(plateau_size, peaks)
        sizes = redges - ledges + 1
        keep = _select_interval(sizes, pmin, pmax)
        peaks, ledges, redges = peaks[keep], ledges[keep], redges[keep]
        props["plateau_sizes"] = sizes[keep]
        props["left_edges"] = ledges
        props["right_edges"] = redges
    if height is not None:
        hmin, hmax = _unpack_interval(height, peaks)
        heights = x[peaks]
        keep = _select_interval(heights, hmin, hmax)
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
        props["peak_heights"] = heights[keep]
    if threshold is not None:
        tmin, tmax = _unpack_interval(threshold, peaks)
        left = x[peaks] - x[peaks - 1]
        right = x[peaks] - x[peaks + 1]
        keep = np.ones(peaks.size, bool)
        if tmin is not None:
            keep &= tmin <= np.minimum(left, right)
        if tmax is not None:
            keep &= np.maximum(left, right) <= tmax
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
        props["left_thresholds"] = left[keep]
        props["right_thresholds"] = right[keep]
    if distance is not None:
        keep = _select_by_distance(peaks, x[peaks],
                                   int(math.ceil(distance)))
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
    if prominence is not None or width is not None:
        wlen_i = _arg_wlen(wlen)
        prom_data = peak_prominences(x, peaks,
                                     wlen_i if wlen_i > 0 else None)
        props["prominences"], props["left_bases"], \
            props["right_bases"] = prom_data
    if prominence is not None:
        pmin, pmax = _unpack_interval(prominence, peaks)
        keep = _select_interval(props["prominences"], pmin, pmax)
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
    if width is not None:
        prom_data = (props["prominences"], props["left_bases"],
                     props["right_bases"])
        props["widths"], props["width_heights"], props["left_ips"], \
            props["right_ips"] = peak_widths(x, peaks, rel_height,
                                             prom_data)
        wmin, wmax = _unpack_interval(width, peaks)
        keep = _select_interval(props["widths"], wmin, wmax)
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
    return peaks, props


# ----------------------------------------------------------------- argrel*

def _boolrelextrema(data, comparator, axis: int, order: int, mode: str):
    if int(order) != order or order < 1:
        raise PlanError("order must be an int >= 1")
    n = data.shape[axis]
    locs = np.arange(n)
    results = np.ones(data.shape, dtype=bool)
    main = data.take(locs, axis=axis, mode=mode)
    for shift in range(1, int(order) + 1):
        plus = data.take(locs + shift, axis=axis, mode=mode)
        minus = data.take(locs - shift, axis=axis, mode=mode)
        results &= comparator(main, plus)
        results &= comparator(main, minus)
        if ~results.any():
            return results
    return results


def argrelextrema(data, comparator, axis: int = 0, order: int = 1,
                  mode: str = "clip"):
    """Relative extrema by an arbitrary comparator
    (scipy.signal.argrelextrema semantics)."""
    data = _host(data)
    return np.nonzero(_boolrelextrema(data, comparator, axis, order, mode))


def argrelmax(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Relative maxima (scipy.signal.argrelmax: strict > over ``order``
    neighbors each side; boundary handled per ``mode``)."""
    return argrelextrema(data, np.greater, axis, order, mode)


def argrelmin(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Relative minima (scipy.signal.argrelmin)."""
    return argrelextrema(data, np.less, axis, order, mode)


# ------------------------------------------------------- wavelet peaks

def _ricker(points: int, a: float) -> np.ndarray:
    """Ricker (mexican-hat) wavelet, scipy's normalization."""
    A = 2 / (np.sqrt(3 * a) * (np.pi ** 0.25))
    vec = np.arange(points) - (points - 1.0) / 2
    xsq = vec * vec
    return A * (1 - xsq / (a * a)) * np.exp(-xsq / (2 * a * a))


def _cwt_ricker(data: np.ndarray, widths, wavelet) -> np.ndarray:
    """Continuous wavelet transform rows: per width, 'same' convolution
    with the length-min(10*width, n) reversed-conjugate wavelet."""
    out = np.empty((len(widths), data.size))
    for i, w in enumerate(widths):
        N = int(min(10 * w, data.size))
        wd = np.conj(np.asarray(wavelet(N, w))[::-1])
        out[i] = np.convolve(data, wd, mode="same")
    return out


def _ridge_lines(matr: np.ndarray, max_distances, gap_thresh):
    """Connect per-row relative maxima into ridge lines, walking from
    the widest row down (Du et al. 2006 ridge-line algorithm, scipy's
    conventions: nearest previous column within max_distances[row]
    connects; a line dies after gap_thresh rows without a connection)."""
    relmax = _boolrelextrema(matr, np.greater, axis=1, order=1,
                             mode="clip")
    has = np.nonzero(relmax.any(axis=1))[0]
    if has.size == 0:
        return []
    start = has[-1]
    live = [[[start], [c], 0] for c in np.nonzero(relmax[start])[0]]
    done = []
    for row in range(start - 1, -1, -1):
        this_cols = np.nonzero(relmax[row])[0]
        for line in live:
            line[2] += 1
        prev_cols = np.array([line[1][-1] for line in live])
        for c in this_cols:
            line = None
            if prev_cols.size:
                d = np.abs(c - prev_cols)
                j = int(np.argmin(d))
                if d[j] <= max_distances[row]:
                    line = live[j]
            if line is not None:
                line[0].append(row)
                line[1].append(c)
                line[2] = 0
            else:
                live.append([[row], [c], 0])
        for i in range(len(live) - 1, -1, -1):
            if live[i][2] > gap_thresh:
                done.append(live[i])
                del live[i]
    out = []
    for rows_, cols_, _ in done + live:
        order = np.argsort(rows_)
        out.append([np.asarray(rows_)[order], np.asarray(cols_)[order]])
    return out


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None,
                   gap_thresh=None, min_length=None, min_snr: float = 1,
                   noise_perc: float = 10, window_size=None):
    """Wavelet-ridge peak finding (scipy.signal.find_peaks_cwt
    semantics): CWT over ``widths`` (ricker default), ridge lines walked
    widest-to-narrowest, filtered by length and by the SNR of the
    narrowest-row value against a windowed noise percentile."""
    vector = _host(vector, np.float64)
    widths = np.atleast_1d(np.asarray(widths, dtype=np.float64))
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    max_distances = np.atleast_1d(np.asarray(max_distances))
    if max_distances.size < widths.size:
        raise PlanError("max_distances must have at least as many entries "
                        "as widths")
    if wavelet is None:
        wavelet = _ricker
    cwt_dat = _cwt_ricker(vector, widths, wavelet)
    lines = _ridge_lines(cwt_dat, max_distances, gap_thresh)
    n = cwt_dat.shape[1]
    if min_length is None:
        min_length = np.ceil(cwt_dat.shape[0] / 4)
    if window_size is None:
        window_size = np.ceil(n / 20)
    window_size = int(window_size)
    hf, odd = divmod(window_size, 2)
    row0 = cwt_dat[0]
    noises = np.array([
        np.percentile(row0[max(i - hf, 0):min(i + hf + odd, n)],
                      noise_perc)
        for i in range(n)])
    keep = []
    for rows_, cols_ in lines:
        if rows_.size < min_length:
            continue
        denom = noises[cols_[0]]
        snr = np.inf if denom == 0 else \
            abs(cwt_dat[rows_[0], cols_[0]] / denom)
        if snr >= min_snr:
            keep.append(cols_[0])
    return np.sort(np.asarray(keep, dtype=np.intp))
