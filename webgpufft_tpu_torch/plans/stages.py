"""Pre/post staging stages: ioView embed/extract, zeroPad masks, strided
gather/scatter, precision conversion, channel-lane lowering.

Port of ``webgpufft_tpu/plans/stages.py`` on torch tensors: slices, pads,
masks and index gathers/scatters around the transform core, none of them
inside a kernel.

Coordinate convention for ioView: logical coord c maps to view coord
vc = c - offset; out-of-view reads are zero; offsets may be negative.

Where the JAX package returns a new array from a scatter, the port writes
into the caller's ``out`` tensor and returns it.

Every stage is a differentiable torch op: the index tables carry no
gradient, a scatter into fresh zeros differentiates with respect to its
values, and a merge into a caller's ``out`` is in place, so the result
carries the gradient of the written values and none to what ``out`` held.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..spec import ChannelLane, IoViewSide, PlanError, ZeroPadStage


# ---------------------------------------------------------------------------
# ioView
# ---------------------------------------------------------------------------

def _pad_axes(x: torch.Tensor, pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Zero-pad x with one (before, after) pair per axis, first axis first."""
    flat = [p for pair in reversed(list(pads)) for p in pair]
    return F.pad(x, flat) if any(flat) else x


def _window(x, slices, pads, full_shape):
    """x[slices] zero-padded by ``pads``; all zeros of ``full_shape`` when
    ``slices`` is None (no overlap)."""
    if slices is None:
        return torch.zeros(full_shape, dtype=x.dtype, device=x.device)
    return _pad_axes(x[tuple(slices)], pads)


def embed_view(x, view: IoViewSide, logical: Sequence[int], interleaved: bool):
    """(batch, *view.shape[, 2]) -> (batch, *logical[, 2]) with zeros outside.

    Overlap region per axis: logical [lo, hi) with lo = max(0, off),
    hi = min(L, off + V); the rest is zero-filled.
    """
    tail = 1 if interleaved else 0
    slices, pads = [slice(None)], [(0, 0)]
    for d, L in enumerate(logical):
        off, v = view.offset[d], view.shape[d]
        lo, hi = max(0, off), min(L, off + v)
        if hi <= lo:
            slices = None
            break
        slices.append(slice(lo - off, hi - off))
        pads.append((lo, L - hi))
    shape = tuple(x.shape[:1]) + tuple(logical) + ((2,) if interleaved else ())
    return _window(x, slices, pads + [(0, 0)] * tail, shape)


def view_overlap(view: IoViewSide, logical: Sequence[int]):
    """Per-axis overlap of the view window with the logical domain as
    (view_slices, logical_slices), or None when empty."""
    vsl, lsl = [], []
    for d, L in enumerate(logical):
        off, v = view.offset[d], view.shape[d]
        lo, hi = max(0, off), min(L, off + v)
        if hi <= lo:
            return None
        lsl.append(slice(lo, hi))
        vsl.append(slice(lo - off, hi - off))
    return tuple(vsl), tuple(lsl)


def merge_view_into(y_view, view: IoViewSide, logical: Sequence[int],
                    interleaved: bool, out):
    """clearOutside=false with a caller buffer: write only the view/logical
    overlap region of the extracted view into ``out``, leaving everything
    else as it was, and return ``out``."""
    ov = view_overlap(view, logical)
    if ov is None:
        return out
    vsl, _ = ov
    idx = (slice(None),) + vsl + ((slice(None),) if interleaved else ())
    out[idx] = y_view[idx].to(out.dtype)
    return out


def extract_view(y, view: IoViewSide, logical: Sequence[int], interleaved: bool):
    """(batch, *logical[, 2]) -> (batch, *view.shape[, 2]).

    View coords outside the logical domain are zero.  For the keep-outside
    behavior (clearOutside=false), exec(out=) merges via merge_view_into or
    an overlap-restricted strided scatter.
    """
    tail = 1 if interleaved else 0
    slices, pads = [slice(None)], [(0, 0)]
    for d, L in enumerate(logical):
        off, v = view.offset[d], view.shape[d]
        lo, hi = max(0, -off), min(v, L - off)
        if hi <= lo:
            slices = None
            break
        slices.append(slice(lo + off, hi + off))
        pads.append((lo, v - hi))
    shape = tuple(y.shape[:1]) + tuple(view.shape) + ((2,) if interleaved else ())
    return _window(y, slices, pads + [(0, 0)] * tail, shape)


# ---------------------------------------------------------------------------
# zeroPad (range-based zeroing)
# ---------------------------------------------------------------------------

def zero_pad_apply(x, stage: Optional[ZeroPadStage], domain: Sequence[int],
                   interleaved: bool):
    """Zero everything outside the [start, end) hyper-rect: one broadcast
    multiply per non-trivial axis."""
    if stage is None:
        return x
    for d, n in enumerate(domain):
        s, e = stage.start[d], stage.end[d]
        if s == 0 and e == n:
            continue
        iota = torch.arange(n, device=x.device)
        mask = ((iota >= s) & (iota < e)).to(x.dtype)
        shape = [1] * x.ndim
        shape[1 + d] = n
        x = x * mask.reshape(shape)
    return x


# ---------------------------------------------------------------------------
# Strided flat-buffer gather/scatter
# ---------------------------------------------------------------------------

def default_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """C-order contiguous: last logical axis fastest."""
    rank = len(shape)
    out = [1] * rank
    for d in range(rank - 2, -1, -1):
        out[d] = out[d + 1] * shape[d + 1]
    return tuple(out)


def layout_span(shape: Sequence[int], strides: Sequence[int]) -> int:
    """Elements spanned by one batch item."""
    return 1 + sum((shape[d] - 1) * strides[d] for d in range(len(shape)))


def layout_need(shape, strides, offset: int, batch_stride: int, batch: int) -> int:
    """Fewest flat elements that hold ``batch`` items of this layout."""
    return offset + batch_stride * (batch - 1) + layout_span(shape, strides)


def resolve_side_layout(shape: Sequence[int], strides: Optional[Sequence[int]],
                        offset: int, batch_stride: Optional[int],
                        lane: Optional[ChannelLane]):
    """Lower (strides/offset/batchStride | whdcn lane) to a concrete
    (strides, offset, batch_stride) triple over the side shape."""
    n = math.prod(shape)
    if lane is not None:
        if strides is not None:
            raise PlanError("whdcn and explicit strides cannot both be set for a side")
        cs = lane.channel_stride_elements if lane.channel_stride_elements is not None else n
        bs = (lane.batch_stride_elements if lane.batch_stride_elements is not None
              else lane.channels * cs)
        off = lane.offset_elements + lane.channel_index * cs
        return default_strides(shape), off, bs
    st = tuple(strides) if strides is not None else default_strides(shape)
    bs = batch_stride if batch_stride is not None else layout_span(shape, st)
    return st, offset, bs


def flat_indices(shape: Sequence[int], strides: Sequence[int], offset: int,
                 batch_stride: int, batch: int, device) -> torch.Tensor:
    """Element-index tensor (batch, *shape), int64 on ``device``.  A plan
    builds it once; an exec-time offset is a Python int added to it."""
    idx = offset + batch_stride * torch.arange(batch, dtype=torch.int64, device=device)
    idx = idx.reshape((batch,) + (1,) * len(shape))
    for d, n in enumerate(shape):
        sh = [1] * (len(shape) + 1)
        sh[1 + d] = n
        idx = idx + (strides[d] * torch.arange(n, dtype=torch.int64, device=device)).reshape(sh)
    return idx


class FlatLayout:
    """One strided flat-buffer side: its index tensor (built once, on the
    plan's device) and the flat length it needs."""

    def __init__(self, shape, strides, offset: int, batch_stride: int, batch: int,
                 interleaved: bool, device):
        self.shape, self.batch, self.interleaved = tuple(shape), batch, interleaved
        self.need = layout_need(shape, strides, offset, batch_stride, batch)
        self.idx = flat_indices(shape, strides, offset, batch_stride, batch, device)

    def index(self, extra_offset: Optional[int] = None) -> torch.Tensor:
        """The element indices, shifted by an exec-time offset."""
        return self.idx if not extra_offset else self.idx + extra_offset


def gather_flat(flat, layout: FlatLayout, extra_offset: Optional[int] = None):
    """Flat (L[, 2]) buffer -> shaped (batch, *shape[, 2])."""
    want = 2 if layout.interleaved else 1
    if flat.ndim != want:
        raise PlanError(
            f"strided-layout exec expects a flat buffer of rank {want} "
            f"({'(L, 2) interleaved' if layout.interleaved else '(L,)'}), "
            f"got shape {tuple(flat.shape)}")
    if flat.shape[0] < layout.need:
        raise PlanError(f"flat input too small: need {layout.need} elements, "
                        f"got {flat.shape[0]}")
    idx = layout.index(extra_offset)
    got = flat.index_select(0, idx.reshape(-1))
    return got.reshape(tuple(idx.shape) + ((2,) if layout.interleaved else ()))


def scatter_flat(values, layout: FlatLayout, out=None, min_len: Optional[int] = None,
                 extra_offset: Optional[int] = None):
    """Shaped (batch, *shape[, 2]) -> flat (L[, 2]).  Scatters into ``out``
    when given (in place: untouched elements keep their values, and ``out``
    is returned), else into zeros of the minimal span (or ``min_len``)."""
    if out is None:
        length = max(layout.need, min_len or 0)
        out = torch.zeros((length, 2) if layout.interleaved else (length,),
                          dtype=values.dtype, device=values.device)
    elif out.ndim != (2 if layout.interleaved else 1):
        raise PlanError(
            f"strided-layout out= expects a flat buffer of rank "
            f"{2 if layout.interleaved else 1}, got shape {tuple(out.shape)}")
    elif out.shape[0] < layout.need:
        raise PlanError(f"output buffer too small: need {layout.need} elements, "
                        f"got {out.shape[0]}")
    vals = values.reshape((-1, 2) if layout.interleaved else (-1,)).to(out.dtype)
    out.index_copy_(0, layout.index(extra_offset).reshape(-1), vals)
    return out


# ---------------------------------------------------------------------------
# Precision (bf16 storage, f32 compute)
# ---------------------------------------------------------------------------

def load_storage(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.float() if precision == "bf16-storage" else x


def store_storage(y: torch.Tensor, precision: str) -> torch.Tensor:
    return y.to(torch.bfloat16) if precision == "bf16-storage" else y


def expect_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16-storage" else torch.float32
