"""BufferView: a logical element range split across several tensor segments.

Port of ``webgpufft_tpu/utils/bufferview.py``.  A convenience for callers
whose data arrives in pieces: plans accept a BufferView wherever a flat
element buffer is accepted, pack it (one concatenate), execute, and can
split a flat result back into per-segment pieces.

Element units: complex views hold float32 segments of shape (n_i, 2);
real views hold (n_i,) segments.  ``logical_offset``/``length`` select the
element range handed to the plan (defaults: 0 / everything).  Segments are
torch tensors, all on one device (numpy arrays are converted on the CPU).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


class BufferView:
    def __init__(self, segments: Sequence, logical_offset: int = 0,
                 length: Optional[int] = None):
        if not segments:
            raise ValueError("BufferView requires at least one segment")
        self.segments = [torch.as_tensor(s) for s in segments]
        ndims = {s.ndim for s in self.segments}
        if len(ndims) != 1 or next(iter(ndims)) not in (1, 2):
            raise ValueError(
                "BufferView segments must all be rank-1 (real) or rank-2 "
                f"(interleaved complex); got ranks {sorted(ndims)}")
        if self.segments[0].ndim == 2 and any(s.shape[1] != 2 for s in self.segments):
            raise ValueError("complex BufferView segments must have shape (n, 2)")
        if len({s.device for s in self.segments}) != 1:
            raise ValueError("BufferView segments must all be on one device")
        total = sum(self.segment_lengths)
        if logical_offset < 0 or logical_offset > total:
            raise ValueError(f"logical_offset {logical_offset} out of range 0..{total}")
        self.logical_offset = int(logical_offset)
        self.length = int(length) if length is not None else total - self.logical_offset
        if self.logical_offset + self.length > total:
            raise ValueError(
                f"view [{self.logical_offset}, {self.logical_offset + self.length}) "
                f"exceeds total segment elements {total}")

    @property
    def interleaved(self) -> bool:
        return self.segments[0].ndim == 2

    @property
    def segment_lengths(self) -> List[int]:
        return [int(s.shape[0]) for s in self.segments]

    @classmethod
    def from_array(cls, arr, logical_offset: int = 0,
                   length: Optional[int] = None) -> "BufferView":
        return cls([arr], logical_offset, length)

    def pack(self) -> torch.Tensor:
        """Assemble the logical range as one flat tensor.  A view of one
        segment shares that segment's memory; several are concatenated."""
        flat = (self.segments[0] if len(self.segments) == 1
                else torch.cat(self.segments, dim=0))
        return flat[self.logical_offset: self.logical_offset + self.length]

    def unpack(self, flat) -> List[torch.Tensor]:
        """Split a flat result of ``length`` elements back into pieces shaped
        like this view's segments (elements outside the view come back
        zero-filled)."""
        if flat.shape[0] != self.length:
            raise ValueError(f"expected {self.length} elements, got {flat.shape[0]}")
        total = sum(self.segment_lengths)
        pad = (self.logical_offset, total - self.logical_offset - self.length)
        full = F.pad(flat, (0, 0) * (flat.ndim - 1) + pad)
        return list(torch.split(full, self.segment_lengths, dim=0))


def resolve_flat_input(x):
    """Plans call this to accept either a flat tensor or a BufferView."""
    if isinstance(x, BufferView):
        return x.pack()
    return x
