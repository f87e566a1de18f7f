"""P1, the streaming copy: y = x or y = x * scale of a contiguous f32 array.

Counterpart of the JAX package's Pallas copy probes:
``benches/r12_pallas_dma.py:57`` (``make_block_copy``, call ``:63``) and
``:75`` (``make_dma_copy``, call ``:130``), ``benches/r26_pallas_endgame.py:156``
(``build_copy``, call ``:160``) and the grid and ``emit_pipeline`` copies of
``benches/r2_perf_experiments.py`` (calls ``:225``, ``:253``, ``:274``).  Those
ask what a kernel that stages every byte through on-chip memory can reach;
``csrc/probes/stream_copy.cu`` asks it of an H100 in three modes:

- ``direct``: global -> registers -> global, 16 bytes a thread, a CTA per
  tile (the grid copy);
- ``cp_async``: persistent CTAs, global -> shared with ``cp.async`` 16-byte
  copies and ``commit_group`` / ``wait_group``, 2 or 4 stages (the
  ``emit_pipeline`` copy and the 2-/4-slot DMA loop);
- ``bulk``: persistent CTAs, one elected thread moving whole tiles with the
  1-D bulk copy (``cp.async.bulk``) in and out, completion on an
  ``mbarrier``, 2 or 4 stages (the DMA engine).

``stage_bytes`` is the tile a CTA moves at a time (and a stage of the
shared-memory ring); the ring must fit the 227 KB a CTA may use.  The copy
modes are bit-equal to the plain version, ``x.clone()`` or ``x * scale``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build

MODES = ("direct", "cp_async", "bulk")
STAGE_COUNTS = (2, 4)
MAX_SHARED_BYTES = 232448   # 227 KB: the shared memory a CTA may opt in to
BARRIER_BYTES = 128         # bulk mode keeps its mbarriers ahead of the ring
CTAS_PER_SM = 4             # persistent CTAs an SM gets in the staged modes, ring permitting


def stream_copy_reference(x: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Plain torch version: a new tensor equal to ``x``, times ``scale``
    where one is given."""
    return x.clone() if scale is None else x * scale


def shared_bytes(mode: str, stages: int, stage_bytes: int) -> int:
    """Dynamic shared memory a CTA of ``mode`` asks for."""
    if mode == "direct":
        return 0
    return stages * stage_bytes + (BARRIER_BYTES if mode == "bulk" else 0)


def check_args(x: torch.Tensor, mode: str, stages: int, stage_bytes: int) -> None:
    """Raise ``ValueError`` for what the kernel does not take: the checks of
    the C entry point, made before a raw pointer is taken."""
    if mode not in MODES:
        raise ValueError(f"stream_copy: mode {mode!r} is not one of {MODES}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 4:
        raise ValueError(
            f"stream_copy: x must be a contiguous float32 tensor of at least 4 elements, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    if x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError(
            f"stream_copy: 16-byte copies need a 16-byte aligned tensor whose element count "
            f"is a multiple of 4, got {x.numel()} elements at address % 16 = {x.data_ptr() % 16}")
    if stage_bytes < 16 or stage_bytes % 16:
        raise ValueError(f"stream_copy: stage_bytes {stage_bytes} is not a positive multiple of 16")
    if mode == "direct":
        return
    if stages not in STAGE_COUNTS:
        raise ValueError(f"stream_copy: stages {stages} is not one of {STAGE_COUNTS}")
    need = shared_bytes(mode, stages, stage_bytes)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"stream_copy: {stages} stages of {stage_bytes} bytes need {need} bytes of shared "
            f"memory, over the {MAX_SHARED_BYTES} a CTA may use")


def stream_copy(x: torch.Tensor, scale: Optional[float] = None, *, mode: str = "direct",
                stages: int = 2, stage_bytes: int = 16384) -> torch.Tensor:
    """A copy of ``x`` (times ``scale`` where given) made by the probe kernel
    in ``mode``.  A CUDA tensor launches the kernel (and counts one launch);
    a CPU tensor runs ``stream_copy_reference``.  The staged modes run
    ``CTAS_PER_SM`` persistent CTAs on each SM, fewer where the ring leaves
    room for fewer."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_copy: unsupported device {x.device}")
    check_args(x, mode, stages, stage_bytes)
    if x.device.type == "cpu":
        return stream_copy_reference(x, scale)
    need = shared_bytes(mode, stages, stage_bytes)
    resident = max(1, min(CTAS_PER_SM, MAX_SHARED_BYTES // (need + 1024)))
    ctas = resident * torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = _build.library("probes")
    y = torch.empty_like(x)
    with _build.on_device(x.device):
        rc = lib.wgfft_stream_copy(x.data_ptr(), y.data_ptr(), x.numel(),
                                   1.0 if scale is None else float(scale), int(scale is not None),
                                   MODES.index(mode), stages, stage_bytes, ctas,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "stream_copy", "probes")
    stream_copy.launches += 1
    return y


stream_copy.launches = 0
