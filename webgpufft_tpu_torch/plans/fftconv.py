"""FFT convolution / correlation plan.

Port of ``webgpufft_tpu/plans/fftconv.py``: embed -> forward FFT ->
pointwise complex multiply -> inverse FFT -> boundary crop -> output
placement, with the 1/N of the backward inverse folded into the kernel
spectrum.  Multi-kernel workflows broadcast over a leading kernel dim and
share the data-side forward FFT.

Every transform is a sequence of ``transforms.axis_pass`` passes chosen for
the array it runs on: the data ``(batch, *fft_shape)``, the kernels
``(kcount, *fft_shape)``, the product ``(kcount * batch, *fft_shape)`` and,
on the overlap-save route, the blocks ``(batch * nb, B)``.  So the last axis
runs K1 and the earlier axes K2 wherever the array gives them enough lines
and lanes, and the einsum route elsewhere (a lone kernel line, a 4-line
channel-lane batch).

Not carried from the JAX package: its batch chunking and overlap-save block
groups, which exist for the TPU einsum-operand bound.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import engine
from ..core.axis import MixedAxisPlan, select_axis_kind
from ..runtime.policy import knob_reasons
from ..spec import PlanError, PlanSpec
from ..utils import factors
from ..utils.mathref import fftconv_out_shape
from . import stages
from .base import Plan, RouteInfo
from .transforms import AxisPass, _run, _set_mode, axis_pass, kernels_allowed

# Overlap-save auto-selection bounds, inherited from the JAX package so both
# packages route alike; they are not measured on this card.  The route is
# taken when the direct fftShape FFT would be long but the kernel is short:
# batched block FFTs of length B with (k-1)-sample overlap.
OS_MIN_N = 1 << 14             # absolute floor
OS_SOLO_N = 1 << 15            # below this, need n*batch >= OS_MIN_WORK
OS_MIN_WORK = 1 << 16
OS_MAX_TAP = 1 << 12


def _os_block(fc, k: int) -> int:
    """Resolved smooth block length (seam trick requires B >= 2*(k-1))."""
    pad_k = max(k - 1, 1)
    b = fc.overlap_block or max(8192, 8 * pad_k)
    return factors.next_smooth_at_least(max(b, 2 * pad_k))


def _overlap_save_route(spec: PlanSpec, kshape) -> bool:
    fc = spec.fft_conv
    if fc.overlap_save == "off":
        return False
    structural_ok = (
        spec.rank == 1 and fc.kernel_count == 1
        and fc.channel_input is None and fc.channel_output is None
        and fc.output_kernel_stride_elements is None
        and spec.zero_pad.read is None and spec.zero_pad.write is None
        and fc.mode == "convolution" and spec.precision == "f32")
    if fc.overlap_save == "on":
        if not structural_ok:
            raise PlanError(
                "fftConv.tuning.overlapSave='on' requires rank 1, "
                "kernelCount 1, convolution mode, f32, and no "
                "channelPolicy/zeroPad/outputKernelStride")
        if kshape[0] < 2 or kshape[0] >= spec.shape[0]:
            raise PlanError("overlapSave needs 2 <= kernel length < shape")
        return True
    n, k = spec.shape[0], kshape[0]
    return (structural_ok and n >= OS_MIN_N
            and (n >= OS_SOLO_N or n * spec.batch >= OS_MIN_WORK)
            and 2 <= k and k - 1 <= OS_MAX_TAP and 8 * k <= n)


def _cmul(a, b):
    """Pointwise complex product of interleaved tensors (broadcasting)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def _record(route: RouteInfo, spec: PlanSpec, groups: Dict[str, Sequence[AxisPass]]) -> None:
    """Add ``fftconv-axis{d}-<kind>`` reasons from the data-side passes (and
    ``fftconv-<array>-axis{d}-<kind>`` where another array's pass differs)
    and set the mode.  Under ``impl: "xla"`` the route stays as the JAX
    package reports it."""
    if spec.tuning.impl == "xla":
        return
    data = groups["data"]
    reasons: List[str] = [f"fftconv-axis{d}-{p.detail}" for d, p in enumerate(data)]
    for name, passes in groups.items():
        reasons += [f"fftconv-{name}-axis{d}-{p.detail}" for d, p in enumerate(passes)
                    if name != "data" and p.detail != data[d].detail]
    route.reasons = route.reasons + tuple(reasons)
    _set_mode(route, [p.kind for ps in groups.values() for p in ps], spec.tuning)


def _build_fftconv_overlap_save(spec: PlanSpec, kshape, device: torch.device) -> Plan:
    """Overlap-save streaming convolution: block FFTs of length B with
    (k-1)-sample overlap instead of one length-(n+k-1) FFT.

    Cost O(n log B) instead of O(n log n), memory bounded by the block
    expansion B/(B-k+1).  Circular boundaries prepend the (k-1)-sample wrap
    so every mode reduces to a crop of the linear-full result.
    """
    fc, tun = spec.fft_conv, spec.tuning
    n, k, batch = spec.shape[0], kshape[0], spec.batch
    pad_k = k - 1
    B = _os_block(fc, k)
    H = B - pad_k
    if H < max(pad_k, 1):
        raise PlanError(f"overlapSave block ({B}) must be >= twice the kernel "
                        f"overlap ({pad_k})")
    _, out_shape, out_off = fftconv_out_shape([n], [k], fc.boundary)
    out_len = out_shape[0]
    # the linear-full result of the (possibly wrap-extended) input
    wrap = pad_k if fc.boundary == "circular" else 0
    L = n + wrap
    s0 = out_off[0] + wrap            # crop start in linear-full indices
    nb = -(-(s0 + out_len) // H)      # blocks needed to cover the crop
    total = (nb + 1) * H              # shifted-reshape span (>= pad_k + L)
    right = total - pad_k - L
    fwd = MixedAxisPlan(B, "forward", "os/f", tun.max_sub_length)
    inv = MixedAxisPlan(B, "inverse", "os/i", tun.max_sub_length)
    consts: Dict[str, np.ndarray] = {}
    kernels = kernels_allowed(spec)
    f_blocks = axis_pass((B,), batch * nb, 0, "forward", 1.0, tun, consts, fwd,
                         kernels, prefix="os/f/")
    f_kernel = axis_pass((B,), 1, 0, "forward", 1.0, tun, consts, fwd,
                         kernels, prefix="os/f/")
    i_blocks = axis_pass((B,), batch * nb, 0, "inverse", 1.0, tun, consts, inv,
                         kernels, prefix="os/i/")

    route = RouteInfo(
        mode="overlap-save", impl="xla", axis_kinds=("mixed",),
        reasons=("fftconv-overlap-save", f"os-block({B})", f"os-hop({H})",
                 f"os-blocks({nb})") + knob_reasons(spec),
        attempts=("overlap-save",))
    _record(route, spec, {"data": [f_blocks], "kernel": [f_kernel], "inverse": [i_blocks]})
    route.mode = "overlap-save"

    def fn(consts_, x, kernel, out=None):
        b = x.shape[0]
        if wrap:
            x = torch.cat([x[:, n - wrap:, :], x], dim=1)
        xp = F.pad(x, (0, 0, pad_k, right))
        # seam-trick overlapping windows: window i is the contiguous
        # [i*H, i*H+H) hop plus the next hop's first pad_k samples: two
        # reshapes and a concat instead of an overlap gather
        hops = xp[:, :nb * H, :].reshape(b, nb, H, 2)
        seam = xp[:, H:(nb + 1) * H, :].reshape(b, nb, H, 2)[:, :, :pad_k, :]
        blocks = torch.cat([hops, seam], dim=2)          # (b, nb, B, 2)
        ke = F.pad(kernel.reshape(1, k, 2), (0, 0, 0, B - k))
        kf = f_kernel(ke, consts_) * (1.0 / B)
        xf = f_blocks(blocks, consts_)                   # (b * nb, B, 2)
        yt = i_blocks(_cmul(xf, kf), consts_)
        y = yt[:, pad_k:, :].reshape(b, nb * H, 2)
        return y[:, s0:s0 + out_len].contiguous()

    plan = Plan(spec, consts, fn, route, device=device, input_shape=(batch, n, 2),
                output_shape=(batch, out_len, 2), needs_kernel=True,
                workspace_bytes=2 * batch * nb * B * 8)
    plan.fft_shape = (B,)
    plan.out_shape = (out_len,)

    def coerce_kernel(kernel):
        kernel = plan._kernel_tensor(kernel)
        if tuple(kernel.shape) == (k, 2):
            return kernel
        if tuple(kernel.shape) == (1, k, 2):
            return kernel[0]
        if kernel.ndim == 1 and kernel.numel() == k * 2:
            return kernel.reshape(k, 2)
        raise PlanError(f"fftconv kernel shape {tuple(kernel.shape)} not understood; "
                        f"expected ({k}, 2)")

    plan._coerce_kernel = coerce_kernel
    return plan


def build_fftconv(spec: PlanSpec, device: torch.device) -> Plan:
    fc, tun = spec.fft_conv, spec.tuning
    shape, rank = tuple(spec.shape), spec.rank
    kshape = tuple(fc.kernel_shape) if fc.kernel_shape is not None else shape
    if _overlap_save_route(spec, kshape):
        return _build_fftconv_overlap_save(spec, kshape, device)
    fft_shape, out_shape, out_off = fftconv_out_shape(shape, kshape, fc.boundary)
    fft_shape, out_shape = tuple(fft_shape), tuple(out_shape)
    nf = math.prod(fft_shape)
    batch, kcount = spec.batch, fc.kernel_count

    fwd = engine.build_axis_plans(fft_shape, "forward", tun, prefix="f/ax")
    inv = engine.build_axis_plans(fft_shape, "inverse", tun, prefix="i/ax")
    consts: Dict[str, np.ndarray] = {}
    kernels = kernels_allowed(spec)

    def passes(lead, direction, plans, prefix):
        return [axis_pass(fft_shape, lead, d, direction, 1.0, tun, consts, plans[d],
                          kernels, prefix=prefix) for d in range(rank)]

    f_data = passes(batch, "forward", fwd, "f/")
    f_kernel = passes(kcount, "forward", fwd, "f/")
    i_prod = passes(kcount * batch, "inverse", inv, "i/")

    kinds = tuple(select_axis_kind(n, d, tun) for d, n in enumerate(fft_shape))
    route = RouteInfo(mode="xla", impl="xla", axis_kinds=kinds,
                      reasons=("fftconv-xla-pipeline",) + knob_reasons(spec),
                      attempts=("xla",))
    _record(route, spec, {"data": f_data, "kernel": f_kernel, "inverse": i_prod})

    # channel-lane input gather (the input side's shape is the data `shape`)
    # and output scatter; the index tensors are built once, here
    ch_in, ch_out = fc.channel_input, fc.channel_output
    out_kernel_stride = fc.output_kernel_stride_elements
    out_st = stages.default_strides(out_shape)
    gather = None
    if ch_in is not None:
        in_st, in_off, in_bs = stages.resolve_side_layout(shape, None, 0, None, ch_in)
        gather = stages.FlatLayout(shape, in_st, in_off, in_bs, batch, True, device)
    scatter, kernel_offsets, out_need = None, [], 0
    if ch_out is not None:
        cs = (ch_out.channel_stride_elements
              if ch_out.channel_stride_elements is not None else math.prod(out_shape))
        bs = (ch_out.batch_stride_elements
              if ch_out.batch_stride_elements is not None else ch_out.channels * cs)
        kernel_offsets = [ch_out.offset_elements
                          + (ch_out.channel_index + k * ch_out.kernel_step_channels) * cs
                          for k in range(kcount)]
        scatter = stages.FlatLayout(out_shape, out_st, 0, bs, batch, True, device)
        # full channel-lane frames for all batches
        out_need = max([bs * batch] + [off + scatter.need for off in kernel_offsets])
    elif out_kernel_stride is not None:
        span = math.prod(out_shape)
        kernel_offsets = [k * out_kernel_stride for k in range(kcount)]
        scatter = stages.FlatLayout(out_shape, out_st, 0, span, batch, True, device)
        out_need = max(out_kernel_stride * (kcount - 1) + span * batch,
                       out_kernel_stride * kcount)

    def pad_to_fft(arr):
        """Zero-pad (lead, *dims, 2) at the high end of each axis to fft_shape."""
        pads = [0, 0]
        for d in range(rank - 1, -1, -1):
            pads += [0, fft_shape[d] - arr.shape[1 + d]]
        return F.pad(arr, pads) if any(pads) else arr

    def fn(consts_, x, kernel, out=None):
        # ---- input staging -> (batch, *fft_shape, 2)
        x = stages.load_storage(x, spec.precision)
        if gather is not None:
            x = stages.gather_flat(x, gather)
        xe = stages.zero_pad_apply(pad_to_fft(x), spec.zero_pad.read, fft_shape, True)

        # ---- kernel-side forward FFT
        kf = _run(f_kernel, pad_to_fft(kernel), consts_)          # (kcount, *fft, 2)
        if fc.mode == "correlation":
            kf = torch.stack([kf[..., 0], -kf[..., 1]], dim=-1)   # conj spectrum
        kf = kf * (1.0 / nf)                                      # fold backward 1/N

        xf = _run(f_data, xe, consts_)                            # (batch, *fft, 2)
        yf = _cmul(xf[None], kf[:, None])                         # (kcount, batch, ...)
        y = _run(i_prod, yf.reshape((kcount * batch,) + fft_shape + (2,)), consts_)
        y = stages.zero_pad_apply(y, spec.zero_pad.write, fft_shape, True)
        y = y.reshape((kcount, batch) + fft_shape + (2,))
        crop = (slice(None), slice(None)) + tuple(
            slice(out_off[d], out_off[d] + out_shape[d]) for d in range(rank))
        y = y[crop]                                               # (kc, b, *out, 2)

        # ---- output placement
        if scatter is not None:
            res = out
            if res is None:
                res = torch.zeros((out_need, 2), dtype=stages.expect_dtype(spec.precision),
                                  device=y.device)
            elif res.ndim != 2 or res.shape[0] < max(off + scatter.need
                                                     for off in kernel_offsets):
                raise PlanError(
                    f"fftconv: out= must be a flat (L, 2) buffer of at least "
                    f"{max(off + scatter.need for off in kernel_offsets)} elements, "
                    f"got shape {tuple(res.shape)}")
            for k, off in enumerate(kernel_offsets):
                stages.scatter_flat(y[k], scatter, out=res, extra_offset=off)
            return res
        if kcount == 1:
            y = y[0]                                              # (b, *out, 2)
        elif fc.output_layout == "batch-major":
            y = y.movedim(0, 1)                                   # (b, kc, *out, 2)
        return stages.store_storage(y.contiguous(), spec.precision)

    ws = (2 * batch + 2 * kcount + 2 * kcount * batch) * nf * 8
    plan = Plan(spec, consts, fn, route, device=device,
                input_shape=(None,) if ch_in is not None else (batch,) + shape + (2,),
                output_shape=(None,) if scatter is not None else None,
                needs_kernel=True, workspace_bytes=ws)
    # out= merging is meaningful only for the flat-scatter output modes
    plan.accepts_out = scatter is not None
    plan.fft_shape = fft_shape
    plan.out_shape = out_shape

    def coerce_kernel(kernel):
        """Accept (kc, *kshape, 2) | (*kshape, 2) [kc=1] | packed flat
        (kc*prod(kshape), 2) | list of per-kernel payloads."""
        want = (kcount,) + kshape + (2,)
        kn = math.prod(kshape)
        if isinstance(kernel, (list, tuple)):
            if len(kernel) != kcount:
                raise PlanError(f"kernel list must have {kcount} entries")
            return torch.stack([plan._kernel_tensor(k).reshape(kshape + (2,))
                                for k in kernel])
        kernel = plan._kernel_tensor(kernel)
        got = tuple(kernel.shape)
        if got == want:
            return kernel
        if kcount == 1 and got == kshape + (2,):
            return kernel[None]
        if got == (kcount * kn, 2) or (kernel.ndim == 1 and kernel.numel() == kcount * kn * 2):
            return kernel.reshape(want)
        raise PlanError(
            f"fftconv kernel shape {got} not understood; expected {want}, "
            f"{kshape + (2,)} (kcount=1), packed ({kcount * kn}, 2), "
            f"or a list of {kcount} payloads")

    plan._coerce_kernel = coerce_kernel
    return plan
