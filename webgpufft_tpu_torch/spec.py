"""Plan specification: validation + normalization of `create_plan` options.

A copy of ``webgpufft_tpu/spec.py`` so that the PyTorch port validates
exactly the same options dicts without importing JAX.  The only code change
is the ``chunkElements`` cap, which is a local constant here instead of an
import from the JAX axis engine.  Specs are frozen/hashable so they serve as
plan-cache keys.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

PLAN_TYPES = (
    "c2c", "r2c", "c2r",
    "dct1", "dct2", "dct3", "dct4",
    "dst1", "dst2", "dst3", "dst4",
    "fftconv", "conv2d",
)
DIRECTIONS = ("forward", "inverse")
NORMALIZE_MODES = ("none", "backward", "unitary")
PRECISIONS = ("f32", "bf16-storage")  # bf16-storage = TPU analog of f16-storage
BOUNDARIES = ("circular", "linear-full", "linear-same", "linear-valid")
CONV_MODES = ("convolution", "correlation")
OUTPUT_LAYOUTS = ("kernel-major", "batch-major")
# The JAX package's default einsum-operand bound (webgpufft_tpu/core/axis.py
# OPERAND_CHUNK_ELEMS): the upper cap of tuning.chunkElements.
OPERAND_CHUNK_ELEMS = 1 << 22


class PlanError(ValueError):
    """Invalid plan specification or exec misuse.

    Mirrors the reference's diagnostic-rich errors (e.g.
    `ensureWithinBindingLimit` dumps shapes/limits, common.js:42-53): a
    structured ``details`` dict rides along with the message for
    programmatic inspection.
    """

    def __init__(self, msg: str, **details):
        if details:
            msg = f"{msg} [{', '.join(f'{k}={v!r}' for k, v in details.items())}]"
        super().__init__(msg)
        self.details = details


def _check(cond: bool, msg: str):
    if not cond:
        raise PlanError(msg)


def _pos_int_tuple(v, name: str) -> Tuple[int, ...]:
    _check(isinstance(v, (tuple, list)) and len(v) >= 1, f"{name} must be a non-empty list")
    out = []
    for x in v:
        _check(isinstance(x, int) and not isinstance(x, bool) and x > 0,
               f"{name} entries must be positive ints, got {v!r}")
        out.append(int(x))
    return tuple(out)


@dataclass(frozen=True)
class IoViewSide:
    """One side of an ioView mapping (reference: src/runtime/ioview.js:7-36).

    ``offset`` is resolved at construction: placement "center" with omitted
    offset becomes floor((logical - view)/2) per axis.
    """
    shape: Tuple[int, ...]
    offset: Tuple[int, ...]
    clear_outside: bool = False


@dataclass(frozen=True)
class IoViewSpec:
    input: Optional[IoViewSide] = None
    output: Optional[IoViewSide] = None


@dataclass(frozen=True)
class ZeroPadStage:
    """Inclusive start / exclusive end rect per axis
    (reference: src/runtime/zero_pad.js:11-40)."""
    start: Tuple[int, ...]
    end: Tuple[int, ...]


@dataclass(frozen=True)
class ZeroPadSpec:
    read: Optional[ZeroPadStage] = None
    write: Optional[ZeroPadStage] = None


@dataclass(frozen=True)
class ChannelLane:
    """WHD+CN channel-lane descriptor (reference: layout_semantics.js:120-232
    and fftconv channelPolicy, fftconv.js:213-281)."""
    channels: int
    channel_index: int = 0
    channel_stride_elements: Optional[int] = None  # default: prod(side shape)
    batch_stride_elements: Optional[int] = None    # default: channels * channel_stride
    offset_elements: int = 0
    kernel_step_channels: int = 1  # output side of fftconv only


@dataclass(frozen=True)
class LayoutSpec:
    """Strided/offset layout (reference: docs/API.md:17-49).

    When any field is set, exec operates on flat 1-D element buffers for that
    side (complex64 element units for complex domains, f32 for real) and
    gathers/scatters via the stride map — the XLA analog of the reference's
    strided gather/scatter kernels (src/kernels/strided_complex.js).
    """
    input_strides: Optional[Tuple[int, ...]] = None
    output_strides: Optional[Tuple[int, ...]] = None
    input_offset: int = 0
    output_offset: int = 0
    input_batch_stride: Optional[int] = None
    output_batch_stride: Optional[int] = None
    whdcn_input: Optional[ChannelLane] = None
    whdcn_output: Optional[ChannelLane] = None

    @property
    def is_trivial(self) -> bool:
        return self == LayoutSpec()


@dataclass(frozen=True)
class FftConvSpec:
    mode: str = "convolution"
    boundary: str = "circular"
    kernel_shape: Optional[Tuple[int, ...]] = None   # default = shape
    kernel_count: int = 1
    output_layout: str = "kernel-major"
    channel_input: Optional[ChannelLane] = None
    channel_output: Optional[ChannelLane] = None
    output_kernel_stride_elements: Optional[int] = None
    # overlap-save streaming route for long signals with small kernels
    # (auto: selected when shape is 1-D-huge and the kernel is small)
    overlap_save: str = "auto"                       # auto|on|off
    overlap_block: Optional[int] = None              # FFT block length override


@dataclass(frozen=True)
class Conv2dSpec:
    kernel_size: int = 3
    kernel_type: str = "real"         # "real" | "complex"
    padding: str = "same"             # "valid" | "same" | "explicit"
    pad: Optional[Tuple[int, int, int, int]] = None  # [top, bottom, left, right]
    boundary: str = "zero"


@dataclass(frozen=True)
class TuningSpec:
    """Performance knobs — the TPU reinterpretation of the reference's tuning
    surface (docs/API.md:88-104).  Binding-size knobs become VMEM budgets;
    route forcing selects between the fused Pallas path, staged XLA path, and
    HBM four-step decomposition."""
    rader_max_prime: int = 4096
    force_bluestein_axes: Tuple[int, ...] = ()
    force_rader_axes: Tuple[int, ...] = ()
    max_fused_elements: Optional[int] = None   # VMEM line budget override (complex elems)
    vmem_limit_bytes: Optional[int] = None
    impl: str = "auto"                         # auto (the Hopper kernels, as pallas-auto) | pallas | pallas-auto | xla
    large_route: str = "auto"                  # "auto" | "chunk" | "out-of-core"
    # Smooth axes >= this take the four-step einsum route
    # (core/axis.FourStepAxisPlan) unless a kernel serves them.
    four_step_min_n: int = 1 << 16
    # reference knob disableOutOfCoreFourStep — here it actually disables
    # the four-step route (like largeRoute="chunk" but scoped to the knob)
    disable_four_step: bool = False
    max_sub_length: int = 32                   # matmul sub-DFT cap (MXU tile friendliness)
    batch_tile: Optional[int] = None           # fused-kernel lines per grid step
    dct_fft_min_n: int = 512                   # dct2/3, dst2/3 axes >= this use the FFT route
    fused_precision: str = "highest"           # fused-kernel matmul passes: highest|default
    fused_variant: str = "v1"                  # fused-kernel formulation: v1|v2 (see core/fused.py)
    # Contraction precision of the JAX package's einsum pipeline.  "auto"
    # resolves at spec normalization: "highest" for f32 plans, "default"
    # for bf16-storage plans.  The port always contracts in full f32 and
    # records any other value as an ignored TPU knob.
    matmul_precision: str = "auto"             # auto|highest|high|default
    # Planner effort (FFTW-style): "estimate" routes statically; "measure"
    # times a small candidate set on the live device at plan build and
    # returns the fastest (runtime/measure.py), cached + snapshot-persisted.
    rigor: str = "estimate"                    # estimate|measure
    # Einsum-operand / batch-chunk bound override (complex elements) of the
    # JAX package.  Validation keeps its range check ([2^12, 2^22]) so both
    # packages accept and reject the same options; the port does not chunk
    # and records the key as an ignored TPU knob.
    chunk_elems: Optional[int] = None
    # WebGPU-specific reference knobs accepted-and-recorded as no-ops so a
    # reference-style options dict runs unmodified (VERDICT r1 #8); each key
    # shows up as route reason "ignored-webgpu-knob:<key>"
    ignored_webgpu_knobs: Tuple[str, ...] = ()


@dataclass(frozen=True)
class PlanSpec:
    plan_type: str
    shape: Tuple[int, ...]
    direction: str = "forward"
    batch: int = 1
    normalize: str = "none"
    precision: str = "f32"
    in_place: bool = False
    layout: LayoutSpec = field(default_factory=LayoutSpec)
    io_view: IoViewSpec = field(default_factory=IoViewSpec)
    zero_pad: ZeroPadSpec = field(default_factory=ZeroPadSpec)
    fft_conv: Optional[FftConvSpec] = None
    conv: Optional[Conv2dSpec] = None
    tuning: TuningSpec = field(default_factory=TuningSpec)

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def n_total(self) -> int:
        return math.prod(self.shape)


# ---------------------------------------------------------------------------
# Normalization from user-facing kwargs / dicts
# ---------------------------------------------------------------------------

def _norm_io_side(side: Optional[Dict[str, Any]], shape: Tuple[int, ...],
                  is_output: bool, name: str) -> Optional[IoViewSide]:
    if side is None:
        return None
    _check(isinstance(side, dict), f"{name} must be a dict")
    _check("shape" in side, f"{name} requires a 'shape' entry")
    vshape = _pos_int_tuple(side["shape"], f"{name}.shape")
    rank = len(shape)
    _check(len(vshape) == rank, f"{name}.shape must have rank {rank}")
    placement = side.get("placement", "start")
    _check(placement in ("start", "center"), f"{name}.placement must be start|center")
    off = side.get("offset")
    if off is None:
        if placement == "center":
            off = tuple((shape[d] - vshape[d]) // 2 for d in range(rank))
        else:
            off = (0,) * rank
    else:
        # offsets may be negative: they place the view origin within the
        # logical domain (reference: src/runtime/ioview.js:19-27 accepts any
        # integers; kernels clip per-element)
        _check(isinstance(off, (tuple, list)) and len(off) == rank,
               f"{name}.offset must have rank {rank}")
        off = tuple(int(o) for o in off)
    # Views may be smaller or larger than the logical domain; the overlapping
    # region must be non-empty in-bounds per reference ioview semantics.
    clear_outside = bool(side.get("clearOutside", side.get("clear_outside", False)))
    _check(not (clear_outside and not is_output), f"{name}: clearOutside is output-only")
    return IoViewSide(shape=vshape, offset=off, clear_outside=clear_outside)


def _norm_zero_stage(stage: Optional[Dict[str, Any]], domain: Tuple[int, ...],
                     name: str) -> Optional[ZeroPadStage]:
    if stage is None:
        return None
    _check(isinstance(stage, dict), f"{name} must be a dict")
    rank = len(domain)
    start = stage.get("start", (0,) * rank)
    end = stage.get("end", tuple(domain))
    _check(len(start) == rank and len(end) == rank,
           f"{name}.start/end must have rank {rank}")
    start = tuple(int(s) for s in start)
    end = tuple(int(e) for e in end)
    for d in range(rank):
        _check(0 <= start[d] <= end[d] <= domain[d],
               f"{name}: require 0 <= start <= end <= domain per axis; "
               f"got start={start} end={end} domain={domain}")
    if start == (0,) * rank and end == tuple(domain):
        return None  # full-range no-op dropped (reference: zero_pad.js:27-38)
    return ZeroPadStage(start=start, end=end)


def _norm_channel_lane(d: Optional[Dict[str, Any]], name: str,
                       output_side: bool = False) -> Optional[ChannelLane]:
    if d is None:
        return None
    _check(isinstance(d, dict), f"{name} must be a dict")
    _check("channels" in d, f"{name}.channels is required")
    ch = int(d["channels"])
    _check(ch >= 1, f"{name}.channels must be >= 1")
    idx = int(d.get("channelIndex", d.get("channel_index", 0)))
    _check(0 <= idx < ch, f"{name}.channelIndex must be in [0, channels)")
    step = int(d.get("kernelStepChannels", d.get("kernel_step_channels", 1)))
    _check(step >= 1, f"{name}.kernelStepChannels must be >= 1")
    _check(output_side or step == 1, f"{name}: kernelStepChannels is output-only")
    cs = d.get("channelStrideElements", d.get("channel_stride_elements"))
    bs = d.get("batchStrideElements", d.get("batch_stride_elements"))
    off = int(d.get("offsetElements", d.get("offset_elements", 0)))
    _check(off >= 0, f"{name}.offsetElements must be >= 0")
    return ChannelLane(
        channels=ch, channel_index=idx,
        channel_stride_elements=None if cs is None else int(cs),
        batch_stride_elements=None if bs is None else int(bs),
        offset_elements=off, kernel_step_channels=step,
    )


def _norm_layout(layout: Optional[Dict[str, Any]], rank: int) -> LayoutSpec:
    if layout is None:
        return LayoutSpec()
    _check(isinstance(layout, dict), "layout must be a dict")
    d = dict(layout)
    d.pop("interleavedComplex", None)  # storage detail of the reference; N/A here
    _KNOWN = {"strides", "inputStrides", "outputStrides",
              "offsetElements", "inputOffsetElements", "outputOffsetElements",
              "batchStrideElements", "inputBatchStrideElements",
              "outputBatchStrideElements", "whdcn"}
    unknown = set(d) - _KNOWN
    _check(not unknown,
           f"unknown layout key(s) {sorted(unknown)}; layout takes flat "
           "keys (inputStrides/outputStrides/strides, "
           "inputOffsetElements/..., batchStrideElements/..., whdcn), "
           "not nested input/output dicts")

    def strides(key_shared, key_side):
        v = d.get(key_side, d.get(key_shared))
        if v is None:
            return None
        t = tuple(int(s) for s in v)
        _check(len(t) == rank, f"layout strides must have rank {rank}")
        _check(all(s >= 1 for s in t), "layout strides must be positive")
        return t

    whdcn = d.get("whdcn")
    wh_in = wh_out = None
    if whdcn is not None:
        shared = {k: v for k, v in whdcn.items() if k not in ("input", "output")}
        wh_in = _norm_channel_lane(whdcn.get("input", shared or None), "layout.whdcn.input")
        wh_out = _norm_channel_lane(whdcn.get("output", shared or None), "layout.whdcn.output")

    return LayoutSpec(
        input_strides=strides("strides", "inputStrides"),
        output_strides=strides("strides", "outputStrides"),
        input_offset=int(d.get("inputOffsetElements", d.get("offsetElements", 0))),
        output_offset=int(d.get("outputOffsetElements", d.get("offsetElements", 0))),
        input_batch_stride=(int(d["inputBatchStrideElements"])
                            if "inputBatchStrideElements" in d
                            else (int(d["batchStrideElements"]) if "batchStrideElements" in d else None)),
        output_batch_stride=(int(d["outputBatchStrideElements"])
                             if "outputBatchStrideElements" in d
                             else (int(d["batchStrideElements"]) if "batchStrideElements" in d else None)),
        whdcn_input=wh_in,
        whdcn_output=wh_out,
    )


# Reference tuning keys that only make sense on a WebGPU device.  Accepted
# and recorded as no-ops (route reason "ignored-webgpu-knob:<key>") so the
# reference's own test/bench option dicts run unmodified against this API
# (reference knob surface: docs/API.md:88-104).
WEBGPU_ONLY_TUNING_KEYS = frozenset({
    "workgroupSizeX", "maxStorageBufferBindingSize", "transposeMinElements",
    "disableTranspose",
    "preferOutOfCoreForStrided", "largeChunkMaxBatches",
    "swapTo2Stage4Step", "swapTo3Stage4Step", "groupedBatch",
    "outOfCoreBurstWindows",
})

# fftConv.tuning keys that chunk WebGPU dispatches in the reference
# (fftconv.js:283-305); XLA fuses the pointwise multiply and extract copy
# into the surrounding FFT passes, so they are accepted-and-recorded no-ops
# (route reason "ignored-webgpu-knob:fftConv.tuning.<key>").
FFTCONV_WEBGPU_TUNING_KEYS = frozenset({
    "pointwiseChunkElements", "extractCopyChunkElements",
})

# fftConv.tuning keys this backend consumes (overlap-save streaming route).
_FFTCONV_TUNING_KEYS = frozenset({
    "overlapSave", "overlap_save", "overlapBlock", "overlap_block",
})


def _norm_tuning(t: Optional[Dict[str, Any]]) -> TuningSpec:
    if t is None:
        return TuningSpec()
    _check(isinstance(t, dict), "tuning must be a dict")
    kw = {}
    mapping = {
        "raderMaxPrime": "rader_max_prime",
        "forceBluesteinAxes": "force_bluestein_axes",
        "forceRaderAxes": "force_rader_axes",
        "maxFusedElements": "max_fused_elements",
        "vmemLimitBytes": "vmem_limit_bytes",
        "impl": "impl",
        "largeRoute": "large_route",
        "maxSubLength": "max_sub_length",
        "batchTile": "batch_tile",
        "fourStepMinN": "four_step_min_n",
        "disableOutOfCoreFourStep": "disable_four_step",
        "matmulPrecision": "matmul_precision",
        "dctFftMinN": "dct_fft_min_n",
        "chunkElements": "chunk_elems",
    }
    ignored = []
    for k, v in t.items():
        if k in WEBGPU_ONLY_TUNING_KEYS:
            ignored.append(k)
            continue
        key = mapping.get(k, k)
        _check(key in TuningSpec.__dataclass_fields__, f"unknown tuning key {k!r}")
        if key in ("force_bluestein_axes", "force_rader_axes"):
            v = tuple(int(a) for a in v)
        kw[key] = v
    if ignored:
        kw["ignored_webgpu_knobs"] = tuple(sorted(ignored))
    ts = TuningSpec(**kw)
    return validate_tuning(ts)


def validate_tuning(ts: "TuningSpec") -> "TuningSpec":
    """Enum/range validation on an already-constructed TuningSpec.

    Called by _norm_tuning for user option dicts, AND by every path that
    rebuilds a TuningSpec from stored data — the plan-cache snapshot
    import (runtime/cache._rebuild_spec) and the measured-planner cache
    apply (runtime/measure.run_measure) — so values that are no longer
    legal (e.g. a chunkElements recorded by an older release) cannot
    re-enter through a side door.
    """
    _check(ts.impl in ("auto", "pallas", "pallas-auto", "xla"),
           "tuning.impl must be auto|pallas|pallas-auto|xla")
    _check(ts.large_route in ("auto", "chunk", "out-of-core"),
           "tuning.largeRoute must be auto|chunk|out-of-core")
    _check(ts.matmul_precision in ("auto", "highest", "high", "default"),
           "tuning.matmulPrecision must be auto|highest|high|default")
    _check(ts.rigor in ("estimate", "measure"),
           "tuning.rigor must be estimate|measure")
    if ts.chunk_elems is not None:
        # Upper cap is the JAX package's default operand bound: the knob
        # may only lower it there, and the port rejects what it rejects.
        cap_pow = OPERAND_CHUNK_ELEMS.bit_length() - 1
        _check(isinstance(ts.chunk_elems, int) and not isinstance(ts.chunk_elems, bool)
               and (1 << 12) <= ts.chunk_elems <= OPERAND_CHUNK_ELEMS,
               f"tuning.chunkElements must be an int in [2^12, 2^{cap_pow}] "
               f"(2^{cap_pow} is the default operand bound and the largest "
               "size validated correct on this backend; larger composed "
               "operands have miscompiled silently and measured slower)")
    return ts


def resolve_auto_tuning(tuning: TuningSpec, precision: str) -> TuningSpec:
    """Resolve 'auto' tuning values to their concrete per-plan choices.

    Shared by normalize_spec and the snapshot rebuild path so cached specs
    always key on resolved values (an unresolved 'auto' would never equal a
    normalize_spec-produced spec and would silently defeat snapshot prewarm).
    """
    if tuning.matmul_precision == "auto":
        # bf16-storage inputs are already 8-bit-mantissa rounded, so the JAX
        # package contracts them in 1-pass bf16; f32 plans keep the full-f32
        # scheme that meets the 1e-5 accuracy bar
        tuning = dataclasses.replace(
            tuning, matmul_precision=(
                "default" if precision == "bf16-storage" else "highest"))
    return tuning


def normalize_spec(opts: Dict[str, Any]) -> PlanSpec:
    """Validate and normalize a createPlan-style options dict into a PlanSpec.

    Accepts both reference-style camelCase keys and snake_case.
    """
    _check(isinstance(opts, dict), "plan options must be a dict")
    d = dict(opts)
    plan_type = d.get("type", d.get("plan_type"))
    _check(plan_type in PLAN_TYPES, f"type must be one of {PLAN_TYPES}, got {plan_type!r}")
    shape = _pos_int_tuple(d.get("shape"), "shape")
    rank = len(shape)

    direction = d.get("direction", "forward")
    if plan_type in ("fftconv", "conv2d"):
        direction = "forward"  # ignored by these types (docs/API.md:13)
    _check(direction in DIRECTIONS, f"direction must be forward|inverse, got {direction!r}")
    if plan_type == "r2c":
        _check(direction == "forward", "r2c supports direction:'forward' only")
    if plan_type == "c2r":
        _check(direction == "inverse", "c2r supports direction:'inverse' only")

    batch = int(d.get("batch", 1))
    _check(batch >= 1, "batch must be a positive int")

    normalize = d.get("normalize", "none")
    _check(normalize in NORMALIZE_MODES, f"normalize must be one of {NORMALIZE_MODES}")

    precision = d.get("precision", "f32")
    if precision == "f16-storage":
        precision = "bf16-storage"  # TPU mapping: bf16 storage, f32 compute
    _check(precision in PRECISIONS, f"precision must be one of {PRECISIONS}")
    if plan_type in ("fftconv", "conv2d"):
        _check(precision == "f32", f"{plan_type} supports precision 'f32' only")

    in_place = bool(d.get("inPlace", d.get("in_place", False)))
    _check(not in_place or plan_type == "c2c", "inPlace is only supported on c2c")

    layout = _norm_layout(d.get("layout"), rank)
    if not layout.is_trivial:
        _check(plan_type not in ("fftconv", "conv2d"),
               f"{plan_type} does not support custom layout strides")
        _check(precision == "f32", "strided layout requires precision 'f32'")

    # Domains for ioView / zeroPad validation per type (docs/API.md:147-152,
    # 210-222): r2c reads real `shape` and writes the packed domain; c2r is
    # the mirror; dct/dst use the real logical domain on both sides.
    packed = (shape[0] // 2 + 1,) + shape[1:]
    if plan_type == "r2c":
        in_domain, out_domain = shape, packed
    elif plan_type == "c2r":
        in_domain, out_domain = packed, shape
    else:
        in_domain = out_domain = shape

    fft_conv = None
    fc_ignored_knobs: list = []
    if plan_type == "fftconv":
        fc = d.get("fftConv", d.get("fft_conv")) or {}
        _check(isinstance(fc, dict), "fftConv must be a dict")
        _FC_KNOWN = {"mode", "boundary", "kernelShape", "kernel_shape",
                     "kernelCount", "kernel_count", "outputLayout",
                     "output_layout", "channelPolicy", "channel_policy",
                     "tuning", "outputKernelStrideElements"}
        fc_unknown = set(fc) - _FC_KNOWN
        _check(not fc_unknown,
               f"unknown fftConv key(s) {sorted(fc_unknown)}")
        mode = fc.get("mode", "convolution")
        _check(mode in CONV_MODES, f"fftConv.mode must be one of {CONV_MODES}")
        boundary = fc.get("boundary", "circular")
        _check(boundary in BOUNDARIES, f"fftConv.boundary must be one of {BOUNDARIES}")
        kshape = fc.get("kernelShape", fc.get("kernel_shape"))
        kshape = _pos_int_tuple(kshape, "fftConv.kernelShape") if kshape is not None else None
        if kshape is not None:
            _check(len(kshape) == rank, f"fftConv.kernelShape must have rank {rank}")
        eff_k = kshape if kshape is not None else shape
        if boundary == "circular":
            _check(all(eff_k[a] <= shape[a] for a in range(rank)),
                   "kernelShape must be <= shape for circular boundary")
        if boundary == "linear-valid":
            _check(all(shape[a] - eff_k[a] + 1 > 0 for a in range(rank)),
                   "linear-valid requires kernelShape <= shape")
        kcount = int(fc.get("kernelCount", fc.get("kernel_count", 1)))
        _check(kcount >= 1, "fftConv.kernelCount must be >= 1")
        out_layout = fc.get("outputLayout", fc.get("output_layout", "kernel-major"))
        _check(out_layout in OUTPUT_LAYOUTS, f"fftConv.outputLayout must be one of {OUTPUT_LAYOUTS}")
        cp = fc.get("channelPolicy", fc.get("channel_policy")) or {}
        ch_in = _norm_channel_lane(cp.get("input"), "channelPolicy.input")
        ch_out = _norm_channel_lane(cp.get("output"), "channelPolicy.output", output_side=True)
        _check(not (cp and d.get("layout", {}).get("whdcn")),
               "use fftConv.channelPolicy or layout.whdcn, not both")
        tun = fc.get("tuning") or {}
        for k in tun:
            _check(k in _FFTCONV_TUNING_KEYS or k in FFTCONV_WEBGPU_TUNING_KEYS,
                   f"unknown fftConv.tuning key {k!r}")
        fc_ignored_knobs.extend(f"fftConv.tuning.{k}" for k in tun
                                if k in FFTCONV_WEBGPU_TUNING_KEYS)
        fft_conv = FftConvSpec(
            mode=mode, boundary=boundary, kernel_shape=kshape, kernel_count=kcount,
            output_layout=out_layout, channel_input=ch_in, channel_output=ch_out,
            output_kernel_stride_elements=(
                int(fc["outputKernelStrideElements"])
                if "outputKernelStrideElements" in fc else None),
            overlap_save=tun.get("overlapSave", tun.get("overlap_save", "auto")),
            overlap_block=(int(tun.get("overlapBlock",
                                       tun.get("overlap_block")))
                           if ("overlapBlock" in tun
                               or "overlap_block" in tun) else None),
        )
        _check(fft_conv.overlap_save in ("auto", "on", "off"),
               "fftConv.tuning.overlapSave must be auto|on|off")
        if fft_conv.overlap_block is not None:
            _check(fft_conv.overlap_block >= 2,
                   "fftConv.tuning.overlapBlock must be >= 2")
        # zeroPad for fftconv lives in the FFT logical domain (fftShape)
        from .utils.mathref import fftconv_out_shape
        fshape, _, _ = fftconv_out_shape(shape, list(eff_k), boundary)
        in_domain = out_domain = tuple(fshape)

    conv = None
    if plan_type == "conv2d":
        _check(rank == 2, "conv2d shape must be [H, W]")
        c = d.get("conv")
        _check(isinstance(c, dict), "conv2d requires a conv object")
        ks = int(c.get("kernelSize", c.get("kernel_size", 0)))
        _check(ks in (1, 2, 3), "conv.kernelSize must be 1|2|3")
        ktype = c.get("kernelType", c.get("kernel_type", "real"))
        _check(ktype in ("real", "complex"), "conv.kernelType must be real|complex")
        padding = c.get("padding", "same")
        _check(padding in ("valid", "same", "explicit"), "conv.padding must be valid|same|explicit")
        boundary = c.get("boundary", "zero")
        _check(boundary == "zero", 'conv.boundary currently supports only "zero"')
        pad = c.get("pad")
        if padding == "explicit":
            _check(isinstance(pad, (tuple, list)) and len(pad) == 4,
                   'conv.pad must be [top,bottom,left,right] when padding="explicit"')
            pad = tuple(int(p) for p in pad)
            _check(all(p >= 0 for p in pad), "conv.pad entries must be non-negative")
        else:
            pad = None
        conv = Conv2dSpec(kernel_size=ks, kernel_type=ktype, padding=padding,
                          pad=pad, boundary=boundary)

    io = d.get("ioView", d.get("io_view")) or {}
    _check(isinstance(io, dict), "ioView must be a dict")
    _check(not (set(io) - {"input", "output"}),
           f"unknown ioView key(s) {sorted(set(io) - {'input', 'output'})}; "
           "ioView takes {'input': {...}, 'output': {...}}")
    io_view = IoViewSpec(
        input=_norm_io_side(io.get("input"), in_domain, False, "ioView.input"),
        output=_norm_io_side(io.get("output"), out_domain, True, "ioView.output"),
    )
    if io_view.input or io_view.output:
        # the reference's FftConvPlan constructor takes no user ioView either
        # (fftconv.js:308-318 destructures only shape/batch/.../fftConv/zeroPad);
        # its internal sub-plan ioViews are not a user surface
        _check(plan_type not in ("conv2d", "fftconv"),
               f"{plan_type} does not support ioView")

    zp = d.get("zeroPad", d.get("zero_pad")) or {}
    _check(isinstance(zp, dict), "zeroPad must be a dict")
    _check(not (set(zp) - {"read", "write"}),
           f"unknown zeroPad key(s) {sorted(set(zp) - {'read', 'write'})}; "
           "zeroPad takes {'read': {...}, 'write': {...}}")
    zero_pad = ZeroPadSpec(
        read=_norm_zero_stage(zp.get("read"), in_domain if plan_type != "fftconv" else in_domain,
                              "zeroPad.read"),
        write=_norm_zero_stage(zp.get("write"), out_domain, "zeroPad.write"),
    )
    if zero_pad.read or zero_pad.write:
        _check(plan_type != "conv2d", "conv2d does not support zeroPad")

    tuning = resolve_auto_tuning(_norm_tuning(d.get("tuning")), precision)
    if fc_ignored_knobs:
        tuning = dataclasses.replace(
            tuning, ignored_webgpu_knobs=tuple(sorted(
                set(tuning.ignored_webgpu_knobs) | set(fc_ignored_knobs))))

    return PlanSpec(
        plan_type=plan_type, shape=shape, direction=direction, batch=batch,
        normalize=normalize, precision=precision, in_place=in_place,
        layout=layout, io_view=io_view, zero_pad=zero_pad,
        fft_conv=fft_conv, conv=conv, tuning=tuning,
    )


def spec_to_dict(spec: PlanSpec) -> Dict[str, Any]:
    """Serializable descriptor of a spec (for plan-cache snapshots)."""
    return dataclasses.asdict(spec)
