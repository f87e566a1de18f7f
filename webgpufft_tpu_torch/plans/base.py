"""Plan object + staged execution pipeline.

Port of ``webgpufft_tpu/plans/base.py``.  A plan lives on one torch device:
its tables are tensors there, and ``plan(x)`` checks that ``x`` is a tensor
of the plan's storage dtype and input shape on that device before it runs.
The input shape is interleaved ``(batch, *shape, 2)`` for complex sides and
``(batch, *shape)`` for real ones; a side with a strided layout takes a flat
``(L, 2)`` or ``(L,)`` buffer instead (or a ``BufferView`` of one).

A plan returns a fresh tensor unless the caller gives it somewhere to write:
``out=`` is written in place and returned, and an ``inPlace`` c2c plan
writes its result into the input tensor and returns that.  Exec-time offsets
are Python ints and become slices or index shifts; nothing on the exec path
reads a device value back.

Plans are differentiable: every stage is a torch op or one of the two kernel
``torch.autograd.Function``s (``core/fused.py``, ``core/fused_cols.py``), so
``torch.autograd.grad`` and ``torch.func.grad/vjp/jvp/vmap`` compose with
``plan(x)``, for the input and for an fftconv or conv2d ``kernel=`` payload.
As with torch's own ``out=``, an ``out=`` tensor that requires grad raises,
and values merged into a caller's ``out=`` carry no gradient to what ``out``
held before; ``inPlace`` on a leaf that requires grad raises torch's own
in-place error.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..spec import PlanError, PlanSpec
from ..runtime import trace
from ..utils.bufferview import BufferView
from . import stages


@dataclass
class RouteInfo:
    """Routing/diagnostic metadata, field for field as in the JAX package."""
    mode: str = "xla"                      # "xla" | "pallas-fused" | "pallas-mixed" | ...
    impl: str = "xla"
    axis_kinds: Tuple[str, ...] = ()
    reasons: Tuple[str, ...] = ()
    attempts: Tuple[str, ...] = ()


class Plan:
    """Executable transform plan on ``device``; ``plan(x)`` runs it.

    ``input_shape`` is the expected input shape, ``(None,)`` for a flat
    strided-layout buffer, or None for a plan that validates its own input
    (conv2d takes real or interleaved data)."""

    supports_exec_offsets = False   # staged transform plans override
    in_place = False                # c2c inPlace: the result lands in the input tensor

    def __init__(self, spec: PlanSpec, consts: Dict[str, np.ndarray],
                 fn: Callable, route: RouteInfo, *, device: torch.device,
                 input_shape: Optional[Tuple], output_shape: Optional[Tuple],
                 input_interleaved: bool = True, needs_kernel: bool = False,
                 workspace_bytes: int = 0):
        self.spec = spec
        self.route = route
        self.device = device
        self.input_shape = input_shape
        self.input_interleaved = input_interleaved
        self.output_shape = output_shape
        self.needs_kernel = needs_kernel
        self._workspace_bytes = workspace_bytes
        self._fn = fn
        # static side metadata attached by build_staged_fn (absent on plans
        # with their own pipelines: fftconv, conv2d)
        self._in_need = getattr(fn, "in_need", None)
        self._out_need = getattr(fn, "out_need", None)
        self.accepts_out = getattr(fn, "accepts_out", False)
        self._consts = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                        for k, v in consts.items()}

    @property
    def consts(self) -> Dict[str, torch.Tensor]:
        """The plan's constant tables (name -> tensor on the plan's device)."""
        return dict(self._consts)

    def load_consts(self, tables: Dict[str, torch.Tensor]) -> "Plan":
        """Replace the plan's tables with ``tables`` (e.g. the JAX package's,
        converted by ``tables_from_reference``): same names and shapes.
        Each table takes the dtype of the plan's own, so index tables stay
        integer; a float table for an integer one, or the reverse, raises."""
        if set(tables) != set(self._consts):
            raise PlanError("load_consts: table names differ from the plan's",
                            missing=sorted(set(self._consts) - set(tables)),
                            unexpected=sorted(set(tables) - set(self._consts)))
        new = {}
        for k, v in tables.items():
            t = torch.as_tensor(v)
            want = self._consts[k].dtype
            if t.is_floating_point() != want.is_floating_point:
                raise PlanError(f"load_consts: table {k!r} has dtype {t.dtype}, "
                                f"the plan's has {want}")
            t = t.to(device=self.device, dtype=want).contiguous()
            if t.shape != self._consts[k].shape:
                raise PlanError(f"load_consts: table {k!r} has shape "
                                f"{tuple(t.shape)}, the plan's has "
                                f"{tuple(self._consts[k].shape)}")
            new[k] = t
        self._consts = new
        return self

    # -- execution ---------------------------------------------------------

    def __call__(self, x, kernel=None, out=None, **kw):
        return self.exec(x, kernel=kernel, out=out, **kw)

    def exec(self, x, kernel=None, out=None, input_offset_elements=None,
             output_offset_elements=None):
        """Run the plan on ``x``.

        ``input_offset_elements`` / ``output_offset_elements`` are exec-time
        element offsets.  On flat-layout sides they add to every gather or
        scatter index; on shaped sides that side is read or written as a
        contiguous flat buffer at the offset (the output then requires
        ``out=``).  ``x`` and ``out`` may be ``BufferView``s of flat
        buffers; a ``BufferView`` ``out`` returns the result split into its
        segments' shapes.
        """
        out_view = None
        if isinstance(x, BufferView):
            x = x.pack()
        if isinstance(out, BufferView):
            out_view = out
            out = out_view.pack()
        if trace.tracing():
            with trace.annotate(f"wgfft:{self.spec.plan_type}"):
                y = self._exec_inner(x, kernel, out, input_offset_elements,
                                     output_offset_elements)
        else:
            y = self._exec_inner(x, kernel, out, input_offset_elements,
                                 output_offset_elements)
        return out_view.unpack(y) if out_view is not None else y

    def _require_tensor(self, t, what: str):
        kind = self.spec.plan_type
        if not isinstance(t, torch.Tensor):
            raise PlanError(f"{kind}: expected a torch.Tensor for {what}, "
                            f"got {type(t).__name__}")
        if t.device != self.device:
            raise PlanError(f"{kind}: {what} is on {t.device}, the plan is on "
                            f"{self.device}", device=str(self.device))
        if what == "out=" and t.requires_grad:
            raise PlanError(f"{kind}: out= tensors that require grad are not "
                            "supported (the plan writes into out in place); "
                            "pass out.detach() or drop out=")

    def _exec_inner(self, x, kernel=None, out=None, in_off=None, out_off=None):
        kind = self.spec.plan_type
        self._require_tensor(x, "input")
        if out is not None:
            self._require_tensor(out, "out=")
            if not (self.accepts_out or out_off is not None):
                raise PlanError(
                    f"{kind}: out= requires an output side that can merge "
                    "(custom strides/whdcn, an ioView output, or an exec-time "
                    "output offset); this plan returns fresh tensors")
        if in_off is not None or out_off is not None:
            if not self.supports_exec_offsets:
                raise PlanError(f"{kind}: exec offsets require a staged transform plan")
            if in_off is not None:
                in_off = int(in_off)
                if in_off < 0:
                    raise PlanError("input_offset_elements must be >= 0")
                want_rank = 2 if self.input_interleaved else 1
                if x.ndim != want_rank:
                    raise PlanError(
                        f"{kind}: input_offset_elements expects a flat buffer "
                        f"of rank {want_rank}, got shape {tuple(x.shape)}")
                if x.shape[0] < in_off + self._in_need:
                    raise PlanError(
                        "flat input too small for runtime offset: need "
                        f"{in_off + self._in_need} elements, got {x.shape[0]}",
                        input_offset_elements=in_off, need=self._in_need)
            if out_off is not None:
                out_off = int(out_off)
                if out_off < 0:
                    raise PlanError("output_offset_elements must be >= 0")
                if out is None:
                    raise PlanError("output_offset_elements requires out= (a "
                                    "concrete output buffer to offset into)")
                if out.shape[0] < out_off + self._out_need:
                    raise PlanError(
                        "out buffer too small for runtime offset: need "
                        f"{out_off + self._out_need} elements, got {out.shape[0]}",
                        output_offset_elements=out_off, need=self._out_need)
        if self.input_shape is not None:
            if in_off is None:
                validate_input_shape(self, x, self.input_shape, self.input_interleaved,
                                     self.spec.precision)
            want = stages.expect_dtype(self.spec.precision)
            if x.dtype != want:
                raise PlanError(
                    f"{kind}: expected input dtype {want} for precision "
                    f"{self.spec.precision!r}, got {x.dtype}",
                    precision=self.spec.precision)
        args = (self._consts, x.contiguous())
        if self.needs_kernel:
            if kernel is None:
                raise PlanError(f"{kind} exec requires kernel=")
            args += (self._coerce_kernel(kernel),)
        elif kernel is not None:
            raise PlanError(f"{kind} exec does not take kernel=")
        kwargs = {k: v for k, v in (("out", out), ("in_off", in_off), ("out_off", out_off))
                  if v is not None}
        y = self._fn(*args, **kwargs)
        if self.in_place and not kwargs and y.shape == x.shape and y.dtype == x.dtype:
            x.copy_(y)
            return x
        return y

    def _kernel_tensor(self, kernel) -> torch.Tensor:
        """A kernel payload as a float32 tensor on the plan's device: a
        tensor must already be there; host arrays and lists are uploaded."""
        if isinstance(kernel, torch.Tensor):
            self._require_tensor(kernel, "kernel=")
            return kernel.float()
        return torch.as_tensor(np.asarray(kernel, dtype=np.float32), device=self.device)

    def _coerce_kernel(self, kernel):
        return self._kernel_tensor(kernel)

    # -- introspection -----------------------------------------------------

    _plan_cache = None  # set by PlanCache.get_or_create

    def get_pipeline_cache_snapshot(self):
        """Snapshot of the plan cache this plan was created through: pass it
        to a later ``create_plan(..., cache={"snapshot": snap})`` or
        ``import_plan_cache_snapshot`` to prewarm."""
        from ..runtime.cache import export_plan_cache_snapshot
        return export_plan_cache_snapshot(cache=self._plan_cache)

    def get_workspace_size_bytes(self) -> int:
        """Estimated peak intermediate footprint.  Informational: torch's
        caching allocator owns the temporaries."""
        return self._workspace_bytes

    def destroy(self):
        """Release the plan's tables; the plan cannot run afterwards."""
        self._consts = {}
        self._fn = None

    @property
    def large_route_mode(self) -> str:
        return self.route.mode

    @property
    def large_route_reasons(self) -> Tuple[str, ...]:
        return self.route.reasons


# ---------------------------------------------------------------------------
# Staged pipeline builder shared by c2c / r2c / c2r / dct plans
# ---------------------------------------------------------------------------

@dataclass
class SideInfo:
    domain: Tuple[int, ...]          # logical domain of this side
    interleaved: bool                # complex (trailing 2) vs real
    strides: Optional[Tuple[int, ...]] = None
    offset: int = 0
    batch_stride: int = 0
    has_layout: bool = False         # flat-buffer mode for this side


def resolve_sides(spec: PlanSpec, in_domain, out_domain,
                  in_interleaved: bool, out_interleaved: bool):
    """Resolve per-side layout and physical shapes."""
    lay = spec.layout
    in_view, out_view = spec.io_view.input, spec.io_view.output
    in_phys = tuple(in_view.shape) if in_view else tuple(in_domain)
    out_phys = tuple(out_view.shape) if out_view else tuple(out_domain)

    def side(phys, strides, offset, bstride, lane, interleaved, domain):
        has = (strides is not None or offset != 0 or bstride is not None
               or lane is not None)
        if has:
            st, off, bs = stages.resolve_side_layout(phys, strides, offset, bstride, lane)
            return SideInfo(tuple(domain), interleaved, st, off, bs, True)
        return SideInfo(tuple(domain), interleaved)

    s_in = side(in_phys, lay.input_strides, lay.input_offset,
                lay.input_batch_stride, lay.whdcn_input, in_interleaved, in_domain)
    s_out = side(out_phys, lay.output_strides, lay.output_offset,
                 lay.output_batch_stride, lay.whdcn_output, out_interleaved, out_domain)
    return s_in, s_out, in_phys, out_phys


def build_staged_fn(spec: PlanSpec, core_fn: Callable, in_domain, out_domain,
                    in_interleaved: bool, out_interleaved: bool, device: torch.device):
    """Wrap a core transform with the full staging pipeline:

    storage-load -> [strided gather] -> [ioView embed] -> zeroPad.read ->
    core -> zeroPad.write -> [ioView extract] -> [strided scatter] ->
    storage-store

    Returns (fn, in_shape, out_shape, s_in, s_out).  The gather and scatter
    index tensors are built here, once, on ``device``.
    """
    s_in, s_out, in_phys, out_phys = resolve_sides(
        spec, in_domain, out_domain, in_interleaved, out_interleaved)
    batch, zp = spec.batch, spec.zero_pad
    in_view, out_view = spec.io_view.input, spec.io_view.output
    in_tail = (2,) if in_interleaved else ()
    out_tail = (2,) if out_interleaved else ()

    gather = (stages.FlatLayout(in_phys, s_in.strides, s_in.offset, s_in.batch_stride,
                                batch, in_interleaved, device)
              if s_in.has_layout else None)
    # the output side as a flat layout: the plan's own, or (for an exec-time
    # offset on a shaped side with a keep-outside crop) the contiguous one
    if s_out.has_layout:
        o_st, o_off, o_bs = s_out.strides, s_out.offset, s_out.batch_stride
    else:
        o_st, o_off, o_bs = stages.default_strides(out_phys), 0, math.prod(out_phys)
    keep_outside = out_view is not None and not out_view.clear_outside
    scatter_cache: Dict[bool, Optional[stages.FlatLayout]] = {}

    def scatter_layout(restricted: bool):
        """The output side's layout, or its restriction to the view/logical
        overlap (None when that is empty), built at first use."""
        if restricted not in scatter_cache:
            sh, off = tuple(out_phys), o_off
            if restricted:
                ov = stages.view_overlap(out_view, out_domain)
                if ov is None:
                    scatter_cache[restricted] = None
                    return None
                sh = tuple(s.stop - s.start for s in ov[0])
                off = off + sum(ov[0][d].start * o_st[d] for d in range(len(o_st)))
            scatter_cache[restricted] = stages.FlatLayout(
                sh, o_st, off, o_bs, batch, out_interleaved, device)
        return scatter_cache[restricted]

    in_need = gather.need if gather else batch * math.prod(in_phys)
    out_need = (stages.layout_need(out_phys, o_st, o_off, o_bs, batch)
                if s_out.has_layout else batch * math.prod(out_phys))

    def fn(consts, x, out=None, in_off=None, out_off=None):
        x = stages.load_storage(x, spec.precision)
        if gather is not None:
            x = stages.gather_flat(x, gather, in_off)
        elif in_off is not None:
            # exec-time offset on a shaped side: a contiguous slice of the
            # flat buffer, no index tensor
            x = x[in_off:in_off + in_need].reshape((batch,) + tuple(in_phys) + in_tail)
        if in_view is not None:
            x = stages.embed_view(x, in_view, in_domain, in_interleaved)
        x = stages.zero_pad_apply(x, zp.read, in_domain, in_interleaved)
        y = core_fn(x, consts)
        y = stages.zero_pad_apply(y, zp.write, out_domain, out_interleaved)
        if out_view is not None:
            y = stages.extract_view(y, out_view, out_domain, out_interleaved)
        if not s_out.has_layout and out_off is not None and not keep_outside:
            # shaped side + exec-time offset, whole-block write: one
            # contiguous copy into the caller's buffer
            vals = y.reshape((-1, 2) if out_interleaved else (-1,))
            out[out_off:out_off + vals.shape[0]] = vals.to(out.dtype)
            y = out
        elif s_out.has_layout or out_off is not None:
            restricted = keep_outside and out is not None
            layout = scatter_layout(restricted)
            if layout is None:          # keep-outside, empty overlap
                return stages.store_storage(out, spec.precision)
            if restricted:
                vsl = stages.view_overlap(out_view, out_domain)[0]
                y = y[(slice(None),) + vsl]
            y = stages.scatter_flat(y, layout, out=out, min_len=out_need,
                                    extra_offset=out_off)
        elif out_view is not None and out is not None:
            if tuple(out.shape) != tuple(y.shape):
                raise PlanError(
                    f"{spec.plan_type}: out= has shape {tuple(out.shape)}, the "
                    f"output view has {tuple(y.shape)}")
            if keep_outside:
                y = stages.merge_view_into(y, out_view, out_domain, out_interleaved, out)
            else:
                # clearOutside=true: the extracted view (zeros outside the
                # logical overlap) replaces the caller's buffer
                y = out.copy_(y)
        return stages.store_storage(y, spec.precision)

    in_shape = (None,) if s_in.has_layout else (batch,) + tuple(in_phys) + in_tail
    out_shape = (None,) if s_out.has_layout else (batch,) + tuple(out_phys) + out_tail
    # static metadata for eager exec-time validation (Plan._exec_inner):
    # minimum flat-element footprint of each side, excluding runtime offsets
    fn.in_need, fn.out_need = in_need, out_need
    fn.accepts_out = s_out.has_layout or out_view is not None
    return fn, in_shape, out_shape, s_in, s_out


def validate_input_shape(plan: Plan, x, expect_shape, interleaved: bool, precision: str):
    """Eager-side shape validation with reference-style rich errors."""
    if tuple(expect_shape) == (None,):
        want_rank = 2 if interleaved else 1
        if x.ndim != want_rank:
            raise PlanError(
                f"{plan.spec.plan_type}: strided layout expects a flat buffer of "
                f"rank {want_rank}, got shape {tuple(x.shape)}")
        return
    if tuple(x.shape) != tuple(expect_shape):
        raise PlanError(
            f"{plan.spec.plan_type}: expected input shape {tuple(expect_shape)} "
            f"(batch, *physical{', 2' if interleaved else ''}), got {tuple(x.shape)}",
            plan_type=plan.spec.plan_type, shape=plan.spec.shape,
            batch=plan.spec.batch, precision=precision,
            route_mode=plan.route.mode, route_reasons=plan.route.reasons)
