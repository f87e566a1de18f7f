"""Plan-level distributed execution: ``create_distributed_plan``.

Port of ``webgpufft_tpu/parallel/plans.py``: the building blocks of
``parallel/sharded.py`` behind the options dict ``create_plan`` takes:

    mesh = sharded.make_mesh({"dp": 2, "sp": 4})
    plan = create_distributed_plan({"type": "c2c", "shape": [1 << 20],
                                    "batch": 8, "normalize": "unitary"},
                                   mesh=mesh, batch_axis="dp", seq_axis="sp")
    y = plan(x)          # a DTensor; y.full_tensor() is (batch, n, 2)

Modes, as in the JAX package:

- ``seq_axis`` (one mesh dim name): the transform is distributed over it
  (c2c / r2c / c2r / the eight trig types at any rank and axis-0 length;
  fftconv at any rank with every boundary, ``kernelCount`` and the
  channel-lane and zeroPad options).  A pair of names is the pencil
  decomposition (axes 0 and 1 each on its own mesh dim; c2c / r2c / c2r /
  fftconv at rank >= 2).
- ``seq_axis=None``: batch sharding of the local plan (every plan type):
  each rank runs the port's ``create_plan`` plan on its batch shard (K1/K2
  on the card), collective-free.

Inputs are a DTensor or a tensor / array every rank holds; outputs are
DTensors in the standard flat order.  Route ``mode`` and ``reasons`` equal
the JAX package's; ``impl`` is ``torch+<backend>`` (``torch+nccl``,
``torch+gloo``) where the JAX package says ``xla+ici``.  The staging
options (ioView windows, zeroPad masks, bf16 storage) run shard by shard
around the distributed core, as the JAX package's partitioner runs them;
only a flat strided buffer (``layout`` strides, channel-lane frames), which
has no logical axis to shard, is read and written whole on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..plans.base import RouteInfo
from ..spec import PlanError, PlanSpec, normalize_spec
from . import sharded
from .collectives import remap
from .sharded import (as_global, axis_size, mesh_device, mesh_shape, shard_in,
                      shard_out)


def _axis_names(seq_axis):
    if isinstance(seq_axis, (tuple, list)):
        return tuple(seq_axis)
    return (seq_axis,) if seq_axis is not None else ()


class DistributedPlan:
    """Executable distributed transform plan (plan-like surface: __call__ /
    exec / destroy / route / spec, as plans.base.Plan)."""

    def __init__(self, spec: PlanSpec, mesh, route: RouteInfo, fn, *,
                 needs_kernel: bool = False, batch_axis: Optional[str] = None,
                 seq_axis=None):
        self.spec = spec
        self.mesh = mesh
        self.route = route
        self.needs_kernel = needs_kernel
        self.batch_axis = batch_axis
        self.seq_axis = seq_axis
        self._fn = fn

    def __call__(self, x, kernel=None):
        return self.exec(x, kernel=kernel)

    def exec(self, x, kernel=None):
        if self._fn is None:
            raise PlanError("plan was destroyed")
        x = as_global(x, self.mesh)
        if self.needs_kernel:
            if kernel is None:
                raise PlanError(f"{self.spec.plan_type} exec requires kernel=")
            return self._fn(x, as_global(kernel, self.mesh))
        if kernel is not None:
            raise PlanError(f"{self.spec.plan_type} exec does not take kernel=")
        return self._fn(x)

    def destroy(self):
        self._fn = None

    def get_workspace_size_bytes(self) -> int:
        # the per-rank digit grid estimate (informational)
        ndev = 1
        for nm in _axis_names(self.seq_axis):
            ndev *= axis_size(self.mesh, nm)
        return 2 * self.spec.batch * self.spec.n_total * 8 // ndev


def _staging_needed(spec: PlanSpec) -> bool:
    return (spec.io_view.input is not None
            or spec.io_view.output is not None
            or spec.zero_pad.read is not None
            or spec.zero_pad.write is not None
            or not spec.layout.is_trivial
            or spec.precision != "f32")


def _whole(x):
    """The whole array on every rank (one all_gather of a DTensor): only for
    a flat strided buffer, which has no logical axis to shard."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _held(y, mesh) -> DTensor:
    """A tensor every rank holds whole, as a replicated DTensor."""
    return DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim, run_check=False)


class _Stager:
    """Static per-dim stages on the logical array, shard by shard: a tensor
    every rank holds is staged whole (no collective); on a DTensor, a dim
    that is sharded takes its gather as an ``AxisMap`` exchange over its
    mesh dim and its mask cut to the rank's shard, and other dims stay
    local.  The exchanges are built at first use and kept."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._maps = {}

    def _mesh_dim(self, y, dim):
        for i, p in enumerate(y.placements):
            if isinstance(p, Shard) and p.dim == dim:
                return self.mesh.mesh_dim_names[i]
        return None

    def _wrap(self, y, loc, shape):
        shape = tuple(shape)
        return DTensor.from_local(loc, self.mesh, y.placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=sharded._stride(shape))

    def take(self, y, dim, idx):
        """y[idx] along ``dim`` (zero where idx < 0)."""
        idx = np.asarray(idx)
        if len(idx) == y.shape[dim] and np.array_equal(idx, np.arange(len(idx))):
            return y
        name = self._mesh_dim(y, dim) if isinstance(y, DTensor) else None
        key = (dim, y.shape[dim], name, idx.tobytes())
        if key not in self._maps:
            self._maps[key] = sharded._amap(self.mesh, name, [y.shape[dim]],
                                            [(0, idx)])
        if not isinstance(y, DTensor):
            return remap(self._maps[key], dim, y)
        loc = remap(self._maps[key], dim, y.to_local())
        shape = list(y.shape)
        shape[dim] = len(idx)
        return self._wrap(y, loc, shape)

    def mask(self, y, dim, vec):
        """y times the 0/1 vector ``vec`` along ``dim``."""
        vec = np.asarray(vec, np.float32)
        bshape = (-1,) + (1,) * (y.ndim - dim - 1)
        if not isinstance(y, DTensor):
            return y * torch.as_tensor(vec, device=y.device).reshape(bshape)
        name = self._mesh_dim(y, dim)
        if name is not None:
            from .collectives import chunk_range
            lo, hi = chunk_range(len(vec), axis_size(self.mesh, name),
                                 sharded.axis_index(self.mesh, name))
            vec = vec[lo:hi]
        loc = y.to_local()
        loc = loc * torch.as_tensor(vec, device=loc.device).reshape(bshape)
        return self._wrap(y, loc, y.shape)

    def zero_pad(self, y, stage, domain, lead: int = 1):
        """zeroPad's [start, end) rect as one mask per non-trivial dim."""
        if stage is None:
            return y
        for d, n in enumerate(domain):
            s, e = stage.start[d], stage.end[d]
            if s == 0 and e == n:
                continue
            iota = np.arange(n)
            y = self.mask(y, lead + d, (iota >= s) & (iota < e))
        return y

    def embed(self, x, view, domain):
        """ioView input window (batch, *view.shape[, 2]) -> (batch, *domain[, 2])."""
        for d, n in enumerate(domain):
            j = np.arange(n) - view.offset[d]
            x = self.take(x, 1 + d, np.where((j >= 0) & (j < view.shape[d]), j, -1))
        return x

    def extract(self, y, view, domain):
        """ioView output window (batch, *domain[, 2]) -> (batch, *view.shape[, 2])."""
        for d, n in enumerate(domain):
            k = np.arange(view.shape[d]) + view.offset[d]
            y = self.take(y, 1 + d, np.where((k >= 0) & (k < n), k, -1))
        return y

    @staticmethod
    def movedim01(y, mesh):
        """Swap the two lead dims, shard by shard."""
        if not isinstance(y, DTensor):
            return y.movedim(0, 1)
        pl = [Shard({0: 1, 1: 0}.get(p.dim, p.dim)) if isinstance(p, Shard) else p
              for p in y.placements]
        shape = (y.shape[1], y.shape[0], *y.shape[2:])
        return DTensor.from_local(y.to_local().movedim(0, 1).contiguous(), mesh, pl,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=sharded._stride(shape))


def _maybe_stage_distributed(spec: PlanSpec, fn, route, mesh):
    """The single-device staging pipeline (plans/base.build_staged_fn:
    storage load -> [strided gather] -> [ioView embed] -> zeroPad.read ->
    core -> zeroPad.write -> [ioView extract] -> [strided scatter] ->
    storage store) around a distributed core.  The shaped stages run shard
    by shard (``_Stager``); a flat strided side is read and written whole
    on every rank (``_whole``)."""
    if not _staging_needed(spec):
        return fn
    from ..plans.transforms import packed_shape
    t = spec.plan_type
    if t == "r2c":
        doms = (spec.shape, packed_shape(spec.shape), False, True)
    elif t == "c2r":
        doms = (packed_shape(spec.shape), spec.shape, True, False)
    elif t == "c2c":
        doms = (spec.shape, spec.shape, True, True)
    else:
        doms = (spec.shape, spec.shape, False, False)
    from ..plans import stages
    from ..plans.base import resolve_sides
    in_dom, out_dom, in_il, out_il = doms
    s_in, s_out, in_phys, out_phys = resolve_sides(spec, *doms)
    dev, batch = mesh_device(mesh), spec.batch
    gather = (stages.FlatLayout(in_phys, s_in.strides, s_in.offset, s_in.batch_stride,
                                batch, in_il, dev) if s_in.has_layout else None)
    scatter = (stages.FlatLayout(out_phys, s_out.strides, s_out.offset,
                                 s_out.batch_stride, batch, out_il, dev)
               if s_out.has_layout else None)
    out_need = (stages.layout_need(out_phys, s_out.strides, s_out.offset,
                                   s_out.batch_stride, batch)
                if s_out.has_layout else 0)
    in_view, out_view = spec.io_view.input, spec.io_view.output
    zp, prec = spec.zero_pad, spec.precision
    st = _Stager(mesh)

    def wrapped(x):
        x = stages.load_storage(x, prec)
        if gather is not None:
            # a flat strided input: read from the buffer every rank holds
            x = stages.gather_flat(_whole(x), gather)
        if in_view is not None:
            x = st.embed(x, in_view, in_dom)
        y = fn(st.zero_pad(x, zp.read, in_dom))
        y = st.zero_pad(y, zp.write, out_dom)
        if out_view is not None:
            y = st.extract(y, out_view, out_dom)
        if scatter is not None:
            # a flat strided output has no logical axis to shard
            y = _held(stages.scatter_flat(_whole(y), scatter, min_len=out_need),
                      mesh)
        return stages.store_storage(y, prec)

    _copy_route_attrs(wrapped, fn)
    route.reasons = route.reasons + ("distributed-staging",)
    return wrapped


def _reject_unsupported(spec: PlanSpec, seq_axis):
    if seq_axis is None:
        return  # batch sharding wraps the local plan: full option surface
    if isinstance(seq_axis, (tuple, list)):
        if len(seq_axis) != 2:
            raise PlanError(
                "seq_axis accepts one mesh axis name or a pair (pencil "
                f"decomposition over axes 0 and 1); got {len(seq_axis)}")
        if spec.plan_type in ("c2c", "r2c", "c2r", "fftconv"):
            if spec.rank < 2:
                raise PlanError(
                    f"pencil seq_axis needs rank >= 2 for {spec.plan_type}")
        else:
            # the trig embeddings change axis lengths: on a pencil both
            # decomposed axes would need a cross-shard regather
            raise PlanError(
                f"pencil seq_axis supports c2c/r2c/c2r/fftconv (got "
                f"{spec.plan_type!r}); use a single seq_axis or batch_axis")
    if spec.in_place:
        raise PlanError("seq-axis plans do not support inPlace (donation "
                        "has no meaning for a logically-sharded exec)")
    if spec.plan_type not in ("c2c", "r2c", "c2r", "fftconv",
                              "dct1", "dct2", "dct3", "dct4",
                              "dst1", "dst2", "dst3", "dst4"):
        raise PlanError(
            f"seq_axis sharding is not supported for type "
            f"{spec.plan_type!r} (batch sharding via batch_axis works for "
            "every type)", plan_type=spec.plan_type)


def _validate_axes(mesh, batch_axis: Optional[str], seq_axis, batch: int):
    seq_names = _axis_names(seq_axis)
    if len(set(seq_names)) != len(seq_names):
        raise PlanError("pencil seq_axis needs two distinct mesh axes")
    shape = mesh_shape(mesh)
    for name, label in ((batch_axis, "batch_axis"),
                        *((s, "seq_axis") for s in seq_names)):
        if name is not None and name not in shape:
            raise PlanError(f"{label} {name!r} is not a mesh axis "
                            f"(mesh has {tuple(shape)})")
    if batch_axis is not None and batch_axis in seq_names:
        raise PlanError("batch_axis and seq_axis must be distinct mesh axes")
    if batch_axis is not None and batch % shape[batch_axis]:
        raise PlanError(
            f"batch ({batch}) must divide evenly over mesh axis "
            f"{batch_axis!r} (size {shape[batch_axis]})",
            batch=batch, devices=shape[batch_axis])


def _scaled(y, scale):
    return y if scale == 1.0 else y * scale


def _build_pencil_c2c(spec: PlanSpec, mesh, batch_axis, axes):
    """c2c rank >= 2 with axes 0 and 1 each on a mesh dim (the pencil);
    the remaining axes transform locally first, on the incoming pencil."""
    from ..core.engine import plan_scale
    shape = spec.shape
    inner = _wrap_builder_errors(sharded.build_distributed_pencil_axes01,
                                 shape, mesh, axes, spec.direction, batch_axis)
    plans, consts = sharded._local_rest_axis_plans(shape[2:], spec.direction,
                                                   spec.tuning, mesh)
    scale = plan_scale(spec.normalize, spec.direction, spec.n_total)

    def fn(x):
        b = x.shape[0]
        y = shard_in(x, mesh, inner.spec, (b, *shape, 2))
        y = _scaled(inner.local(sharded._apply_rest(y, plans, consts, 3)), scale)
        return shard_out(y, mesh, inner.spec)

    return fn, inner.split


def _build_seq_c2c(spec: PlanSpec, mesh, batch_axis, seq_axis):
    from ..core.engine import plan_scale
    shape = spec.shape
    if spec.rank == 1:
        inner = sharded.build_distributed_fft_any_1d(
            shape[0], mesh, seq_axis, spec.direction, spec.normalize, batch_axis)
        return inner, inner.split
    plans, consts = sharded._local_rest_axis_plans(shape[1:], spec.direction,
                                                   spec.tuning, mesh, "dx")
    scale = plan_scale(spec.normalize, spec.direction, spec.n_total)
    # a splittable n0 keeps the (k2, k1) digit grid, so the riding-axis
    # transforms run on the still-sharded grid; an unsplittable n0 takes
    # the axis-0 Bluestein embedding, whose output is whole
    if sharded.choose_distributed_split(shape[0], axis_size(mesh, seq_axis)) is not None:
        fft0 = sharded.build_distributed_fft_axis0(
            shape, mesh, seq_axis, spec.direction, "none", batch_axis)
        group = sharded.group_of(mesh, seq_axis)

        def fn(x):
            y = fft0.local(fft0.local_in(x))            # (b, k2, k1_loc, *rest, 2)
            y = _scaled(sharded._apply_rest(y, plans, consts, 3), scale)
            # the flat standard order (plans.py:33-35): one all_to_all
            return shard_out(sharded._grid_to_flat_local(y, group), mesh,
                             fft0.flat_spec)

        return fn, fft0.split
    fft0 = _wrap_builder_errors(sharded.build_distributed_bluestein_axis0,
                                shape, mesh, seq_axis, spec.direction, "none",
                                batch_axis)

    def fn(x):
        full_shape = (x.shape[0], *shape, 2)
        y = fft0.local_flat(shard_in(x, mesh, fft0.flat_spec, full_shape))
        y = _scaled(sharded._apply_rest(y, plans, consts, 2), scale)
        return shard_out(y, mesh, fft0.flat_spec, full_shape)

    return fn, fft0.split


def _wrap_builder_errors(builder, *args, **kwargs):
    """Surface sharded-builder ValueErrors as PlanErrors."""
    try:
        return builder(*args, **kwargs)
    except ValueError as e:
        raise PlanError(str(e)) from None


def _smooth_distributed_len(m0: int, mesh, seq_axis: str) -> int:
    try:
        return sharded.smooth_distributed_len_at_least(m0, axis_size(mesh, seq_axis))
    except ValueError as e:
        raise PlanError(f"{e} (mesh axis {seq_axis!r})") from None


_ROUTE_ATTRS = ("split", "halo", "padded_work_len", "staged", "pencil_fallback")


def _copy_route_attrs(dst, src):
    for attr in _ROUTE_ATTRS:
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))
    return dst


def _wrap_kernel_layout(inner, fc, kshape, mesh):
    """Validate the kernel's leading kcount dim and apply the output layout
    (inner builders return kernel-major (kc, b, ..., 2))."""
    kc = fc.kernel_count
    krank = len(kshape)

    def fn(x, kernel):
        if kc > 1 and (kernel.ndim != krank + 2 or kernel.shape[0] != kc):
            raise PlanError(
                f"fftconv with kernelCount={kc} expects kernel shaped "
                f"(kcount, *kernelShape, 2), got {tuple(kernel.shape)}")
        y = inner(x, kernel)
        if (kc > 1 and fc.output_layout == "batch-major"
                and fc.channel_output is None):
            y = _Stager.movedim01(y, mesh)
        return y

    return _copy_route_attrs(fn, inner)


def _wrap_channel_lanes(inner, spec: PlanSpec, out_shape, mesh):
    """Channel-lane frames around the distributed conv pipeline: the input
    gather extracts (batch, *shape, 2) from the flat lane frames and the
    output scatter writes each kernel's result into its lane (the local
    plan's lowering, plans/fftconv.py)."""
    from ..plans import stages
    fc = spec.fft_conv
    ch_in, ch_out = fc.channel_input, fc.channel_output
    shape, batch, kcount = spec.shape, spec.batch, fc.kernel_count
    out_shape = tuple(out_shape)
    dev = mesh_device(mesh)
    gather = scatter = None
    if ch_in is not None:
        in_st, in_off, in_bs = stages.resolve_side_layout(shape, None, 0, None, ch_in)
        gather = stages.FlatLayout(shape, in_st, in_off, in_bs, batch, True, dev)
    if ch_out is not None:
        cs = (ch_out.channel_stride_elements
              if ch_out.channel_stride_elements is not None else math.prod(out_shape))
        bs = (ch_out.batch_stride_elements
              if ch_out.batch_stride_elements is not None else ch_out.channels * cs)
        offs = [ch_out.offset_elements
                + (ch_out.channel_index + k * ch_out.kernel_step_channels) * cs
                for k in range(kcount)]
        scatter = stages.FlatLayout(out_shape, stages.default_strides(out_shape),
                                    0, bs, batch, True, dev)
        need = max([bs * batch] + [o + scatter.need for o in offs])

    def fn(x, kernel):
        if gather is not None:
            x = stages.gather_flat(_whole(x), gather)
        y = inner(x, kernel)
        if scatter is None:
            return y
        y = _whole(y).reshape((kcount, batch) + out_shape + (2,))
        res = torch.zeros((need, 2), dtype=y.dtype, device=y.device)
        for k, off in enumerate(offs):
            res = stages.scatter_flat(y[k], scatter, out=res, extra_offset=off)
        return _held(res, mesh)

    return _copy_route_attrs(fn, inner)


def _halo_conv_eligible(spec: PlanSpec, mesh, seq_axis: str) -> bool:
    """Short-kernel 1-D-split convolution takes the halo-exchange route."""
    fc = spec.fft_conv
    if (fc.kernel_count != 1 or fc.mode != "convolution"
            or fc.kernel_shape is None):
        return False
    n, k = spec.shape[0], fc.kernel_shape[0]
    if 8 * k > n:
        return False
    return sharded.halo_conv_geometry(
        n, k, axis_size(mesh, seq_axis), fc.boundary) is not None


def _wrap_fftconv_zero_pad(fn, spec: PlanSpec, mesh):
    """zeroPad.read/write for distributed fftconv as masks on the logical
    data / output arrays (the data embeds at the origin of fftShape and the
    output crop starts at ``out_off``)."""
    zp = spec.zero_pad
    if zp.read is None and zp.write is None:
        return fn
    from ..utils.mathref import fftconv_out_shape
    fc = spec.fft_conv
    kshape = (tuple(fc.kernel_shape) if fc.kernel_shape is not None
              else tuple(spec.shape))
    _, out_shape, out_off = fftconv_out_shape(spec.shape, list(kshape), fc.boundary)
    shape, rank = spec.shape, spec.rank

    st = _Stager(mesh)

    def rect(stage, domain, shift):
        """Per-dim 0/1 vectors of the rect (None where a dim is whole)."""
        vecs, trivial = [], True
        for d in range(rank):
            s = min(max(stage.start[d] - shift[d], 0), domain[d])
            e = min(max(stage.end[d] - shift[d], 0), domain[d])
            if s == 0 and e == domain[d]:
                vecs.append(None)
                continue
            trivial = False
            iota = np.arange(domain[d])
            vecs.append((iota >= s) & (iota < e))
        return None if trivial else vecs

    read = rect(zp.read, shape, (0,) * rank) if zp.read is not None else None
    write = (rect(zp.write, out_shape, out_off)
             if zp.write is not None else None)
    if read is None and write is None:
        return fn

    def masked(y, vecs):
        lead = y.ndim - rank - 1
        for d, v in enumerate(vecs):
            if v is not None:
                y = st.mask(y, lead + d, v)
        return y

    def wrapped(x, kernel):
        if read is not None:
            if x.ndim != rank + 2:
                x = _reshape(x, mesh, (x.shape[0], *shape, 2))
            x = masked(x, read)
        y = fn(x, kernel)
        return masked(y, write) if write is not None else y

    _copy_route_attrs(wrapped, fn)
    wrapped.staged = True
    return wrapped


def _build_seq_fftconv(spec: PlanSpec, mesh, batch_axis, seq_axis):
    fc = spec.fft_conv
    fn, split = _build_seq_fftconv_route(spec, mesh, batch_axis, seq_axis)
    fn = _wrap_fftconv_zero_pad(fn, spec, mesh)
    if fc.channel_input is not None or fc.channel_output is not None:
        from ..utils.mathref import fftconv_out_shape
        kshape = (tuple(fc.kernel_shape) if fc.kernel_shape is not None
                  else spec.shape)
        _, out_shape, _ = fftconv_out_shape(spec.shape, list(kshape), fc.boundary)
        fn = _wrap_channel_lanes(fn, spec, out_shape, mesh)
    return fn, split


def _build_seq_fftconv_route(spec: PlanSpec, mesh, batch_axis, seq_axis):
    fc = spec.fft_conv
    pencil = isinstance(seq_axis, (tuple, list))
    if not pencil and _halo_conv_eligible(spec, mesh, seq_axis):
        if spec.rank == 1:
            inner = _wrap_builder_errors(
                sharded.build_distributed_fftconv_halo_1d,
                spec.shape[0], fc.kernel_shape[0], spec.batch, mesh,
                seq_axis, fc.boundary, batch_axis, tuning=spec.tuning,
                overlap_save=fc.overlap_save, overlap_block=fc.overlap_block)
        else:
            inner = _wrap_builder_errors(
                sharded.build_distributed_fftconv_halo_nd,
                spec.shape, fc.kernel_shape, spec.batch, mesh, seq_axis,
                fc.boundary, batch_axis, tuning=spec.tuning)

        fn = _flat_in(inner, spec.shape, mesh)
        return fn, fn.split
    if fc.boundary != "circular":
        return _build_seq_fftconv_linear(spec, mesh, batch_axis, seq_axis)
    if fc.kernel_shape is not None and tuple(fc.kernel_shape) != spec.shape:
        raise PlanError(
            "distributed circular fftconv requires kernelShape == shape "
            "(circular kernels are full-length)")
    if pencil:
        try:
            inner = sharded.build_distributed_fftconv_pencil(
                spec.shape, mesh, tuple(seq_axis), fc.mode, batch_axis)
        except sharded.UnsplittableAxisError:
            # a circular length with no smooth mesh-divisible split on its
            # pencil axis cannot pad: the single-axis route over the FIRST
            # pencil axis runs instead (its padded-circular fold covers any
            # length); other builder errors surface as PlanErrors
            inner = _wrap_builder_errors(
                sharded.build_distributed_fftconv_nd,
                spec.shape, mesh, seq_axis[0], fc.mode, batch_axis)
            inner.pencil_fallback = seq_axis[0]
        except ValueError as e:
            raise PlanError(str(e)) from None
    else:
        inner = _wrap_builder_errors(
            sharded.build_distributed_fftconv_nd,
            spec.shape, mesh, seq_axis, fc.mode, batch_axis)
    wrapped = _wrap_kernel_layout(_flat_in(inner, spec.shape, mesh), fc, spec.shape, mesh)
    return wrapped, wrapped.split


def _reshape(x, mesh, shape):
    """x viewed as ``shape``: a DTensor shard by shard where it can be."""
    if isinstance(x, DTensor):
        return sharded._reshape_global(x, mesh, shape)
    return x.reshape(shape)


def _flat_in(inner, shape, mesh):
    """A conv core fed (batch, *shape, 2) whatever view of it arrives."""
    def fn(x, kernel):
        if x.ndim != len(shape) + 2:
            x = _reshape(x, mesh, (x.shape[0], *shape, 2))
        return inner(x, kernel)
    return _copy_route_attrs(fn, inner)


def _build_seq_fftconv_linear(spec: PlanSpec, mesh, batch_axis, seq_axis):
    """Linear-boundary distributed fftconv: circular convolution at a
    smooth-padded working shape >= shape + kernelShape - 1, then the
    boundary crop (utils/mathref.fftconv_out_shape)."""
    from ..utils import factors
    from ..utils.mathref import fftconv_out_shape
    fc = spec.fft_conv
    kshape = (tuple(fc.kernel_shape) if fc.kernel_shape is not None
              else spec.shape)
    try:
        _, out_shape, out_off = fftconv_out_shape(spec.shape, kshape, fc.boundary)
    except ValueError as e:
        raise PlanError(str(e), boundary=fc.boundary, kernel_shape=kshape) from None
    need = [spec.shape[d] + kshape[d] - 1 for d in range(spec.rank)]
    if isinstance(seq_axis, (tuple, list)):
        work = (_smooth_distributed_len(need[0], mesh, seq_axis[0]),
                _smooth_distributed_len(need[1], mesh, seq_axis[1]),
                *(factors.next_smooth_at_least(v) for v in need[2:]))
        inner = _wrap_builder_errors(sharded.build_distributed_fftconv_pencil,
                                     work, mesh, tuple(seq_axis), fc.mode,
                                     batch_axis)
    else:
        work = (_smooth_distributed_len(need[0], mesh, seq_axis),
                *(factors.next_smooth_at_least(v) for v in need[1:]))
        inner = _wrap_builder_errors(sharded.build_distributed_fftconv_nd,
                                     work, mesh, seq_axis, fc.mode, batch_axis)
    rank = spec.rank
    # correlation wraps negative lags to the END of the transform length:
    # oracle index j >= n lives at j + (m - (n + k - 1)); a static gather
    # per dim (an exchange where the dim is sharded)
    crops = []
    for d in range(rank):
        j = np.arange(out_off[d], out_off[d] + out_shape[d])
        if fc.mode == "correlation":
            j = np.where(j < spec.shape[d], j, j + (work[d] - need[d]))
        crops.append(j)
    kc = fc.kernel_count
    st = _Stager(mesh)

    def pad_to(a, lead: int, have):
        for d in range(rank):
            k = np.arange(work[d])
            a = st.take(a, lead + d, np.where(k < have[d], k, -1))
        return a

    def raw(x, kernel):
        b = x.shape[0]
        xp = pad_to(_reshape(x, mesh, (b, *spec.shape, 2)), 1, spec.shape)
        kp = (pad_to(_reshape(kernel, mesh, (kc, *kshape, 2)), 1, kshape) if kc > 1
              else pad_to(_reshape(kernel, mesh, (*kshape, 2)), 0, kshape))
        y = inner(xp, kp)                       # circular at the work shape
        lead = 2 if kc > 1 else 1
        for d in range(rank):
            y = st.take(y, lead + d, crops[d])
        return y

    raw.split = inner.split
    wrapped = _wrap_kernel_layout(raw, fc, kshape, mesh)
    return wrapped, wrapped.split


def create_distributed_plan(opts: Optional[Dict[str, Any]] = None, *, mesh,
                            batch_axis: Optional[str] = None,
                            seq_axis=None, **kwargs) -> DistributedPlan:
    """Create a multi-GPU transform plan from reference-style options.

    ``mesh``: the ``DeviceMesh`` to run over (``make_mesh``).
    ``batch_axis`` shards the batch dim (data parallel); ``seq_axis``
    distributes single transforms over ranks (sequence parallel, all_to_all
    digit exchange), a pair of names for the pencil.  At least one must be
    given."""
    merged = dict(opts or {})
    merged.update(kwargs)
    spec = normalize_spec(merged)
    if batch_axis is None and seq_axis is None:
        raise PlanError("give batch_axis and/or seq_axis (a mesh axis name)")
    if isinstance(seq_axis, (tuple, list)) and len(seq_axis) == 1:
        seq_axis = seq_axis[0]
    pencil = isinstance(seq_axis, (tuple, list))
    _validate_axes(mesh, batch_axis, seq_axis, spec.batch)
    _reject_unsupported(spec, seq_axis)
    measure_note = ()
    if spec.tuning.rigor == "measure":
        # the measured planner times single-device candidates; the
        # distributed route choice is structural
        spec = dataclasses.replace(spec, tuning=dataclasses.replace(
            spec.tuning, rigor="estimate"))
        measure_note = ("measure-unsupported:distributed",)
    route = RouteInfo(
        mode=("distributed-pencil" if pencil
              else "distributed-sp" if seq_axis else "distributed-dp"),
        impl=f"torch+{dist.get_backend()}",
        reasons=((f"mesh:{mesh_shape(mesh)}",)
                 + ((f"batch-axis:{batch_axis}",) if batch_axis else ())
                 + ((f"seq-axis:{seq_axis}",) if seq_axis else ())
                 + measure_note))
    needs_kernel = spec.plan_type in ("fftconv", "conv2d")

    if seq_axis is None:
        return _build_dp(spec, merged, mesh, route, batch_axis, needs_kernel)

    t = spec.plan_type
    if pencil:
        axes = tuple(seq_axis)
        if t == "c2c":
            fn, split = _build_pencil_c2c(spec, mesh, batch_axis, axes)
        elif t in ("r2c", "c2r"):
            b = (sharded.build_distributed_r2c_nd if t == "r2c"
                 else sharded.build_distributed_c2r_nd)
            inner = _wrap_builder_errors(b, spec.shape, mesh, axes[0],
                                         spec.normalize, batch_axis,
                                         tuning=spec.tuning, pencil_axes=axes)
            fn, split = inner, inner.split
        else:
            fn, split = _build_seq_fftconv(spec, mesh, batch_axis, axes)
            if getattr(fn, "staged", False):
                route.reasons = route.reasons + ("distributed-staging",)
        fb = getattr(fn, "pencil_fallback", None)
        if fb is not None:
            route.reasons = route.reasons + (
                f"pencil-fallback-single-axis({fb})", f"digit-split:{split}")
            if hasattr(fn, "padded_work_len"):
                route.reasons = route.reasons + (
                    f"fftconv-padded-circular:{fn.padded_work_len}",)
        else:
            route.reasons = route.reasons + (f"pencil-split:{split}",)
        if not needs_kernel:
            fn = _maybe_stage_distributed(spec, fn, route, mesh)
        return DistributedPlan(spec, mesh, route, fn, needs_kernel=needs_kernel,
                               batch_axis=batch_axis, seq_axis=axes)
    if t == "c2c":
        fn, split = _build_seq_c2c(spec, mesh, batch_axis, seq_axis)
    elif t in ("r2c", "c2r"):
        if spec.rank == 1:
            b = (sharded.build_distributed_r2c_1d if t == "r2c"
                 else sharded.build_distributed_c2r_1d)
            inner = b(spec.shape[0], mesh, seq_axis, spec.normalize, batch_axis)
        else:
            b = (sharded.build_distributed_r2c_nd if t == "r2c"
                 else sharded.build_distributed_c2r_nd)
            inner = _wrap_builder_errors(b, spec.shape, mesh, seq_axis,
                                         spec.normalize, batch_axis,
                                         tuning=spec.tuning)
        fn, split = inner, inner.split
    elif t.startswith("dct") or t.startswith("dst"):
        if spec.rank == 1:
            inner = sharded.build_distributed_trig_1d(
                spec.shape[0], t, mesh, seq_axis, spec.direction,
                spec.normalize, batch_axis)
        else:
            inner = _wrap_builder_errors(
                sharded.build_distributed_trig_nd, spec.shape, t, mesh,
                seq_axis, spec.direction, spec.normalize, batch_axis,
                tuning=spec.tuning)
        fn, split = inner, inner.split
    else:  # fftconv
        fn, split = _build_seq_fftconv(spec, mesh, batch_axis, seq_axis)
        if getattr(fn, "staged", False):
            route.reasons = route.reasons + ("distributed-staging",)

    if hasattr(fn, "halo"):
        # (split) is the (ndev, shard_len) SHARD geometry here
        route.reasons = route.reasons + (
            f"shard-split:{split}", f"fftconv-halo({fn.halo})")
    else:
        route.reasons = route.reasons + (f"digit-split:{split}",)
        if hasattr(fn, "padded_work_len"):
            route.reasons = route.reasons + (
                f"fftconv-padded-circular:{fn.padded_work_len}",)
    if not needs_kernel:
        fn = _maybe_stage_distributed(spec, fn, route, mesh)
    return DistributedPlan(spec, mesh, route, fn, needs_kernel=needs_kernel,
                           batch_axis=batch_axis, seq_axis=seq_axis)


def _build_dp(spec, merged, mesh, route, batch_axis, needs_kernel):
    """Batch sharding of the local plan: each rank runs the port's
    create_plan plan (on the mesh's device) on its batch shard; an input
    whose leading dim is not the batch (a flat strided buffer) runs whole on
    every rank (the placement rule of plans.py:88-100)."""
    from .. import create_plan
    dev = mesh_device(mesh)
    local = create_plan(merged, device=dev)
    route.axis_kinds = local.route.axis_kinds
    route.reasons = route.reasons + ("local:" + local.route.mode,)
    ndp = axis_size(mesh, batch_axis)
    shard_plan = (local if ndp == 1 else
                  create_plan({**merged, "batch": spec.batch // ndp}, device=dev))

    fc = spec.fft_conv
    flat_out = (spec.plan_type == "fftconv" and (
        fc.channel_output is not None
        or fc.output_kernel_stride_elements is not None))
    # kernel-major multi-kernel output (kc, batch, ...): the batch is dim 1
    out_bdim = int(spec.plan_type == "fftconv" and fc.kernel_count > 1
                   and fc.output_layout != "batch-major")

    def fn(x, kernel=None):
        # the local plan reads the whole kernel (a weight every rank holds)
        kw = {"kernel": _whole(kernel)} if needs_kernel else {}
        if x.ndim < 2 or x.shape[0] != spec.batch or flat_out:
            # a flat buffer runs whole on every rank (plans.py:88-100)
            return _held(local.exec(_whole(x), **kw), mesh)
        spec_in = (batch_axis,) + (None,) * (x.ndim - 1)
        y = shard_plan.exec(shard_in(x, mesh, spec_in), **kw)
        spec_out = [None] * y.ndim
        spec_out[out_bdim] = batch_axis
        return shard_out(y, mesh, spec_out)

    return DistributedPlan(spec, mesh, route, fn, needs_kernel=needs_kernel,
                           batch_axis=batch_axis, seq_axis=None)
