"""Plan export: serialize one plan's spec, route and tables for serving.

Port of the single-plan half of ``webgpufft_tpu/runtime/aot.py``.  The JAX
artefact is a serialized ``jax.export`` executable; a port plan is eager
torch code around two nvcc-built kernels, so what there is to carry is the
normalized spec, the route the exporting process chose, and the constant
tables (``Plan.consts``).  Artifact layout: 8-byte big-endian header length,
JSON header (schema, version, spec descriptor, route, i/o shapes, table
names, and ``k1_chains`` / ``k2_chains``: the radix chain each K1 and K2
twiddle table ``cw`` is laid out for), then the tables as plain
``numpy.savez`` bytes (loaded with ``allow_pickle=False``).  K1 reads ``cw``
in the order of the chain its rule gives the length
(``core/radix.lines_chain``), K2 in the order of the chain its rule gives
the height (``core/fused_cols.cols_chain``), either of which a later build
may change: an artifact whose recorded chain (``radix.radix_chain`` for one
written before the record, when the kernel had no other) is not this
build's is refused with ``PlanError``, never run on a table in another
order.

``load_exported_plan(data, device=)`` rebuilds the plan's structure from the
spec, checks that its route equals the recorded one (a serving process whose
policy would route differently raises instead of silently running another
path) and replaces its tables with the recorded ones through
``Plan.load_consts``: what runs is bit for bit what was exported.  The
plan constructor still derives its own tables on the way (it decides the route
while it makes them); they are dropped, not run.

The pipeline export (``export_pipeline`` / ``load_exported_pipeline``) is the
port of the JAX package's: any chain of facade calls (stft -> mask -> istft,
a filter bank, an envelope detector) traced once by ``torch.export`` on
example tensors and saved with ``torch.export.save``.  Header layout as the
JAX package's (8-byte big-endian length, JSON with ``schema``, ``version``,
``platforms`` and ``shapes``), then the saved program.  The kernels are in
the program as the dispatcher ops ``wgfft::fused_lines`` and
``wgfft::fused_cols`` (``core/fused.py``, ``core/fused_cols.py``), the plan
tables as constants (the header's ``k1_chains`` and ``k2_chains`` record,
by length, the chain of every K1 and K2 launch's ``cw``, checked on load as
for a plan); loading it therefore needs ``import webgpufft_tpu_torch``
(which registers the ops), and every call of the loaded program launches
(and counts) the kernels on a CUDA tensor.

The distributed export (``export_distributed_plan``) carries a
sequence-parallel ``DistributedPlan`` the same way: the header holds the
spec, the route and, under ``"distributed"``, what the JAX artefact records
of its mesh (``mesh``: axis name -> size, ``batch_axis``, ``seq_axis``, a list
for the pencil, ``nr_devices``); it has no tables, since the distributed
builders derive theirs from the spec.  The collectives are not traced: they
are eager ``torch.distributed`` calls on the serving process group, so the
loaded ``ExportedPlan`` rebuilds the plan (``parallel.plans.plan_from_spec``)
on the first call that names a mesh, ``ep(x, mesh=...)`` or a DTensor input
(whose ``device_mesh`` serves), on ``parallel.sharded.mesh_device(mesh)``,
and keeps one plan per mesh.  The build runs outside any ``torch.func``
transform or dispatch mode (``runtime/cache._outside_transforms``), so a
first call inside a trace still makes real exchange maps.  A mesh whose axis
sizes differ from the recorded ones, and a rebuilt route that differs from
the recorded one, raise ``PlanError``.  Placement mirrors the JAX
``ExportedPlan._place``: the batch dim is sharded on ``batch_axis`` (sliced
from the whole input every rank holds, no collective), the rest replicated;
the kernel is replicated, and a bare ``(*kshape, 2)`` kernel gains the
leading count dim when the plan takes one kernel.  A batch-sharded (dp-only)
plan wraps a local plan, which ``export_plan`` exports.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import fused_cols, radix
from ..spec import PlanError, spec_to_dict

AOT_SCHEMA = "webgpufft-tpu-torch.aot-plan"
AOT_VERSION = 1


def _route_dict(route) -> Dict[str, Any]:
    return {"mode": route.mode, "impl": route.impl,
            "axis_kinds": list(route.axis_kinds),
            "reasons": [r for r in route.reasons if not r.startswith("measure")]}


# what each kernel's twiddle tables are checked by: the header key of
# their record, the table beside ``<prefix>/cw`` that marks the kernel's
# prefixes (K2's have no ``f1re``, K1's no ``w1re``), the op of its launch
# in an exported program, the chain its rule reads a size in, and what
# that size is called
_KERNELS = {
    "K1": ("k1_chains", "f1re", "fused_lines", radix.lines_chain, "N"),
    "K2": ("k2_chains", "w1re", "fused_cols", fused_cols.cols_chain, "H"),
}


def _plan_sizes(tables: Dict[str, Any], kernel: str) -> Dict[str, int]:
    """Each twiddle table of ``kernel`` among a plan's ``tables``
    (``<prefix>/cw`` beside the kernel's mark) -> its length."""
    mark = _KERNELS[kernel][1]
    return {name: int(t.shape[0]) for name, t in tables.items()
            if name.endswith("/cw") and f"{name[:-3]}/{mark}" in tables}


def _pipeline_sizes(program, kernel: str) -> Dict[str, int]:
    """The size of every launch of ``kernel`` (its op ``wgfft::fused_lines``
    or ``wgfft::fused_cols``) in an exported program, keyed ``"N=<length>"``
    or ``"H=<height>"``."""
    _, _, name, _, size = _KERNELS[kernel]
    op = getattr(torch.ops.wgfft, name).default
    ns = {int(node.args[0].meta["val"].shape[1]) for node in program.graph.nodes
          if node.op == "call_function" and node.target is op}
    return {f"{size}={n}": n for n in sorted(ns)}


def _chains(sizes: Dict[str, int], kernel: str) -> Dict[str, List[int]]:
    """What an artifact records of ``kernel``'s tables: the chain each is
    laid out for (``radix.lines_chain``, ``fused_cols.cols_chain``), by the
    keys of ``sizes``."""
    chain = _KERNELS[kernel][3]
    return {key: list(chain(n)) for key, n in sizes.items()}


def _records(sizes_of) -> Dict[str, Dict[str, List[int]]]:
    """The header's chain records, ``sizes_of(kernel)`` giving each kernel's sizes."""
    return {spec[0]: _chains(sizes_of(kernel), kernel) for kernel, spec in _KERNELS.items()}


def _check_chains(meta: Dict[str, Any], sizes_of, what: str) -> None:
    """Refuse an artifact whose K1 or K2 twiddle tables are laid out for
    another chain than this build's kernel reads at their size
    (``radix.lines_chain``, ``fused_cols.cols_chain``): the kernel would run
    them silently in the wrong order.  ``meta`` is the artifact's header,
    ``sizes_of(kernel)`` the kernel's sizes in it; an artifact written
    before a kernel's chains were recorded has no record, and its tables
    are laid out for ``radix.radix_chain``, the only chain the kernel had
    then."""
    for kernel, (key_name, _, _, chain, size) in _KERNELS.items():
        recorded = meta.get(key_name)
        for key, n in sizes_of(kernel).items():
            if recorded is None:
                have = radix.radix_chain(n)
            else:
                have = tuple(recorded[key]) if key in recorded else None
            want = chain(n)
            if have != want:
                raise PlanError(
                    f"{what}: the {kernel} twiddle table {key!r} ({size} = {n}) is laid out for "
                    f"the chain {have}, and this build's {kernel} reads {size} = {n} in the "
                    f"chain {want}: export it again with this build",
                    table=key, recorded=None if have is None else list(have), kernel=list(want))


def _write(header: Dict[str, Any], payload: bytes, path: Optional[str]) -> bytes:
    head = json.dumps(header).encode("utf-8")
    blob = len(head).to_bytes(8, "big") + head + payload
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_plan(plan, *, path: Optional[str] = None) -> bytes:
    """Serialize ``plan`` (spec, route, tables).  Returns the artifact bytes;
    also writes ``path`` when given.  Exec-time offsets and ``out=`` are
    arguments of the loaded plan's call, as of any plan's."""
    tables = {k: v.detach().cpu().numpy() for k, v in plan.consts.items()}
    payload = io.BytesIO()
    np.savez(payload, **{f"t{i}": tables[k] for i, k in enumerate(sorted(tables))})
    return _write({
        "schema": AOT_SCHEMA,
        "version": AOT_VERSION,
        "spec": spec_to_dict(plan.spec),
        "route": _route_dict(plan.route),
        "route_mode": plan.route.mode,
        "shapes": {"input": None if plan.input_shape is None else list(plan.input_shape),
                   "output": None if plan.output_shape is None else list(plan.output_shape)},
        "tables": sorted(tables),
        **_records(lambda kernel: _plan_sizes(tables, kernel)),
    }, payload.getvalue(), path)


def _distributed_io(spec) -> Dict[str, List[int]]:
    """The global input (and kernel) shape of a distributed plan's call, as
    the JAX export traces it."""
    t = spec.plan_type
    if t == "c2r":
        shape = (spec.batch, spec.shape[0] // 2 + 1, *spec.shape[1:], 2)
    elif t == "r2c" or t.startswith(("dct", "dst")):
        shape = (spec.batch, *spec.shape)
    else:
        shape = (spec.batch, *spec.shape, 2)
    shapes = {"input": list(shape)}
    if t == "fftconv":
        fc = spec.fft_conv
        kshape = tuple(fc.kernel_shape) if fc.kernel_shape is not None else spec.shape
        shapes["kernel"] = [fc.kernel_count, *kshape, 2]
    return shapes


def export_distributed_plan(dplan, *, path: Optional[str] = None) -> bytes:
    """Serialize a sequence-parallel ``DistributedPlan`` (spec, route and
    mesh record; see the module docstring).  Returns the artifact bytes;
    also writes ``path`` when given.  A serving process loads it with
    :func:`load_exported_plan` and calls ``ep(x, mesh=serving_mesh)`` on a
    mesh of the same axis sizes."""
    from ..parallel.plans import DistributedPlan
    from ..parallel.sharded import mesh_shape

    if not isinstance(dplan, DistributedPlan):
        raise PlanError("export_distributed_plan: expected a DistributedPlan "
                        f"(create_distributed_plan), got {type(dplan).__name__}")
    if dplan.seq_axis is None:
        raise PlanError(
            "export_distributed_plan: a batch-sharded (dp-only) plan wraps "
            "the local single-chip plan; export that plan with export_plan "
            "and shard its inputs at serving time")
    seq = dplan.seq_axis
    payload = io.BytesIO()
    np.savez(payload)
    return _write({
        "schema": AOT_SCHEMA,
        "version": AOT_VERSION,
        "spec": spec_to_dict(dplan.spec),
        "route": _route_dict(dplan.route),
        "route_mode": dplan.route.mode,
        "shapes": _distributed_io(dplan.spec),
        "tables": [],
        "distributed": {
            "mesh": mesh_shape(dplan.mesh),
            "batch_axis": dplan.batch_axis,
            "seq_axis": list(seq) if isinstance(seq, (tuple, list)) else seq,
            "nr_devices": dplan.mesh.size(),
        },
    }, payload.getvalue(), path)


class ExportedPlan:
    """A loaded artifact: ``ep(x[, kernel=...])`` runs the plan with the
    exported tables; ``plan`` is the rebuilt ``Plan``.  A distributed
    artifact (``distributed`` is its mesh record, ``plan`` None) runs as
    ``ep(x[, kernel], mesh=...)`` or on a DTensor ``x``."""

    def __init__(self, meta: Dict[str, Any], plan=None):
        self.meta = meta
        self.plan = plan
        self.shapes = meta.get("shapes", {})
        self.route_mode = meta.get("route_mode")
        self.distributed = meta.get("distributed")
        self._plans = {}

    def __call__(self, x, kernel=None, *, mesh=None, **kw):
        if self.distributed is None:
            if mesh is not None:
                raise PlanError("mesh= is only meaningful for distributed artifacts")
            return self.plan(x, kernel=kernel, **kw)
        from torch.distributed.tensor import DTensor
        if mesh is None:
            if not isinstance(x, DTensor):
                raise PlanError("a distributed artifact runs on a mesh: pass mesh= "
                                "or a DTensor input")
            mesh = x.device_mesh
        plan = self._plan_on(mesh)
        if not isinstance(x, DTensor):
            x = self._place(x, mesh)
        if kernel is not None:
            kernel = self._replicated_kernel(kernel, mesh)
        return plan(x, kernel=kernel, **kw)

    def _plan_on(self, mesh):
        """The plan rebuilt on ``mesh`` (once per mesh), its axes and route
        held to the recorded ones."""
        from ..parallel.plans import plan_from_spec
        from ..parallel.sharded import mesh_shape
        from .cache import _outside_transforms, _rebuild_spec

        d = self.distributed
        if mesh_shape(mesh) != {k: int(v) for k, v in d["mesh"].items()}:
            raise PlanError(f"serving mesh axes {mesh_shape(mesh)} do not match the "
                            f"exported mesh {d['mesh']}")
        plan = self._plans.get(mesh)
        if plan is None:
            seq = d["seq_axis"]
            with _outside_transforms():
                plan = plan_from_spec(
                    _rebuild_spec(self.meta["spec"]), mesh=mesh,
                    batch_axis=d["batch_axis"],
                    seq_axis=tuple(seq) if isinstance(seq, list) else seq)
            _check_route(self.meta["route"], plan.route)
            self._plans[mesh] = plan
        return plan

    def _place(self, x, mesh):
        """The whole input every rank holds -> a DTensor with the batch dim
        sharded on ``batch_axis`` and the rest replicated."""
        from ..parallel.sharded import as_global, shard_in, shard_out
        x = as_global(x, mesh)
        spec = (self.distributed["batch_axis"],) + (None,) * (x.ndim - 1)
        return shard_out(shard_in(x, mesh, spec), mesh, spec, tuple(x.shape))

    def _replicated_kernel(self, kernel, mesh):
        from torch.distributed.tensor import DTensor, Replicate
        from ..parallel.sharded import as_global
        if isinstance(kernel, DTensor):
            return kernel
        kernel = as_global(kernel, mesh)
        want = self.shapes.get("kernel")
        if want and kernel.ndim == len(want) - 1 and int(want[0]) == 1:
            kernel = kernel[None]
        return DTensor.from_local(kernel, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    @property
    def spec_dict(self) -> Dict[str, Any]:
        return self.meta.get("spec", {})


def load_exported_plan(data, device="cuda") -> ExportedPlan:
    """Load an artifact produced by :func:`export_plan` (bytes or a path)
    onto ``device``, or one of :func:`export_distributed_plan` (whose plan
    is built on the serving mesh's device at its first call)."""
    from .. import _build_plan, _resolve_device
    from .cache import _rebuild_spec

    if isinstance(data, (str, os.PathLike)):
        with open(data, "rb") as f:
            data = f.read()
    if not isinstance(data, (bytes, bytearray)) or len(data) < 9:
        raise PlanError("load_exported_plan: expected artifact bytes or a path")
    hlen = int.from_bytes(data[:8], "big")
    if hlen <= 0 or 8 + hlen > len(data):
        raise PlanError("load_exported_plan: corrupt artifact header")
    try:
        meta = json.loads(bytes(data[8:8 + hlen]).decode("utf-8"))
    except ValueError as e:
        raise PlanError(f"load_exported_plan: bad header JSON: {e}")
    if meta.get("schema") != AOT_SCHEMA:
        raise PlanError(f"unrecognized AOT artifact schema: {meta.get('schema')!r}")
    if meta.get("version") != AOT_VERSION:
        raise PlanError(f"unsupported AOT artifact version {meta.get('version')}")
    with np.load(io.BytesIO(bytes(data[8 + hlen:])), allow_pickle=False) as npz:
        tables = {name: torch.from_numpy(npz[f"t{i}"])
                  for i, name in enumerate(meta["tables"])}
    if meta.get("distributed") is not None:
        return ExportedPlan(meta)
    _check_chains(meta, lambda kernel: _plan_sizes(tables, kernel), "load_exported_plan")
    plan = _build_plan(_rebuild_spec(meta["spec"]), _resolve_device(device))
    _check_route(meta["route"], plan.route)
    plan.load_consts(tables)
    return ExportedPlan(meta, plan)


def _check_route(exported: Dict[str, Any], route) -> None:
    got = _route_dict(route)
    if got != exported:
        raise PlanError(
            "load_exported_plan: this process routes the plan differently from "
            "the exporting one", exported=exported, rebuilt=got)


PIPELINE_SCHEMA = "webgpufft-tpu-aot-pipeline"


class _Pipeline(torch.nn.Module):
    """``fn`` as the module ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _tensor_args(args, device=None) -> Tuple[torch.Tensor, ...]:
    """Tensors pass as they are; anything else enters as float32 through
    the facade's one cast of user data (on ``device`` or the facade
    default), as the JAX package canonicalizes its example arrays."""
    from .. import fftapi
    return tuple(a if isinstance(a, torch.Tensor) else fftapi._f32(a, device) for a in args)


def export_pipeline(fn, *example_args, path: Optional[str] = None) -> bytes:
    """Serialize ANY pipeline built on the package (a facade chain such as
    stft -> mask -> istft, a filter bank, an envelope detector) as one
    ``torch.export`` program, traced on ``example_args`` (tensors, or
    arrays that enter as float32 on the facade's default device): their
    shapes, dtypes and device are the program's.  Returns the artifact
    bytes; also writes ``path`` when given.  The generic sibling of
    :func:`export_plan`.  A plan first built during the trace is cached
    with real tables (``runtime/cache._outside_transforms``)."""
    if not callable(fn):
        raise PlanError(f"export_pipeline: fn must be callable, got {type(fn).__name__}")
    args = _tensor_args(example_args)
    program = torch.export.export(_Pipeline(fn), args, strict=False)
    payload = io.BytesIO()
    torch.export.save(program, payload)
    return _write({
        "schema": PIPELINE_SCHEMA,
        "version": AOT_VERSION,
        "platforms": sorted({a.device.type for a in args}),
        "shapes": [{"shape": list(a.shape), "dtype": str(a.dtype).removeprefix("torch.")}
                   for a in args],
        **_records(lambda kernel: _pipeline_sizes(program, kernel)),
    }, payload.getvalue(), path)


class ExportedPipeline:
    """A loaded :func:`export_pipeline` artifact: call it like the original
    function (shapes must match the recorded ones)."""

    def __init__(self, meta: Dict[str, Any], program):
        self.meta = meta
        self.program = program
        self._module = program.module()

    @property
    def platforms(self) -> Tuple[str, ...]:
        return tuple(self.meta["platforms"])

    @property
    def shapes(self) -> List[Tuple[int, ...]]:
        return [tuple(s["shape"]) for s in self.meta["shapes"]]

    def __call__(self, *args):
        return self._module(*_tensor_args(args, torch.device(self.platforms[0])))


def load_exported_pipeline(data) -> ExportedPipeline:
    """Load an :func:`export_pipeline` artifact (bytes, path string, or
    os.PathLike).  Needs ``import webgpufft_tpu_torch`` first: the program
    calls the package's dispatcher ops, which that import registers."""
    if isinstance(data, (str, os.PathLike)):
        with open(data, "rb") as f:
            data = f.read()
    if not isinstance(data, (bytes, bytearray)):
        raise PlanError("load_exported_pipeline: expected artifact bytes or a path")
    if len(data) < 8:
        raise PlanError("pipeline artifact truncated (no header)")
    hlen = int.from_bytes(data[:8], "big")
    if hlen <= 0 or 8 + hlen > len(data):
        raise PlanError("pipeline artifact corrupt (bad header length)")
    try:
        meta = json.loads(bytes(data[8:8 + hlen]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise PlanError(f"pipeline artifact corrupt: {e}") from None
    if meta.get("schema") != PIPELINE_SCHEMA:
        raise ValueError(f"not a pipeline artifact: {meta.get('schema')}")
    if meta.get("version") != AOT_VERSION:
        raise PlanError(
            f"pipeline artifact version {meta.get('version')} != "
            f"supported {AOT_VERSION}")
    program = torch.export.load(io.BytesIO(bytes(data[8 + hlen:])))
    _check_chains(meta, lambda kernel: _pipeline_sizes(program, kernel),
                  "load_exported_pipeline")
    return ExportedPipeline(meta, program)

