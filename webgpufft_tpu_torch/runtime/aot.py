"""Plan export: serialize one plan's spec, route and tables for serving.

Port of the single-plan half of ``webgpufft_tpu/runtime/aot.py``.  The JAX
artefact is a serialized ``jax.export`` executable; a port plan is eager
torch code around two nvcc-built kernels, so what there is to carry is the
normalized spec, the route the exporting process chose, and the constant
tables (``Plan.consts``).  Artifact layout: 8-byte big-endian header length,
JSON header (schema, version, spec descriptor, route, i/o shapes, table
names), then the tables as plain ``numpy.savez`` bytes (loaded with
``allow_pickle=False``).

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
tables as constants; loading it therefore needs ``import webgpufft_tpu_torch``
(which registers the ops), and every call of the loaded program launches
(and counts) the kernels on a CUDA tensor.  The distributed export needs
multi-GPU plans and raises ``PlanError`` naming the ROADMAP item that ports
them.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..spec import PlanError, spec_to_dict

AOT_SCHEMA = "webgpufft-tpu-torch.aot-plan"
AOT_VERSION = 1


def _route_dict(route) -> Dict[str, Any]:
    return {"mode": route.mode, "impl": route.impl,
            "axis_kinds": list(route.axis_kinds),
            "reasons": [r for r in route.reasons if not r.startswith("measure")]}


def export_plan(plan, *, path: Optional[str] = None) -> bytes:
    """Serialize ``plan`` (spec, route, tables).  Returns the artifact bytes;
    also writes ``path`` when given.  Exec-time offsets and ``out=`` are
    arguments of the loaded plan's call, as of any plan's."""
    tables = {k: v.detach().cpu().numpy() for k, v in plan.consts.items()}
    payload = io.BytesIO()
    np.savez(payload, **{f"t{i}": tables[k] for i, k in enumerate(sorted(tables))})
    header = json.dumps({
        "schema": AOT_SCHEMA,
        "version": AOT_VERSION,
        "spec": spec_to_dict(plan.spec),
        "route": _route_dict(plan.route),
        "route_mode": plan.route.mode,
        "shapes": {"input": None if plan.input_shape is None else list(plan.input_shape),
                   "output": None if plan.output_shape is None else list(plan.output_shape)},
        "tables": sorted(tables),
    }).encode("utf-8")
    blob = len(header).to_bytes(8, "big") + header + payload.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


class ExportedPlan:
    """A loaded artifact: ``ep(x[, kernel=...])`` runs the plan with the
    exported tables.  ``plan`` is the rebuilt ``Plan``."""

    def __init__(self, meta: Dict[str, Any], plan):
        self.meta = meta
        self.plan = plan
        self.shapes = meta.get("shapes", {})
        self.route_mode = meta.get("route_mode")

    def __call__(self, x, kernel=None, **kw):
        return self.plan(x, kernel=kernel, **kw)

    @property
    def spec_dict(self) -> Dict[str, Any]:
        return self.meta.get("spec", {})


def load_exported_plan(data, device="cuda") -> ExportedPlan:
    """Load an artifact produced by :func:`export_plan` (bytes or a path)
    onto ``device``."""
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
    plan = _build_plan(_rebuild_spec(meta["spec"]), _resolve_device(device))
    got = _route_dict(plan.route)
    if got != meta["route"]:
        raise PlanError(
            "load_exported_plan: this process routes the plan differently from "
            "the exporting one", exported=meta["route"], rebuilt=got)
    plan.load_consts(tables)
    return ExportedPlan(meta, plan)


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
    header = json.dumps({
        "schema": PIPELINE_SCHEMA,
        "version": AOT_VERSION,
        "platforms": sorted({a.device.type for a in args}),
        "shapes": [{"shape": list(a.shape), "dtype": str(a.dtype).removeprefix("torch.")}
                   for a in args],
    }).encode("utf-8")
    blob = len(header).to_bytes(8, "big") + header + payload.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


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
    return ExportedPipeline(meta, program)


def export_distributed_plan(*_args, **_kw):
    raise PlanError("export_distributed_plan needs multi-GPU plans, which are "
                    "not ported yet (ROADMAP P12)")
