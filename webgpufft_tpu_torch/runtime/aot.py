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

The pipeline export (``export_pipeline`` / ``load_exported_pipeline``) needs
the functional facade and the distributed export multi-GPU plans; both raise
``PlanError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional

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


def export_pipeline(*_args, **_kw):
    raise PlanError("export_pipeline is not ported yet: the export of a "
                    "pipeline of facade calls as one artifact is the "
                    "remainder of ROADMAP P10")


def load_exported_pipeline(*_args, **_kw):
    raise PlanError("load_exported_pipeline is not ported yet: the pipeline "
                    "export it would load is the remainder of ROADMAP P10")


def export_distributed_plan(*_args, **_kw):
    raise PlanError("export_distributed_plan needs multi-GPU plans, which are "
                    "not ported yet (ROADMAP P12)")
