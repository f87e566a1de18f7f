"""c2c plan builder.

Port of ``build_c2c`` from ``webgpufft_tpu/plans/transforms.py``.  The
per-axis strategy is the JAX package's, minus its TPU-only parts (the
operand-size chunking, the giant-transform route and the per-rank VMEM
split):

- last axis → K1 (core/fused.py) when a split exists and there are at least
  8 lines, with both digits >= 16 when rank > 1;
- earlier axes → K2 (core/fused_cols.py) when the riding lanes number at
  least 128 and both digits are >= 16;
- any other axis → the einsum route (core/axis.MixedAxisPlan).

The kernels are allowed under ``impl`` "auto", "pallas" and "pallas-auto";
"xla" keeps every axis on the einsum route.  The normalize scale folds into
the last axis's table, and the axes run last to first.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..core import engine, fused, fused_cols
from ..core.axis import apply_along_axis, make_smooth_plan, select_axis_kind
from ..runtime.policy import FUSED_MIN_BATCH, resolve_route
from ..spec import PlanError, PlanSpec
from .base import Plan, RouteInfo, build_staged_fn


def _route_for(spec: PlanSpec) -> RouteInfo:
    kinds = tuple(select_axis_kind(n, d, spec.tuning) for d, n in enumerate(spec.shape))
    return resolve_route(spec, kinds)


def _tables(consts, prefix: str, names) -> Dict[str, torch.Tensor]:
    return {name: consts[f"{prefix}/{name}"] for name in names}


def build_c2c(spec: PlanSpec, device: torch.device) -> Plan:
    """ND complex FFT plan on ``device``."""
    scale = engine.plan_scale(spec.normalize, spec.direction, spec.n_total)
    route = _route_for(spec)
    rank, shape, batch, tun = spec.rank, spec.shape, spec.batch, spec.tuning
    allow_kernels = tun.impl != "xla"

    consts: Dict[str, np.ndarray] = {}
    strategies = []  # (kind, table prefix or AxisPlan)
    axis_plans = engine.build_axis_plans(shape, spec.direction, tun)
    for d in range(rank):
        n = shape[d]
        want_scale = scale if d == rank - 1 else 1.0
        strat = None
        if allow_kernels and n > 1:
            if d == rank - 1:
                lines = batch * math.prod(shape[:-1])
                split = fused.choose_split(n)
                if split is not None and rank > 1 and min(split) < 16:
                    split = None
                if split is not None and lines >= FUSED_MIN_BATCH:
                    consts.update(fused.lines_consts(n, spec.direction,
                                                     want_scale, f"fl{d}"))
                    strat = ("fused-lines", f"fl{d}")
            else:
                lanes = 2 * math.prod(shape[d + 1:])
                csplit = fused_cols.choose_split(n)
                if csplit is not None and lanes >= 128 and min(csplit) >= 16:
                    consts.update(fused_cols.cols_consts(n, spec.direction,
                                                         want_scale, f"fc{d}"))
                    strat = ("fused-cols", f"fc{d}")
        if strat is None:
            ap = axis_plans[d]
            if d == rank - 1 and scale != 1.0 and n > 1:
                # fold the normalize scale into the last sub-DFT table
                ap = make_smooth_plan(n, spec.direction, ap.prefix,
                                      tun.max_sub_length, out_scale=scale,
                                      tuning=tun)
                axis_plans[d] = ap
            consts.update(ap.consts())
            strat = ("xla", ap)
        strategies.append(strat)

    kinds = tuple(k for k, _ in strategies)
    route.reasons = route.reasons + tuple(
        f"c2c-axis{d}-{k}" for d, k in enumerate(kinds))
    if tun.large_route == "out-of-core":
        # four-step axes raise at build_axis_plans, so none is left here
        route.reasons = route.reasons + ("four-step-impossible",)
    if all(k.startswith("fused") for k in kinds):
        route.mode, route.impl = "pallas-fused", "pallas"
    elif any(k.startswith("fused") for k in kinds):
        route.mode, route.impl = "pallas-mixed", "pallas+xla"
    else:
        route.mode, route.impl = "xla", "xla"
    if tun.impl == "pallas" and route.mode != "pallas-fused":
        raise PlanError(
            "tuning.impl='pallas' but the fused kernels cannot serve every "
            f"axis of this plan (per-axis: {kinds})",
            axis_kinds=kinds, reasons=route.reasons)
    last_kind, last_obj = strategies[-1]
    scale_in_kernel = (last_kind == "fused-lines"
                       or getattr(last_obj, "out_scale", 1.0) == scale)

    def core(x, c):
        y = x
        for d in range(rank - 1, -1, -1):
            kind, obj = strategies[d]
            n = shape[d]
            if kind == "fused-lines":
                lines = batch * math.prod(shape[:-1])
                y = fused.fused_lines(y.reshape(lines, n, 2).contiguous(),
                                      _tables(c, obj, fused.TABLE_NAMES))
            elif kind == "fused-cols":
                pre = batch * math.prod(shape[:d])
                lanes = 2 * math.prod(shape[d + 1:])
                y = fused_cols.fused_cols(y.reshape(pre, n, lanes).contiguous(),
                                          _tables(c, obj, fused_cols.TABLE_NAMES))
            elif n > 1:
                y = apply_along_axis(y.reshape(batch, *shape, 2), obj, 1 + d, c)
        y = y.reshape(batch, *shape, 2)
        return y if scale_in_kernel else y * scale

    fn, in_shape, out_shape = build_staged_fn(spec, core, shape, shape, True, True)
    return Plan(spec, consts, fn, route, device=device,
                input_shape=in_shape, output_shape=out_shape)
