"""Plan object + staged execution pipeline.

Port of ``webgpufft_tpu/plans/base.py`` for the no-layout case.  A plan
lives on one torch device: its tables are tensors there, and ``plan(x)``
checks that ``x`` is an interleaved float32 ``(batch, *shape, 2)`` tensor on
that device before it runs, returning a fresh tensor.  Outputs are not
differentiable yet (ROADMAP P9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..spec import PlanError, PlanSpec
from . import stages


@dataclass
class RouteInfo:
    """Routing/diagnostic metadata, field for field as in the JAX package."""
    mode: str = "xla"                      # "xla" | "pallas-fused" | "pallas-mixed"
    impl: str = "xla"
    axis_kinds: Tuple[str, ...] = ()
    reasons: Tuple[str, ...] = ()
    attempts: Tuple[str, ...] = ()


class Plan:
    """Executable transform plan on ``device``; ``plan(x)`` runs it."""

    def __init__(self, spec: PlanSpec, consts: Dict[str, np.ndarray],
                 fn: Callable, route: RouteInfo, *, device: torch.device,
                 input_shape: Tuple[int, ...], output_shape: Tuple[int, ...]):
        self.spec = spec
        self.route = route
        self.device = device
        self.input_shape = input_shape
        self.output_shape = output_shape
        self._fn = fn
        self._consts = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                        for k, v in consts.items()}

    @property
    def consts(self) -> Dict[str, torch.Tensor]:
        """The plan's constant tables (name -> tensor on the plan's device)."""
        return dict(self._consts)

    def load_consts(self, tables: Dict[str, torch.Tensor]) -> "Plan":
        """Replace the plan's tables with ``tables`` (e.g. the JAX package's,
        converted by ``tables_from_reference``): same names and shapes."""
        if set(tables) != set(self._consts):
            raise PlanError("load_consts: table names differ from the plan's",
                            missing=sorted(set(self._consts) - set(tables)),
                            unexpected=sorted(set(tables) - set(self._consts)))
        new = {}
        for k, v in tables.items():
            t = torch.as_tensor(v).to(device=self.device, dtype=torch.float32).contiguous()
            if t.shape != self._consts[k].shape:
                raise PlanError(f"load_consts: table {k!r} has shape "
                                f"{tuple(t.shape)}, the plan's has "
                                f"{tuple(self._consts[k].shape)}")
            new[k] = t
        self._consts = new
        return self

    def __call__(self, x, kernel=None, out=None, **kw):
        return self.exec(x, kernel=kernel, out=out, **kw)

    def exec(self, x, kernel=None, out=None, input_offset_elements=None,
             output_offset_elements=None):
        """Run the plan on ``x`` and return a new tensor."""
        t = self.spec.plan_type
        if out is not None or input_offset_elements is not None \
                or output_offset_elements is not None:
            raise PlanError(f"{t}: out= and exec offsets are not ported yet "
                            "(ROADMAP P7)")
        if kernel is not None:
            raise PlanError(f"{t} exec does not take kernel=")
        if not isinstance(x, torch.Tensor):
            raise PlanError(f"{t}: expected a torch.Tensor, got {type(x).__name__}")
        if x.device != self.device:
            raise PlanError(f"{t}: input is on {x.device}, the plan is on "
                            f"{self.device}", device=str(self.device))
        if x.requires_grad:
            raise PlanError(f"{t}: plan outputs are not differentiable yet "
                            "(ROADMAP P9); pass a tensor that does not "
                            "require grad")
        validate_input_shape(self, x, self.input_shape, True, self.spec.precision)
        want = stages.expect_dtype(self.spec.precision)
        if x.dtype != want:
            raise PlanError(
                f"{t}: expected input dtype {want} for precision "
                f"{self.spec.precision!r}, got {x.dtype}",
                precision=self.spec.precision)
        return self._fn(self._consts, x.contiguous())


def build_staged_fn(spec: PlanSpec, core_fn: Callable,
                    in_domain, out_domain,
                    in_interleaved: bool, out_interleaved: bool):
    """Wrap a core transform with storage load/store; returns
    (fn, in_shape, out_shape).  Specs that need any other staging stage
    raise PlanError (ROADMAP P7)."""
    stages.require_unstaged(spec)

    def fn(consts, x):
        x = stages.load_storage(x, spec.precision)
        y = core_fn(x, consts)
        return stages.store_storage(y, spec.precision)

    in_shape = (spec.batch,) + tuple(in_domain) + ((2,) if in_interleaved else ())
    out_shape = (spec.batch,) + tuple(out_domain) + ((2,) if out_interleaved else ())
    return fn, in_shape, out_shape


def validate_input_shape(plan: Plan, x, expect_shape, interleaved: bool, precision: str):
    """Eager-side shape validation with reference-style rich errors."""
    if tuple(x.shape) != tuple(expect_shape):
        raise PlanError(
            f"{plan.spec.plan_type}: expected input shape {tuple(expect_shape)} "
            f"(batch, *physical{', 2' if interleaved else ''}), got {tuple(x.shape)}",
            plan_type=plan.spec.plan_type, shape=plan.spec.shape,
            batch=plan.spec.batch, precision=precision,
            route_mode=plan.route.mode, route_reasons=plan.route.reasons)
