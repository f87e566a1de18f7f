"""Execution-route policy: which implementation serves a plan.

Port of ``webgpufft_tpu/runtime/policy.py``.  Route modes and reason codes
keep the JAX package's names so route metadata compares across packages:

- "pallas-fused": every axis runs a hand-written Hopper kernel (K1 on the
                  last axis, K2 on the others).  ``impl`` "pallas" and
                  "pallas-auto" keep their names and mean these kernels.
- "pallas-mixed": some axes run the kernels, the rest the einsum route.
- "four-step-hbm": no kernel runs and some axis takes the four-step
                  einsum route (core/axis.FourStepAxisPlan).
- "xla":          every axis runs the torch einsum route (core/axis.py).

``resolve_route`` gives the plan-level verdict; the plan builders
(plans/transforms.py) then set the mode from the kernel chosen for each
axis pass.  Under ``impl: "xla"`` an r2c/c2r plan keeps the verdict, as in
the JAX package.

The JAX package's ``impl: "auto"`` consults a recorded TPU verdict; the
port has none, and routes ``auto`` like ``pallas-auto`` with the reason code
``impl-auto-hopper-kernels``.  TPU-only tuning knobs are accepted and
recorded as ``ignored-tpu-knob:<key>``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from ..spec import PlanSpec, resolve_auto_tuning

FUSED_MIN_BATCH = 8        # fewest lines the line kernel is routed for
IMPL_AUTO_REASON = "impl-auto-hopper-kernels"
# (TuningSpec field, default, option key) of the TPU-only knobs
TPU_ONLY_KNOBS = (
    ("chunk_elems", None, "chunkElements"),
    ("vmem_limit_bytes", None, "vmemLimitBytes"),
    ("batch_tile", None, "batchTile"),
    ("fused_variant", "v1", "fusedVariant"),
    ("fused_precision", "highest", "fusedPrecision"),
)


def fused_eligibility(spec: PlanSpec) -> Tuple[bool, List[str]]:
    """Can the line kernel serve this plan's last axis?"""
    from ..core import fused

    t = spec.tuning
    if t.impl == "xla":
        return False, ["impl-forced-xla"]
    notes = [IMPL_AUTO_REASON] if t.impl == "auto" else []
    reasons: List[str] = []
    if spec.plan_type != "c2c":
        reasons.append("fused-requires-c2c")
    if spec.precision != "f32":
        reasons.append("fused-requires-f32")
    n_last = spec.shape[-1]
    lines = spec.batch * math.prod(spec.shape[:-1])
    if not fused.supports_length(n_last, t):
        reasons.append("fused-unsupported-length")
    if lines < FUSED_MIN_BATCH:
        reasons.append("fused-batch-too-small")
    if t.max_fused_elements is not None and n_last > t.max_fused_elements:
        reasons.append("line-exceeds-max-fused-elements")
    return not reasons, notes + reasons


def knob_reasons(spec: PlanSpec) -> Tuple[str, ...]:
    """Route reasons recording accepted no-op knobs: the reference's
    WebGPU-only keys and the JAX package's TPU-only keys."""
    t = spec.tuning
    # matmulPrecision "auto" has been resolved by now, to a value that
    # depends on the plan's precision: only another value is the caller's
    auto = resolve_auto_tuning(dataclasses.replace(t, matmul_precision="auto"),
                               spec.precision).matmul_precision
    knobs = TPU_ONLY_KNOBS + (("matmul_precision", auto, "matmulPrecision"),)
    return (tuple(f"ignored-webgpu-knob:{k}" for k in t.ignored_webgpu_knobs)
            + tuple(f"ignored-tpu-knob:{key}" for field, default, key
                    in knobs if getattr(t, field) != default))


def resolve_route(spec: PlanSpec, axis_kinds: Tuple[str, ...]):
    from ..plans.base import RouteInfo

    attempts: List[str] = []
    knobs = knob_reasons(spec)
    ok, reasons = fused_eligibility(spec)
    attempts.append("pallas-fused")
    if ok:
        return RouteInfo(mode="pallas-fused", impl="pallas",
                         axis_kinds=axis_kinds, reasons=tuple(reasons) + knobs,
                         attempts=tuple(attempts))
    attempts.append("xla")
    return RouteInfo(mode="xla", impl="xla", axis_kinds=axis_kinds,
                     reasons=tuple(reasons) + knobs, attempts=tuple(attempts))
