"""ND transform assembly: per-axis plans + normalization.

Port of ``webgpufft_tpu/core/engine.py``: each logical axis is one AxisPlan
applied along its array axis.
"""

from __future__ import annotations

from typing import List, Sequence

from .axis import AxisPlan, apply_along_axis, build_axis_plan
from ..utils.mathref import normalize_scale


def build_axis_plans(shape: Sequence[int], direction: str, tuning,
                     prefix: str = "ax") -> List[AxisPlan]:
    return [build_axis_plan(n, d, direction, tuning, f"{prefix}{d}")
            for d, n in enumerate(shape)]


def apply_nd(x, axis_plans: Sequence[AxisPlan], consts, batch_dims: int = 1):
    """Apply per-axis transforms; logical axis d lives at array axis
    batch_dims + d of interleaved x (..., 2).  Axes run last to first, as
    in the JAX package (the passes commute)."""
    for d in range(len(axis_plans) - 1, -1, -1):
        ap = axis_plans[d]
        if ap.n == 1:
            continue  # length-1 axis is the identity
        x = apply_along_axis(x, ap, batch_dims + d, consts)
    return x


def plan_scale(normalize: str, direction: str, n_total: int) -> float:
    """Single per-plan scale factor."""
    return normalize_scale(normalize, direction, n_total)
