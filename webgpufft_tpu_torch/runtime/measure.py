"""Measured plan selection, the analog of FFTW's ``FFTW_MEASURE``.

Port of ``webgpufft_tpu/runtime/measure.py``.  ``tuning.rigor`` selects the
planner effort:

- ``"estimate"`` (default): build the statically-policied plan.
- ``"measure"``: additionally build a small set of route-alternative
  candidates, time each on the plan's device in alternating rounds (best-of
  per candidate, so drift hits all alike) and return the fastest.

Measured decisions are cached on the ``PlanCache`` keyed by device identity
(``cuda/<device name>`` or ``cpu``) plus the normalized spec, and persist
through plan-cache snapshots (schema v3), so a serving process prewarmed from
a snapshot reuses the measured winner without re-timing.  The static policy
is the noise-guarded default: a candidate must beat the as-requested
configuration by more than 3 % to displace it.

The candidate set explores the decisions the static policy makes from
thresholds (inherited from the JAX package, not measured on a GPU):

- ``impl``: the hand-written Hopper kernels (``impl=pallas``, the JAX
  package's name for its kernels) against the einsum route (``impl=xla``);
- the four-step decomposition forced or off, for an axis of 4096 or more;
- ``maxSubLength`` 16/32/64: stage count against per-stage work on the
  einsum route.

Timing is ``runtime/profile.time_queued``: CUDA events around back-to-back
calls on a CUDA device, ``perf_counter`` on the CPU.  Measurement dispatches
real device work at plan-build time (it is deliberately slow once); keep it
out of latency-critical paths and let the cache or a snapshot amortize it.

Where the port differs from the JAX package:

- nothing here runs under a trace, so ``measure-deferred-under-trace`` has
  no trigger and is not carried;
- the JAX ``run_measure`` never raises on timing trouble and degrades to the
  static policy.  The port narrows that: a candidate that is *ineligible*
  (``PlanError`` at build) is skipped, but a kernel that fails to build or
  launch, or any other error while running or timing a candidate,
  propagates.  A broken kernel is never "a slower candidate".
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..spec import PlanError, PlanSpec, spec_to_dict, validate_tuning
from . import profile

# Candidates must beat the as-requested config by this factor to win.
WIN_MARGIN = 1.03
# Alternating rounds x back-to-back calls per timed run x runs per round;
# small on purpose: plan build is the wrong place for long benchmarks.
MEASURE_ROUNDS = 2
MEASURE_UNROLL = 4
MEASURE_REPS = 2
# No sub-length sweep on tiny transforms: the stage tables are identical
# below 16 and the timing is all dispatch overhead.
SUBLEN_MIN_AXIS = 128
# Axes at or above this may be four-step decomposed when forced; keep the
# toggle candidates out of small plans where the route can never apply.
FOURSTEP_CANDIDATE_MIN_AXIS = 1 << 12

# A route alternative must agree with the baseline plan before timing may
# select it; the comparison reads back a bounded strided sample.
AGREE_RTOL = 1e-4
AGREE_SAMPLES = 4096


def _replace_tuning(spec: PlanSpec, **overrides) -> PlanSpec:
    return dataclasses.replace(
        spec, tuning=dataclasses.replace(spec.tuning, **overrides))


def strip_rigor(spec: PlanSpec) -> PlanSpec:
    """The concrete spec a measured plan is keyed and built under."""
    if spec.tuning.rigor == "estimate":
        return spec
    return _replace_tuning(spec, rigor="estimate")


def device_identity(device) -> str:
    """``cuda/<device name>`` or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda/{torch.cuda.get_device_name(dev)}"
    return dev.type


def measure_key(spec: PlanSpec, device="cuda") -> str:
    """Stable cache key: device identity + the full normalized spec."""
    return device_identity(device) + "|" + json.dumps(
        spec_to_dict(strip_rigor(spec)), sort_keys=True, default=str)


def candidate_overrides(spec: PlanSpec) -> List[Tuple[str, Dict[str, Any]]]:
    """(description, tuning-overrides) candidates, baseline first."""
    t = spec.tuning
    cands: List[Tuple[str, Dict[str, Any]]] = [("as-requested", {})]
    # impl flip: only explore when the caller left the choice open and the
    # kernels may serve the plan at all.  A plan the kernels cannot serve on
    # every axis fails to build under impl=pallas and is skipped.
    if t.impl in ("auto", "pallas-auto") and spec.precision == "f32":
        cands.append(("impl=pallas", {"impl": "pallas"}))
        cands.append(("impl=xla", {"impl": "xla"}))
    if spec.plan_type in ("c2c", "r2c", "c2r") and t.large_route == "auto" \
            and not t.disable_four_step \
            and max(spec.shape) >= FOURSTEP_CANDIDATE_MIN_AXIS:
        cands.append(("four-step=forced", {"large_route": "out-of-core"}))
        cands.append(("four-step=off", {"disable_four_step": True}))
    if max(spec.shape) >= SUBLEN_MIN_AXIS:
        for sub in (16, 32, 64):
            if sub != t.max_sub_length:
                cands.append((f"maxSubLength={sub}", {"max_sub_length": sub}))
    return cands


def _synth_input(plan) -> Optional[torch.Tensor]:
    """A deterministic input of the plan's expected shape and dtype on its
    device, or None when the plan's exec contract is not one dense tensor."""
    from ..plans import stages

    shape = plan.input_shape
    if plan.needs_kernel or shape is None or tuple(shape) == (None,):
        return None
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return x.to(device=plan.device, dtype=stages.expect_dtype(plan.spec.precision))


def _output_sample(plan, x) -> np.ndarray:
    """Bounded strided sample of the plan's output on x (f64 host copy)."""
    y = plan(x).reshape(-1)
    stride = max(1, y.shape[0] // AGREE_SAMPLES)
    return y[::stride][:AGREE_SAMPLES].double().cpu().numpy()


def _agrees(ref: np.ndarray, plan, x) -> bool:
    """True when the plan's sampled output matches the baseline sample."""
    got = _output_sample(plan, x)
    if got.shape != ref.shape:
        return False
    denom = max(float(np.linalg.norm(ref)), 1e-30)
    return float(np.linalg.norm(got - ref)) / denom <= AGREE_RTOL


def _call_time(plan, x) -> float:
    """Seconds per ``plan(x)``: the best of MEASURE_REPS runs of
    MEASURE_UNROLL back-to-back calls."""
    ms = profile.time_queued(plan, x, runs=MEASURE_REPS, queued=MEASURE_UNROLL,
                             warmup=1, device=plan.device)
    return max(min(ms) * 1e-3, 1e-9)


def run_measure(spec: PlanSpec, cache, device):
    """Resolve a rigor="measure" spec to its measured-winner concrete spec.

    Returns (winner_spec, route_reason_notes, winner_plan_or_None): the
    winner plan, already built for timing, is handed back so the caller can
    seed it into the ``PlanCache``.  A spec with nothing to compare settles
    on the static policy with a reason, and that decision is cached too, so
    repeated measure-rigor calls do not rebuild candidates.  Errors other
    than a candidate's ineligibility propagate (see the module docstring).
    """
    from .. import _build_plan

    base = strip_rigor(spec)
    key = measure_key(spec, device)
    hit = cache.measured.get(key)
    if hit is not None:
        ov = hit.get("overrides") or {}
        note = hit.get("winner", "as-requested")
        try:
            # cached overrides may predate a validation tightening:
            # re-validate so a stale snapshot cannot rebuild a forbidden config
            cached = _replace_tuning(base, **ov)
            validate_tuning(cached.tuning)
            return cached, (f"measured-cached:{note}",), None
        except (PlanError, TypeError):
            del cache.measured[key]  # stale record: fall through, re-measure

    if spec.plan_type in ("fftconv", "conv2d"):
        # conv plans take kernel operands; there is no single dense input
        return base, (f"measure-unsupported:{spec.plan_type}",), None

    def settle(note: str):
        cache.measured[key] = {"winner": "as-requested", "overrides": {}, "note": note}
        return base, (note,), None

    built = []
    seen = set()
    for desc, ov in candidate_overrides(base):
        if desc == "as-requested":
            p = _build_plan(base, device)     # a baseline failure is a real error
        else:
            try:
                p = _build_plan(_replace_tuning(base, **ov), device)
            except PlanError:
                continue                      # ineligible candidate: skip
        sig = (p.route.mode, tuple(r for r in p.route.reasons if "-axis" in r),
               p.spec.tuning.max_sub_length)
        if desc != "as-requested" and not ov.get("max_sub_length") and sig in seen:
            continue                          # the toggle was a no-op for this spec
        seen.add(sig)
        built.append((desc, ov, p))
    x = _synth_input(built[0][2]) if built else None
    if x is None or len(built) < 2:
        return settle("measure-no-candidates")

    # Numeric gate: timing alone must never pick between routes that disagree.
    ref = _output_sample(built[0][2], x)
    rejected = [d for d, _ov, p in built[1:] if not _agrees(ref, p, x)]
    if rejected:
        built = [b for b in built if b[0] not in rejected]
    if len(built) < 2:
        cache.measured[key] = {"winner": "as-requested", "overrides": {},
                               "note": "measure-all-candidates-diverged",
                               "rejected": rejected}
        return base, ("measure-all-candidates-diverged",), built[0][2]

    times: Dict[str, float] = {}
    for _ in range(MEASURE_ROUNDS):           # alternating trials, best-of
        for desc, _ov, p in built:
            times[desc] = min(times.get(desc, math.inf), _call_time(p, x))

    base_dt = times[built[0][0]]
    win_desc, win_ov, win_plan = min(built, key=lambda b: times[b[0]])
    if times[win_desc] * WIN_MARGIN >= base_dt:
        win_desc, win_ov, win_plan = "as-requested", {}, built[0][2]
    records = {d: round(times[d] * 1e3, 4) for d in times}
    cache.measured[key] = {"winner": win_desc, "overrides": win_ov,
                           "trials_ms": records,
                           **({"rejected": rejected} if rejected else {})}
    speedup = base_dt / times.get(win_desc, base_dt)
    return (_replace_tuning(base, **win_ov),
            (f"measured-winner:{win_desc}@{speedup:.2f}x",), win_plan)
