"""Tracing / profiling hooks.

Port of ``webgpufft_tpu/runtime/trace.py`` on ``torch.profiler``:

- ``trace(log_dir)``: context manager that profiles everything executed
  inside (CPU ops and, on a GPU, the CUDA kernels) and writes a Chrome trace
  (``chrome://tracing``, Perfetto, TensorBoard's trace viewer) into
  ``log_dir``.  The port's kernels appear under their own names
  (``fused_lines_kernel``, ``fused_cols_kernel``); every plan call is
  wrapped in a ``wgfft:<plan type>`` span while a trace is being taken.
- ``annotate(name)``: ``torch.profiler.record_function`` (an NVTX-style named
  span in the trace), usable as a context manager.
- ``plan_stats(plan, *example_args)``: one profiled call of the plan beside
  the analytical roofline model of ``runtime/profile.py``.
- ``memory_stats()``: ``torch.cuda.memory_stats`` where a GPU exists.

The JAX package's ``Plan.lower_hlo`` has no counterpart: a port plan is
eager torch code and two hand-written kernels, there is no lowered program
to print.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

import torch

from . import profile as _profile

_active = 0    # traces being taken: plan calls annotate themselves meanwhile


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def tracing() -> bool:
    """Is a ``trace()`` being taken right now?"""
    return _active > 0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed execution and write
    ``<log_dir>/wgfft_<time>.pt.trace.json``; yields the profiler, whose
    ``trace_path`` names the file once the context has closed."""
    global _active
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"wgfft_{time.time_ns()}.pt.trace.json")
    _active += 1
    try:
        with torch.profiler.profile(activities=_activities()) as prof:
            prof.trace_path = path
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        _active -= 1
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named span inside traces (usable as a context manager)."""
    return torch.profiler.record_function(name)


def plan_stats(plan, *example_args, **example_kw) -> Dict[str, Any]:
    """Run ``plan(*example_args)`` once under the profiler and report what it
    did next to the analytical model.

    Returns ``model_flops``, ``model_min_bytes`` (the FLOP and byte models),
    ``flops`` (the profiler's own count over the ops it has a formula for,
    matmuls and convolutions: None when it counted nothing, as for a plan
    that runs only the kernels), ``bytes_accessed`` (None: torch's profiler
    has no per-op byte count), ``arithmetic_intensity`` where both exist,
    and what the port alone can say: ``fused_lines_launches`` and
    ``fused_cols_launches`` of the call, ``torch_ops`` (aten operator calls)
    and, on a GPU, ``device_kernels`` (kernel launches of any kind)."""
    from ..core import fused, fused_cols

    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    with torch.profiler.profile(activities=_activities(), with_flops=True) as prof:
        plan(*example_args, **example_kw)
        if plan.device.type == "cuda":
            torch.cuda.synchronize(plan.device)
    out: Dict[str, Any] = {
        "fused_lines_launches": fused.fused_lines.launches - before[0],
        "fused_cols_launches": fused_cols.fused_cols.launches - before[1],
    }
    events = prof.key_averages()
    flops = sum(e.flops or 0 for e in events)
    out["flops"] = float(flops) if flops else None
    out["bytes_accessed"] = None
    out["torch_ops"] = sum(e.count for e in events if e.key.startswith("aten::"))
    if plan.device.type == "cuda":
        out["device_kernels"] = sum(
            e.count for e in events
            if str(getattr(e, "device_type", "")).endswith("CUDA"))
    spec = plan.spec
    out["model_flops"] = _profile.fft_flops(spec.n_total, spec.batch)
    out["model_min_bytes"] = _profile.fft_min_bytes(spec.n_total, spec.batch)
    if out["flops"] and out["bytes_accessed"]:
        out["arithmetic_intensity"] = out["flops"] / out["bytes_accessed"]
    return out


def memory_stats(device=None) -> Optional[Dict[str, Any]]:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current CUDA
    device), or None where there is no GPU."""
    if not torch.cuda.is_available():
        return None
    return dict(torch.cuda.memory_stats(device))
