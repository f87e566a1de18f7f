"""webgpufft_tpu_torch — the PyTorch / CUDA port of webgpufft_tpu.

Same options dict, same ``spec.py`` validation, same interleaved float32
``(batch, *shape, 2)`` layout and the same route metadata as the JAX
package, on torch tensors, with the JAX package's Pallas kernels rewritten
as hand-written CUDA kernels for Hopper (``csrc/*.cu``, built with nvcc on
first use):

    plan = create_plan({"type": "c2c", "shape": [1024], "batch": 4096,
                        "direction": "forward", "normalize": "unitary"},
                       device="cuda")
    y = plan(x)              # x: float32 (4096, 1024, 2) on the plan's device

This slice ports c2c plans over smooth axis lengths.  Everything else raises
``PlanError`` naming the ROADMAP item that ports it.  The package imports
torch and numpy only, never JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .spec import PlanError, PlanSpec, normalize_spec
from .plans.base import Plan, RouteInfo
from .runtime.cache import PlanCache, default_cache
from .core.cplx import interleave, uninterleave

__version__ = "0.1.0"

__all__ = [
    "create_plan", "create_fft_plan", "tables_from_reference", "Plan",
    "PlanSpec", "PlanError", "RouteInfo", "PlanCache", "default_cache",
    "interleave", "uninterleave",
]

# plan types outside this slice -> the ROADMAP item that ports them
_NOT_PORTED = {"r2c": "P4", "c2r": "P4", "fftconv": "P6", "conv2d": "P6"}


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"webgpufft_tpu_torch: plan device {dev} requested but "
                "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise PlanError(f"unsupported plan device {dev}")
    return dev


def _build_plan(spec: PlanSpec, device: torch.device) -> Plan:
    """Dispatch a normalized spec to its plan builder."""
    t = spec.plan_type
    if t == "c2c":
        from .plans.transforms import build_c2c
        return build_c2c(spec, device)
    item = _NOT_PORTED.get(t, "P5")  # dct1-4 / dst1-4
    raise PlanError(f"plan type {t!r} is not ported to the PyTorch port yet "
                    f"(ROADMAP {item})", plan_type=t)


def create_plan(opts: Optional[Dict[str, Any]] = None, *, device="cuda",
                cache: Optional[PlanCache] = None, **kwargs) -> Plan:
    """Create (or fetch from cache) an executable transform plan on
    ``device`` (default ``"cuda"``, which fails loudly without a GPU).

    Accepts a reference-style options dict and/or keyword arguments, as
    ``webgpufft_tpu.create_plan`` does.
    """
    merged = dict(opts or {})
    merged.update(kwargs)
    if isinstance(cache, dict):
        if "cache" in merged:
            raise PlanError(
                "cache option given both in the options dict and as a "
                "keyword; pass it once")
        merged["cache"] = cache
        cache = None
    target = cache if cache is not None else default_cache()
    copt = merged.pop("cache", None)
    if copt is not None:
        if not isinstance(copt, dict):
            raise PlanError("cache option must be a dict (e.g. {'snapshot': snap})")
        if copt.get("snapshot") is not None:
            raise PlanError("plan-cache snapshots are not ported yet (ROADMAP P8)")
    spec = normalize_spec(merged)
    if spec.tuning.rigor == "measure":
        raise PlanError("tuning.rigor 'measure' is not ported yet (ROADMAP P8)")
    return target.get_or_create(spec, _resolve_device(device))


def create_fft_plan(opts: Optional[Dict[str, Any]] = None, *, device="cuda",
                    **kwargs) -> Plan:
    """Low-level alias constrained to c2c."""
    merged = dict(opts or {})
    merged.update(kwargs)
    merged.setdefault("type", "c2c")
    if merged["type"] != "c2c":
        raise PlanError("create_fft_plan builds c2c plans only")
    return create_plan(merged, device=device)


def tables_from_reference(np_consts: Dict[str, np.ndarray],
                          device) -> Dict[str, torch.Tensor]:
    """Turn a JAX plan's numpy tables into this port's tables on ``device``.

    ``ax*/…`` (einsum route) and ``fc*/…`` (K2) tables pass through.  The
    K1 tables under each ``fl*`` prefix are recovered from the JAX
    package's Mosaic layout by reshaping and slicing
    (``core.fused.tables_from_reference``); its Mosaic-only tables (``pil``
    and the v2 ``ta``/``tb``) are dropped.  Nothing is recomputed.
    Load the result with ``Plan.load_consts``.
    """
    from .core import fused
    line_prefixes = {k.rsplit("/", 1)[0] for k in np_consts if k.endswith("/g1")}
    out = {k: v for k, v in np_consts.items()
           if k.rsplit("/", 1)[0] not in line_prefixes}
    for prefix in sorted(line_prefixes):
        out.update(fused.tables_from_reference(np_consts, prefix))
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in out.items()}
