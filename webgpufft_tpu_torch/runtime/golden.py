"""Golden-vector artifacts: record + replay.

Port of ``webgpufft_tpu/runtime/golden.py``: JSON artifacts of {plan opts,
input, expected output} (base64 float buffers) that can be committed,
diffed, and replayed across packages and hardware.  The schema is the JAX
package's, so ``tests/golden_corpus.json`` replays through the port
unchanged; ``device=`` says where.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

GOLDEN_SCHEMA = "webgpufft-tpu-golden"
GOLDEN_VERSION = 1


def _enc(arr: np.ndarray) -> Dict[str, Any]:
    arr = np.ascontiguousarray(arr)
    return {
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "data_b64": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def _dec(d: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(d["data_b64"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def _run(plan_opts: Dict[str, Any], x: np.ndarray, kernel: Optional[np.ndarray],
         device) -> np.ndarray:
    """One plan built from ``plan_opts`` (in a cache of its own) on
    ``device``, applied to host arrays; the result as a float host array."""
    from .. import PlanCache, create_plan
    from ..plans import stages

    plan = create_plan(dict(plan_opts), device=device, cache=PlanCache())
    xt = torch.as_tensor(np.asarray(x), device=plan.device)
    if plan.input_shape is not None:       # conv2d takes what it is given
        xt = xt.to(stages.expect_dtype(plan.spec.precision))
    kw = {}
    if kernel is not None:
        kw["kernel"] = torch.as_tensor(np.asarray(kernel, dtype=np.float32),
                                       device=plan.device)
    return plan(xt, **kw).float().cpu().numpy()


def record_artifact(plan_opts: Dict[str, Any], input_arr: np.ndarray,
                    kernel: Optional[np.ndarray] = None,
                    expected: Optional[np.ndarray] = None,
                    name: str = "", device="cuda") -> Dict[str, Any]:
    """Build a golden artifact.  When ``expected`` is omitted the plan is
    executed now, on ``device``, and its output recorded as the expectation."""
    if expected is None:
        expected = _run(plan_opts, input_arr, kernel, device)
    art = {
        "schema": GOLDEN_SCHEMA,
        "version": GOLDEN_VERSION,
        "name": name,
        "planOpts": plan_opts,
        "input": _enc(np.asarray(input_arr)),
        "expected": _enc(np.asarray(expected)),
    }
    if kernel is not None:
        art["kernel"] = _enc(np.asarray(kernel))
    return art


def compare_golden(artifact: Dict[str, Any], atol_scale: float = 1e-4,
                   device="cuda") -> Dict[str, Any]:
    """Replay an artifact on ``device``.  Returns a result dict
    {name, ok, max_rel_err}; raises on schema mismatch."""
    if artifact.get("schema") != GOLDEN_SCHEMA:
        raise ValueError(f"unrecognized golden schema {artifact.get('schema')!r}")
    if artifact.get("version") not in (1,):
        raise ValueError(f"unsupported golden version {artifact.get('version')}")
    kernel = _dec(artifact["kernel"]) if "kernel" in artifact else None
    got = _run(artifact["planOpts"], _dec(artifact["input"]), kernel,
               device).astype(np.float64)
    want = _dec(artifact["expected"]).astype(np.float64)
    scale = max(np.max(np.abs(want)), 1e-12)
    err = float(np.max(np.abs(got - want)) / scale)
    return {"name": artifact.get("name", ""), "ok": err <= atol_scale,
            "max_rel_err": err}


def save_artifacts(path: str, artifacts: List[Dict[str, Any]]):
    with open(path, "w") as f:
        json.dump({"schema": GOLDEN_SCHEMA, "version": GOLDEN_VERSION,
                   "artifacts": artifacts}, f)


def load_artifacts(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != GOLDEN_SCHEMA:
        raise ValueError("not a golden-vector file")
    return doc["artifacts"]
