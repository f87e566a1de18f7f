"""The PyTorch port's tracing hooks (``runtime/trace.py``) on the CPU, as
``tests/test_trace.py`` holds the JAX package's, plus what the port adds:
the trace file, the plan's own span and the launch counts."""

import json

import numpy as np
import pytest
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.runtime import trace


@pytest.mark.parametrize("opts,k1,k2", [
    ({"type": "c2c", "shape": [64], "batch": 8}, 1, 0),
    ({"type": "c2c", "shape": [8, 256], "batch": 2}, 1, 1),
    ({"type": "c2c", "shape": [64], "batch": 8, "tuning": {"impl": "xla"}}, 0, 0),
], ids=["k1", "k1k2", "einsum"])
def test_plan_stats(opts, k1, k2, rng):
    plan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    x = torch.from_numpy(rng.standard_normal(plan.input_shape).astype(np.float32))
    stats = trace.plan_stats(plan, x)
    n, b = plan.spec.n_total, plan.spec.batch
    assert stats["model_flops"] == 5 * n * np.log2(n) * b
    assert stats["model_min_bytes"] == 2 * n * b * 8
    assert stats["torch_ops"] > 0 and stats["bytes_accessed"] is None
    assert stats["flops"] is None or stats["flops"] > 0
    # on the CPU the wrappers run their plain versions: no kernel launches
    assert stats["fused_lines_launches"] == 0 and stats["fused_cols_launches"] == 0
    assert {"flops", "bytes_accessed", "model_flops", "model_min_bytes"} <= set(stats)


def test_annotate_and_trace(tmp_path, rng):
    plan = T.create_plan(type="c2c", shape=[16], batch=4, device="cpu", cache=T.PlanCache())
    x = torch.from_numpy(rng.standard_normal((4, 16, 2)).astype(np.float32))
    assert not trace.tracing()
    with trace.trace(str(tmp_path / "tr")) as prof:
        assert trace.tracing()
        with trace.annotate("fft-step"):
            plan(x)
    assert not trace.tracing()
    names = {e["name"] for e in json.load(open(prof.trace_path))["traceEvents"]
             if isinstance(e, dict) and "name" in e}
    assert "fft-step" in names and "wgfft:c2c" in names
    assert trace.memory_stats() is None or isinstance(trace.memory_stats(), dict)


def test_plans_are_not_annotated_outside_a_trace(rng):
    plan = T.create_plan(type="c2c", shape=[16], batch=4, device="cpu", cache=T.PlanCache())
    x = torch.from_numpy(rng.standard_normal((4, 16, 2)).astype(np.float32))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        plan(x)
    assert not any(e.key.startswith("wgfft:") for e in prof.key_averages())
