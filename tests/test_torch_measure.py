"""The PyTorch port's measured planner (``tuning.rigor: "measure"``,
``runtime/measure.py``) on the CPU device, where it times with
``perf_counter``: case by case as ``tests/test_measure.py`` holds the JAX
package's.  What the port decided otherwise is tested as decided: there is no
trace to defer under, and errors other than a candidate's ineligibility
propagate."""

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.runtime import measure as M
from webgpufft_tpu_torch.spec import normalize_spec


def _opts(batch=4, **tuning):
    return {"type": "c2c", "shape": [512], "batch": batch, "direction": "forward",
            "normalize": "unitary", "tuning": {"rigor": "measure", **tuning}}


def _plan(opts, cache):
    return T.create_plan(opts, device="cpu", cache=cache)


def test_measure_builds_working_plan_and_records(rng):
    cache = T.PlanCache()
    p = _plan(_opts(), cache)
    assert [r for r in p.route.reasons if r.startswith("measured")], p.route.reasons
    (key, rec), = cache.measured.items()
    assert key.startswith("cpu|")
    assert rec["winner"] in rec["trials_ms"] and len(rec["trials_ms"]) >= 2
    x = torch.from_numpy(rng.standard_normal((4, 512, 2)).astype(np.float32))
    pe = _plan({**_opts(), "tuning": {}}, cache)
    assert float((p(x) - pe(x)).abs().max()) < 1e-5


def test_measure_decision_is_cached(monkeypatch):
    cache = T.PlanCache()
    _plan(_opts(), cache)
    monkeypatch.setattr(M, "_call_time",
                        lambda *a, **k: pytest.fail("re-measured a cached decision"))
    p2 = _plan(_opts(), cache)
    assert any(r.startswith("measured-winner:") for r in p2.route.reasons)


def test_second_measured_plan_in_a_fresh_process_cache_is_cached_note(monkeypatch):
    """With the decision known but the plan not yet built (a snapshot import
    with build=False), the plan is annotated ``measured-cached:`` and
    nothing is timed."""
    cache = T.PlanCache()
    _plan(_opts(), cache)
    snap = T.export_plan_cache_snapshot(cache)
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(snap, cache=fresh, build=False)
    monkeypatch.setattr(M, "_call_time", lambda *a, **k: pytest.fail("re-measured"))
    p = _plan(_opts(), fresh)
    (rec,) = cache.measured.values()
    assert f"measured-cached:{rec['winner']}" in p.route.reasons


def test_measure_never_mutates_estimate_callers_plan():
    cache = T.PlanCache()
    est = _plan({**_opts(), "tuning": {}}, cache)
    before = est.route.reasons
    _plan(_opts(), cache)
    assert est.route.reasons == before


def test_measure_caches_degraded_decisions(monkeypatch):
    cache = T.PlanCache()
    tiny = {"type": "c2c", "shape": [16], "batch": 1, "precision": "bf16-storage",
            "tuning": {"rigor": "measure"}}
    p = _plan(tiny, cache)
    assert "measure-no-candidates" in p.route.reasons
    assert len(cache.measured) == 1
    monkeypatch.setattr(M, "candidate_overrides",
                        lambda *a: pytest.fail("re-ran candidate sweep"))
    _plan(tiny, cache)


def test_measure_snapshot_roundtrip(monkeypatch):
    cache = T.PlanCache()
    _plan(_opts(), cache)
    snap = T.export_plan_cache_snapshot(cache)
    assert snap["version"] == 3 and len(snap["measured"]) == 1
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(snap, cache=fresh, device="cpu")
    assert fresh.measured == cache.measured
    monkeypatch.setattr(M, "_call_time", lambda *a, **k: pytest.fail("re-measured"))
    p = _plan(_opts(), fresh)
    (rec,) = cache.measured.values()
    for k, v in (rec["overrides"] or {}).items():
        assert getattr(p.spec.tuning, k) == v


@pytest.mark.parametrize("opts", [
    {"type": "fftconv", "shape": [64], "fftConv": {"boundary": "circular"}},
    {"type": "conv2d", "shape": [8, 8], "conv": {"kernelSize": 3}},
], ids=["fftconv", "conv2d"])
def test_measure_unsupported_types_degrade_gracefully(opts):
    cache = T.PlanCache()
    p = _plan({**opts, "tuning": {"rigor": "measure"}}, cache)
    assert f"measure-unsupported:{opts['type']}" in p.route.reasons
    assert cache.measured == {}


def test_rigor_validation():
    with pytest.raises(T.PlanError, match="rigor"):
        T.create_plan({"type": "c2c", "shape": [16], "tuning": {"rigor": "exhaustive"}},
                      device="cpu")


def test_measured_plan_exports(rng):
    cache = T.PlanCache()
    p = _plan(_opts(), cache)
    q = T.load_exported_plan(T.export_plan(p), device="cpu")
    x = torch.from_numpy(rng.standard_normal((4, 512, 2)).astype(np.float32))
    assert torch.equal(q(x), p(x))


@pytest.mark.parametrize("opts,shape", [
    ({"type": "r2c", "shape": [4096], "batch": 2}, (2, 4096)),
    ({"type": "dct2", "shape": [256], "batch": 4}, (4, 256)),
], ids=["r2c", "dct2"])
def test_shape_changing_plan_measures(opts, shape, rng):
    cache = T.PlanCache()
    p = _plan({**opts, "tuning": {"rigor": "measure"}}, cache)
    assert any(r.startswith("measured") for r in p.route.reasons)
    x = rng.standard_normal(shape).astype(np.float32)
    jp = W.create_plan(opts, cache=W.PlanCache())
    want = np.asarray(jp.exec(x), np.float64)
    got = p(torch.from_numpy(x)).double().numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def _is_baseline(plan):
    t = plan.spec.tuning
    return (t.max_sub_length == 32 and t.impl == "auto" and not t.disable_four_step
            and t.large_route == "auto")


def test_diverging_candidate_rejected_by_numeric_gate(monkeypatch):
    cache = T.PlanCache()
    real = M._output_sample
    monkeypatch.setattr(M, "_output_sample",
                        lambda plan, x: real(plan, x) + (0.0 if _is_baseline(plan) else 1.0))
    p = _plan(_opts(), cache)
    assert "measure-all-candidates-diverged" in p.route.reasons, p.route.reasons
    (rec,) = cache.measured.values()
    assert rec["winner"] == "as-requested" and rec["rejected"]
    assert _is_baseline(p)


def test_partial_divergence_still_measures(monkeypatch):
    cache = T.PlanCache()
    real = M._output_sample
    monkeypatch.setattr(
        M, "_output_sample",
        lambda plan, x: real(plan, x) + (1.0 if plan.spec.tuning.max_sub_length == 16 else 0.0))
    p = _plan(_opts(), cache)
    assert any(r.startswith("measured-winner:") for r in p.route.reasons)
    (rec,) = cache.measured.values()
    assert rec.get("rejected") == ["maxSubLength=16"]
    assert "maxSubLength=16" not in rec["trials_ms"]


def test_stale_cached_override_revalidated():
    cache = T.PlanCache()
    key = M.measure_key(normalize_spec(_opts()), "cpu")
    cache.measured[key] = {"winner": "chunkElements=2^25",
                           "overrides": {"chunk_elems": 1 << 25}, "trials_ms": {}}
    p = _plan(_opts(), cache)
    assert p.spec.tuning.chunk_elems is None
    assert cache.measured[key].get("overrides", {}).get("chunk_elems") is None


def test_win_margin_keeps_the_static_policy(monkeypatch):
    """A candidate within 3 % of the as-requested plan does not displace it;
    one beyond does, and the note carries the speedup."""
    def fake(ratio):
        return lambda plan, x: 1.0 if _is_baseline(plan) else (
            ratio if plan.spec.tuning.impl == "xla" else 2.0)

    # batch 16: K1 serves the as-requested plan, so impl=xla is another route
    monkeypatch.setattr(M, "_call_time", fake(0.98))
    cache = T.PlanCache()
    p = _plan(_opts(batch=16), cache)
    assert "measured-winner:as-requested@1.00x" in p.route.reasons
    assert p.route.mode == "pallas-fused"
    monkeypatch.setattr(M, "_call_time", fake(0.5))
    cache = T.PlanCache()
    p = _plan(_opts(batch=16), cache)
    assert "measured-winner:impl=xla@2.00x" in p.route.reasons
    assert p.spec.tuning.impl == "xla" and p.route.mode == "xla"
    (rec,) = cache.measured.values()
    assert rec["overrides"] == {"impl": "xla"} and rec["trials_ms"]["impl=xla"] == 500.0


def test_a_failing_candidate_is_not_a_slower_candidate(monkeypatch):
    """Only ineligibility (``PlanError`` at build) skips a candidate; an
    error while running or timing one propagates."""
    def boom(plan, x):
        if plan.spec.tuning.impl == "xla":
            raise RuntimeError("CUDA launch failed")
        return 1.0

    monkeypatch.setattr(M, "_call_time", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        _plan(_opts(batch=16), T.PlanCache())
    cache = T.PlanCache()
    p = _plan({"type": "c2c", "shape": [4093], "batch": 2,
               "tuning": {"rigor": "measure"}}, cache)     # impl=pallas: ineligible, skipped
    (rec,) = cache.measured.values()
    assert "impl=pallas" not in rec.get("trials_ms", {})
    assert any(r.startswith("measure") for r in p.route.reasons)


@pytest.mark.parametrize("opts,want,not_want", [
    ({"type": "c2c", "shape": [4096], "batch": 4096},
     ["as-requested", "impl=pallas", "impl=xla", "four-step=forced", "four-step=off",
      "maxSubLength=16", "maxSubLength=64"], ["maxSubLength=32"]),
    ({"type": "c2c", "shape": [64], "batch": 8, "tuning": {"impl": "xla"}},
     ["as-requested"], ["impl=xla", "impl=pallas", "maxSubLength=16", "four-step=off"]),
    ({"type": "r2c", "shape": [256, 256, 256], "batch": 3},
     ["impl=pallas", "impl=xla", "maxSubLength=16"], ["four-step=forced"]),
    ({"type": "c2c", "shape": [1024], "precision": "bf16-storage"},
     ["maxSubLength=16"], ["impl=xla"]),
    ({"type": "dct2", "shape": [8192], "batch": 2}, ["impl=xla"], ["four-step=off"]),
], ids=["c2c4096", "forced-xla", "r2c256", "bf16", "dct"])
def test_candidate_overrides(opts, want, not_want):
    descs = [d for d, _ in M.candidate_overrides(normalize_spec(opts))]
    assert descs[0] == "as-requested"
    assert set(want) <= set(descs) and not set(not_want) & set(descs)
    assert not any(d.startswith("chunkElements") for d in descs)


def test_measure_key_and_strip_rigor():
    spec = normalize_spec(_opts())
    assert M.strip_rigor(spec).tuning.rigor == "estimate"
    assert M.strip_rigor(M.strip_rigor(spec)) == M.strip_rigor(spec)
    assert M.measure_key(spec, "cpu") == M.measure_key(M.strip_rigor(spec), "cpu")
    assert M.measure_key(spec, "cpu") != M.measure_key(
        normalize_spec({**_opts(), "batch": 8}), "cpu")
    assert M.device_identity("cpu") == "cpu"


def test_synth_input_is_seeded_and_typed():
    p = T.create_plan({"type": "c2c", "shape": [64], "batch": 2, "precision": "bf16-storage"},
                      device="cpu", cache=T.PlanCache())
    a, b = M._synth_input(p), M._synth_input(p)
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == (2, 64, 2) and torch.equal(a, b)
    flat = T.create_plan({"type": "c2c", "shape": [8], "layout": {"inputStrides": [2]}},
                         device="cpu", cache=T.PlanCache())
    assert M._synth_input(flat) is None
