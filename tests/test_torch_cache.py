"""The PyTorch port's plan cache and snapshots (``runtime/cache.py``), case
by case as ``tests/test_cache.py`` holds the JAX package's, plus the round
trip of a snapshot between the two packages in both directions."""

import json

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.core.cplx import interleave, uninterleave
from webgpufft_tpu_torch.runtime import cache as C
from webgpufft_tpu_torch.utils import mathref as R

CPU = torch.device("cpu")
SPECS = [
    {"type": "c2c", "shape": [16], "batch": 2, "normalize": "unitary"},
    {"type": "fftconv", "shape": [8],
     "fftConv": {"boundary": "linear-same", "kernelShape": [3], "kernelCount": 2}},
    {"type": "dct2", "shape": [8, 8], "direction": "inverse",
     "ioView": {"input": {"shape": [6, 6], "placement": "center"}},
     "zeroPad": {"read": {"start": [1, 0], "end": [8, 8]}}},
    {"type": "r2c", "shape": [16, 8], "batch": 3,
     "layout": {"whdcn": {"output": {"channels": 3, "channelIndex": 1}}}},
    {"type": "conv2d", "shape": [8, 8], "conv": {"kernelSize": 3, "padding": "explicit",
                                                 "pad": [1, 0, 1, 0]}},
    {"type": "c2c", "shape": [34], "tuning": {"forceBluesteinAxes": [0], "maxSubLength": 16}},
]


def _fill(pkg, cache, specs=SPECS):
    for opts in specs:
        if pkg is T:
            T.create_plan(opts, device="cpu", cache=cache)
        else:
            W.create_plan(opts, cache=cache)


def test_snapshot_roundtrip():
    cache = T.PlanCache()
    _fill(T, cache, SPECS[:3])
    snap = C.export_plan_cache_snapshot(cache)
    assert snap["schema"] == C.SNAPSHOT_SCHEMA == "webgpufft-tpu.plan-cache"
    assert snap["version"] == 3 and snap["metadata"]["plans"] == 3
    assert snap["metadata"]["framework"].startswith("webgpufft-tpu-torch/")
    snap2 = json.loads(json.dumps(snap))       # must survive JSON
    fresh = T.PlanCache()
    n = C.import_plan_cache_snapshot(snap2, cache=fresh, device="cpu")
    assert n == 3 and len(fresh) == 3
    T.create_plan(SPECS[0], device="cpu", cache=fresh)
    assert len(fresh) == 3                     # a cache hit, no new entry


@pytest.mark.parametrize("opts", SPECS, ids=[s["type"] + str(i) for i, s in enumerate(SPECS)])
def test_rebuild_spec_is_exact(opts):
    spec = T.create_plan(opts, device="cpu", cache=T.PlanCache()).spec
    d = json.loads(json.dumps(T.spec.spec_to_dict(spec)))
    assert C._rebuild_spec(d) == spec


@pytest.mark.parametrize("opts", SPECS, ids=[s["type"] + str(i) for i, s in enumerate(SPECS)])
def test_snapshot_from_jax_package_imports_into_port(opts):
    own = W.PlanCache()
    W.create_plan(opts, cache=own)
    snap = json.loads(json.dumps(W.export_plan_cache_snapshot(own)))
    fresh = T.PlanCache()
    assert T.import_plan_cache_snapshot(snap, cache=fresh, device="cpu") == 1
    T.create_plan(opts, device="cpu", cache=fresh)
    assert len(fresh) == 1, "the imported spec is not the live cache key"


@pytest.mark.parametrize("opts", SPECS, ids=[s["type"] + str(i) for i, s in enumerate(SPECS)])
def test_snapshot_from_port_imports_into_jax_package(opts):
    own = T.PlanCache()
    T.create_plan(opts, device="cpu", cache=own)
    snap = json.loads(json.dumps(T.export_plan_cache_snapshot(own)))
    fresh = W.PlanCache()
    assert W.import_plan_cache_snapshot(snap, cache=fresh) == 1
    W.create_plan(opts, cache=fresh)
    assert len(fresh) == 1, "the imported spec is not the live cache key"


def test_measured_records_cross_packages_without_applying():
    """A measured decision is keyed by device identity: the other package's
    records ride along in the snapshot and never match this one's devices.
    The snapshot's plans are not built (``build=False``): a built one could
    be the very spec the port's timing then picks, and ``create_plan`` notes
    the measurement only on a plan it creates, so the outcome would rest on
    which candidate wins the clock."""
    own = W.PlanCache()
    W.create_plan({"type": "c2c", "shape": [512], "batch": 4,
                   "tuning": {"rigor": "measure"}}, cache=own)
    snap = json.loads(json.dumps(W.export_plan_cache_snapshot(own)))
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(snap, cache=fresh, build=False, device="cpu")
    assert fresh.measured == snap["measured"]
    p = T.create_plan({"type": "c2c", "shape": [512], "batch": 4,
                       "tuning": {"rigor": "measure"}}, device="cpu", cache=fresh)
    assert any(r.startswith("measured-winner:") for r in p.route.reasons)
    assert len(fresh.measured) == 2


@pytest.mark.parametrize("winner", ["imported", "another"])
def test_measured_create_after_a_built_import(monkeypatch, winner):
    """The case ``build=False`` above steps around, pinned with both
    packages' winners forced: after an import that built its plans (the JAX
    package's winner, maxSubLength=16), a measured create records its
    decision either way.  A winner the import already built comes
    back as that very plan with its route untouched (it may be shared); a
    winner the call builds carries the ``measured-winner:`` note."""
    import webgpufft_tpu.runtime.measure as JM
    from webgpufft_tpu_torch.runtime import measure as M
    from webgpufft_tpu_torch.spec import normalize_spec
    opts = {"type": "c2c", "shape": [512], "batch": 4, "tuning": {"rigor": "measure"}}
    monkeypatch.setattr(JM, "_chain_time", lambda plan, x, **kw: (
        0.5 if plan.spec.tuning.max_sub_length == 16 else 1.0))
    own = W.PlanCache()
    W.create_plan(opts, cache=own)
    snap = json.loads(json.dumps(W.export_plan_cache_snapshot(own)))
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(snap, cache=fresh, device="cpu")
    (imported,) = fresh.specs()
    assert imported.tuning.max_sub_length == 16
    held = fresh.get(imported, CPU)
    before = held.route.reasons
    other = 16 if winner == "imported" else 64
    monkeypatch.setattr(M, "_call_time", lambda plan, x: (
        0.5 if plan.spec.tuning.max_sub_length == other else 1.0))
    p = T.create_plan(opts, device="cpu", cache=fresh)
    assert len(fresh.measured) == 2
    rec = fresh.measured[M.measure_key(normalize_spec(opts), CPU)]
    assert rec["trials_ms"][rec["winner"]] == 500.0
    assert rec["winner"] == f"maxSubLength={other}"
    if winner == "imported":
        assert p is held and p.route.reasons == before
    else:
        assert p is not held and p.spec.tuning.max_sub_length == other
        assert "measured-winner:maxSubLength=64@2.00x" in p.route.reasons


def test_snapshot_rejects_stale_chunk_bound():
    cache = T.PlanCache()
    T.create_plan(SPECS[0], device="cpu", cache=cache)
    snap = json.loads(json.dumps(C.export_plan_cache_snapshot(cache)))
    snap["specs"][0]["tuning"]["chunk_elems"] = 1 << 25
    with pytest.raises(ValueError, match="could not be rebuilt"):
        C.import_plan_cache_snapshot(snap, cache=T.PlanCache(), device="cpu")


def test_snapshot_rejects_bad_schema():
    with pytest.raises(ValueError, match="schema"):
        C.import_plan_cache_snapshot({"schema": "other", "version": 1})
    with pytest.raises(ValueError, match="schema"):
        C.import_plan_cache_snapshot("not a dict")
    with pytest.raises(ValueError, match="version"):
        C.import_plan_cache_snapshot({"schema": C.SNAPSHOT_SCHEMA, "version": 99})


def test_rebuilt_plan_executes(rng, assert_close):
    cache = T.PlanCache()
    T.create_plan({"type": "c2c", "shape": [12], "batch": 2}, device="cpu", cache=cache)
    snap = json.loads(json.dumps(C.export_plan_cache_snapshot(cache)))
    fresh = T.PlanCache()
    C.import_plan_cache_snapshot(snap, cache=fresh, device="cpu")
    plan = T.create_plan({"type": "c2c", "shape": [12], "batch": 2}, device="cpu", cache=fresh)
    z = rng.standard_normal((2, 12)) + 1j * rng.standard_normal((2, 12))
    y = uninterleave(plan(torch.from_numpy(interleave(z))).numpy())
    assert_close(y, R.fft_nd(z, [12], "forward"), label="rebuilt plan")


def test_snapshot_at_plan_creation():
    cache = T.PlanCache()
    T.create_plan(type="c2c", shape=[16], batch=2, device="cpu", cache=cache)
    snap = T.export_plan_cache_snapshot(cache)
    fresh = T.PlanCache()
    p2 = T.create_plan({"type": "c2c", "shape": [32], "cache": {"snapshot": snap}},
                       device="cpu", cache=fresh)
    assert len(fresh) == 2 and p2.spec.shape == (32,)
    assert all(dev == CPU for _, dev in fresh._plans)
    with pytest.raises(T.PlanError, match="cache option"):
        T.create_plan({"type": "c2c", "shape": [8], "cache": "bogus"}, device="cpu",
                      cache=T.PlanCache())


def test_snapshot_import_without_build_touches_no_device():
    cache = T.PlanCache()
    _fill(T, cache, SPECS[:2])
    snap = C.export_plan_cache_snapshot(cache)
    fresh = T.PlanCache()
    # the default device is the GPU: build=False must not need one
    assert C.import_plan_cache_snapshot(snap, cache=fresh, build=False) == 2
    assert len(fresh) == 0


def test_snapshot_legacy_v1_upgrade():
    own = T.PlanCache()
    T.create_plan(type="dct2", shape=[8], batch=2, device="cpu", cache=own)
    snap = T.export_plan_cache_snapshot(own)
    legacy = dict(snap, version=1, metadata={"plans": 1})
    legacy.pop("measured")
    fresh = T.PlanCache()
    assert T.import_plan_cache_snapshot(legacy, cache=fresh, device="cpu") == 1
    assert len(fresh) == 1 and fresh.measured == {}
    up = C.upgrade_snapshot(legacy)
    assert up["version"] == 3 and up["metadata"]["framework"] == "webgpufft-tpu/legacy-v1"
    assert legacy["version"] == 1              # the caller's dict is untouched
    with pytest.raises(ValueError, match="version"):
        C.upgrade_snapshot({"schema": C.SNAPSHOT_SCHEMA, "version": 99})


def test_v2_snapshot_upgrades_with_empty_measured():
    cache = T.PlanCache()
    T.create_plan({"type": "c2c", "shape": [32], "batch": 2}, device="cpu", cache=cache)
    snap = T.export_plan_cache_snapshot(cache)
    legacy = {k: v for k, v in snap.items() if k != "measured"}
    legacy["version"] = 2
    fresh = T.PlanCache()
    assert T.import_plan_cache_snapshot(legacy, cache=fresh, device="cpu") == 1
    assert fresh.measured == {}


def test_snapshot_without_matmul_precision_prewarms():
    own = T.PlanCache()
    T.create_plan(type="c2c", shape=[16], batch=2, device="cpu", cache=own)
    snap = T.export_plan_cache_snapshot(own)
    for s in snap["specs"]:
        s["tuning"].pop("matmul_precision", None)
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(snap, cache=fresh, device="cpu")
    T.create_plan(type="c2c", shape=[16], batch=2, device="cpu", cache=fresh)
    assert len(fresh) == 1, "prewarmed plan was not reused (cache key drift)"


def test_snapshot_as_keyword_cache_option():
    own = T.PlanCache()
    T.create_plan(type="c2c", shape=[16], device="cpu", cache=own)
    snap = T.export_plan_cache_snapshot(own)
    p = T.create_plan(type="c2c", shape=[32], device="cpu", cache={"snapshot": snap})
    assert p.spec.shape == (32,)
    with pytest.raises(T.PlanError, match="once"):
        T.create_plan({"type": "c2c", "shape": [8], "cache": {"snapshot": snap}},
                      device="cpu", cache={"snapshot": snap})


def test_plan_get_pipeline_cache_snapshot():
    cache = T.PlanCache()
    plan = T.create_plan({"type": "c2c", "shape": [16]}, device="cpu", cache=cache)
    assert plan._plan_cache is cache
    snap = plan.get_pipeline_cache_snapshot()
    assert any(tuple(s["shape"]) == (16,) for s in snap["specs"])
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(snap, cache=fresh, device="cpu")
    assert len(fresh) == 1


def test_cache_api_adopt_specs_clear():
    cache = T.PlanCache()
    plan = T._build_plan(T.spec.normalize_spec({"type": "c2c", "shape": [8]}), CPU)
    cache.adopt(plan.spec, plan)
    assert cache.get(plan.spec, CPU) is plan and plan._plan_cache is cache
    other = T._build_plan(plan.spec, CPU)
    cache.adopt(plan.spec, other)              # the first plan stays
    assert cache.get(plan.spec, CPU) is plan
    assert cache.specs() == [plan.spec] and len(cache) == 1
    cache.measured["k"] = {"winner": "as-requested"}
    cache.clear()
    assert len(cache) == 0 and cache.measured == {} and cache.specs() == []


def test_enable_persistent_compilation_cache_moves_the_build_dir(tmp_path):
    from webgpufft_tpu_torch import _build
    was = _build.BUILD_DIR
    try:
        T.enable_persistent_compilation_cache(str(tmp_path / "kernels"))
        assert _build.BUILD_DIR == tmp_path / "kernels"
        assert _build.library_path().parent == tmp_path / "kernels"
        assert not (tmp_path / "kernels").exists()     # created at the first build
    finally:
        _build.set_build_dir(was)


@pytest.mark.parametrize("shape", [(4,), (3, 5), (2, 3, 4)])
def test_upload_download_complex(shape, rng):
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x = T.upload_complex(z, device="cpu")
    assert x.dtype == torch.float32 and tuple(x.shape) == shape + (2,)
    back = T.download_complex(x)
    assert back.dtype == np.complex128 and np.allclose(back, z, atol=1e-6)
    assert np.array_equal(back, W.download_complex(np.asarray(W.upload_complex(z))))
    assert {"upload_complex", "download_complex"} <= set(T.__all__)
