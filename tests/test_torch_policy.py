"""The case lists of ``tests/test_spec_policy.py`` and
``tests/test_policy_matrix.py`` through the port: spec validation, route
modes and reason codes across the spec space, mostly without running a
transform.

Where a decision still exists on the GPU the port's answer must equal the
JAX package's (validation, axis kinds, forced impls, eligibility reasons,
recorded no-op knobs, plan methods).  Where a JAX case rests on a TPU fact
the port dropped, the port's route is written out beside the JAX one
(``PORT_MATRIX`` and the cases that say so): ``impl: "auto"`` consults a
recorded TPU gate verdict there (xla) and means the Hopper kernels here
(``impl-auto-hopper-kernels``); rank > 1 plans with a digit below 16 stay off
the JAX kernels and on the port's; the 2^22-element operand bound
(``CHUNK_ELEMS``, ``chunked_batch``, ``large-batch-chunk``) does not exist;
``matmulPrecision`` selects an MXU pass count there and is recorded as
``ignored-tpu-knob:matmulPrecision`` here.  Outputs, where a case runs one:
1e-5 * max|expected|.
"""

import dataclasses as dc
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
import webgpufft_tpu_torch.spec as S
from torch_port_support import run_both
from webgpufft_tpu.core.axis import select_axis_kind as j_select_axis_kind
from webgpufft_tpu.core.cplx import interleave, uninterleave
from webgpufft_tpu.plans import transforms as JT
from webgpufft_tpu.runtime import policy as jpolicy
from webgpufft_tpu.spec import normalize_spec as j_normalize_spec
from webgpufft_tpu.utils import mathref as R
from webgpufft_tpu_torch.core.axis import select_axis_kind
from webgpufft_tpu_torch.plans import transforms as TT
from webgpufft_tpu_torch.runtime import policy
from webgpufft_tpu_torch.spec import normalize_spec

AUTO = policy.IMPL_AUTO_REASON


def jbuild(opts):
    return W.create_plan(dict(opts), cache=W.PlanCache())


def tbuild(opts):
    return T.create_plan(dict(opts), device="cpu", cache=T.PlanCache())


def axis_reasons(plan):
    return [r for r in plan.route.reasons if "-axis" in r]


def no_chunking(plan):
    assert not any("chunk" in r for r in plan.route.reasons), plan.route.reasons


# ---------------------------------------------------------------------------
# tests/test_spec_policy.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts,match", [
    ({"type": "nope", "shape": [8]}, "type"),
    ({"type": "c2c", "shape": []}, "shape"),
    ({"type": "c2c", "shape": [0]}, "positive"),
    ({"type": "c2c", "shape": [8], "direction": "up"}, "direction"),
    ({"type": "c2c", "shape": [8], "normalize": "ortho"}, "normalize"),
    ({"type": "r2c", "shape": [8], "inPlace": True}, "inPlace"),
    ({"type": "fftconv", "shape": [8], "precision": "f16-storage"}, "f32"),
])
def test_plan_type_validation(opts, match):
    with pytest.raises(W.PlanError, match=match) as want:
        j_normalize_spec(opts)
    with pytest.raises(T.PlanError, match=match) as got:
        normalize_spec(opts)
    assert str(got.value) == str(want.value)


def test_direction_defaults_and_overrides():
    for opts, direction in [({"type": "fftconv", "shape": [8], "direction": "inverse"}, "forward"),
                            ({"type": "dct2", "shape": [8], "direction": "inverse"}, "inverse")]:
        assert normalize_spec(opts).direction == j_normalize_spec(opts).direction == direction


@pytest.mark.parametrize("n,tuning,kind", [
    (1024, {}, "mixed"), (2310, {}, "mixed"), (17, {}, "rader"), (4093, {}, "rader"),
    (4099, {}, "bluestein"), (101, {"raderMaxPrime": 100}, "bluestein"),
    (34, {}, "bluestein"), (1, {}, "mixed")])
def test_axis_kind_policy(n, tuning, kind):
    opts = {"type": "c2c", "shape": [8], "tuning": tuning}
    assert select_axis_kind(n, 0, normalize_spec(opts).tuning) == kind
    assert j_select_axis_kind(n, 0, j_normalize_spec(opts).tuning) == kind


def test_force_rader_requires_prime():
    opts = {"type": "c2c", "shape": [12], "tuning": {"forceRaderAxes": [0]}}
    with pytest.raises(ValueError, match="not prime"):
        jbuild(opts)
    with pytest.raises(ValueError, match="not prime"):
        tbuild(opts)


def test_route_metadata_exposed():
    opts = {"type": "c2c", "shape": [16, 17], "batch": 2}
    jplan, plan = jbuild(opts), tbuild(opts)
    assert plan.route.axis_kinds == jplan.route.axis_kinds == ("mixed", "rader")
    assert plan.large_route_mode == plan.route.mode == "xla"
    assert plan.large_route_mode in ("xla", "pallas-fused")
    assert isinstance(plan.large_route_reasons, tuple)
    assert plan.route.attempts == jplan.route.attempts == ("pallas-fused", "xla")


def test_impl_forced_xla():
    opts = {"type": "c2c", "shape": [64], "batch": 16, "tuning": {"impl": "xla"}}
    jplan, plan = jbuild(opts), tbuild(opts)
    assert plan.route.mode == jplan.route.mode == "xla"
    assert "impl-forced-xla" in plan.route.reasons
    assert plan.route.reasons == jplan.route.reasons


def test_impl_forced_pallas_unavailable_raises():
    """[8, 8] x 2: axis 0 has 16 lanes, under K2's 128, in both packages."""
    opts = {"type": "c2c", "shape": [8, 8], "batch": 2, "tuning": {"impl": "pallas"}}
    with pytest.raises(W.PlanError, match="pallas"):
        jbuild(opts)
    with pytest.raises(T.PlanError, match="pallas"):
        tbuild(opts)


def test_unknown_tuning_key_rejected():
    opts = {"type": "c2c", "shape": [8], "tuning": {"warpSpeed": 9}}
    with pytest.raises(W.PlanError, match="tuning"):
        jbuild(opts)
    with pytest.raises(T.PlanError, match="tuning"):
        tbuild(opts)


def test_spec_hashable_and_cached():
    cache = T.PlanCache()
    p1 = T.create_plan({"type": "c2c", "shape": [8]}, device="cpu", cache=cache)
    p2 = T.create_plan({"type": "c2c", "shape": [8]}, device="cpu", cache=cache)
    assert p1 is p2
    p3 = T.create_plan({"type": "c2c", "shape": [8], "batch": 2}, device="cpu", cache=cache)
    assert p3 is not p1
    assert len(cache) == 2


def test_workspace_and_destroy():
    opts = {"type": "c2c", "shape": [32], "batch": 4, "tuning": {"impl": "xla"}}
    plan = tbuild(opts)
    assert plan.get_workspace_size_bytes() > 0
    assert plan.get_workspace_size_bytes() == jbuild(opts).get_workspace_size_bytes()
    plan.destroy()


def test_create_fft_plan_alias():
    p = T.create_fft_plan(shape=[16], direction="forward", device="cpu")
    assert p.spec.plan_type == "c2c"
    with pytest.raises(T.PlanError):
        T.create_fft_plan(type="r2c", shape=[16], device="cpu")


def test_normalize_scale_rule():
    from webgpufft_tpu_torch.utils.mathref import normalize_scale
    for args, want in [(("none", "forward", 64), 1.0), (("backward", "forward", 64), 1.0),
                       (("backward", "inverse", 64), 1.0 / 64),
                       (("unitary", "forward", 64), 1.0 / 8),
                       (("unitary", "inverse", 64), 1.0 / 8)]:
        assert normalize_scale(*args) == R.normalize_scale(*args) == want


def test_selftest_module_passes():
    from webgpufft_tpu_torch.selftest import run
    assert run(device="cpu")


def test_plan_error_details_payload():
    opts = {"type": "c2c", "shape": [8], "batch": 2}
    jplan, plan = jbuild(opts), tbuild(opts)
    with pytest.raises(W.PlanError) as want:
        jplan(np.zeros((3, 8, 2), np.float32))
    with pytest.raises(T.PlanError) as got:
        plan(torch.zeros(3, 8, 2))
    d = got.value.details
    assert d["plan_type"] == "c2c" and d["batch"] == 2 and "route_mode" in d
    assert set(d) == set(want.value.details)


def test_matmul_precision_knob_parsing():
    """The knob parses and resolves as in the JAX package; it selects an MXU
    pass count there (``mxu-precision:*``) and nothing here, where a
    caller's value is recorded as ``ignored-tpu-knob:matmulPrecision``."""
    knob = "ignored-tpu-knob:matmulPrecision"
    for kw, resolved, jreason, recorded in [
            ({}, "highest", None, False),
            ({"precision": "bf16-storage"}, "default", "mxu-precision:default", False),
            ({"precision": "bf16-storage", "tuning": {"matmulPrecision": "highest"}},
             "highest", None, True),
            ({"tuning": {"matmulPrecision": "high"}}, "high", "mxu-precision:high", True)]:
        opts = {"type": "c2c", "shape": [16], **kw}
        jplan, plan = jbuild(opts), tbuild(opts)
        assert plan.spec.tuning.matmul_precision == resolved
        assert jplan.spec.tuning.matmul_precision == resolved
        assert (jreason in jplan.route.reasons) if jreason else not any(
            r.startswith("mxu-precision") for r in jplan.route.reasons)
        assert not any(r.startswith("mxu-precision") for r in plan.route.reasons)
        assert (knob in plan.route.reasons) == recorded
    bad = {"type": "c2c", "shape": [16], "tuning": {"matmulPrecision": "fast"}}
    with pytest.raises(W.PlanError, match="matmulPrecision"):
        jbuild(bad)
    with pytest.raises(T.PlanError, match="matmulPrecision"):
        tbuild(bad)


@pytest.mark.parametrize("opts", [
    *({"type": "c2c", "shape": [48], "batch": 3, "tuning": {"matmulPrecision": mp}}
      for mp in ("highest", "high", "default")),
    {"type": "c2c", "shape": [64, 16], "batch": 2,
     "tuning": {"matmulPrecision": "high", "fourStepMinN": 64}},
    {"type": "dct2", "shape": [8], "batch": 4, "tuning": {"matmulPrecision": "high"}}])
def test_matmul_precision_threads_through_plans(opts, rng, assert_close):
    shape = (opts["batch"], *opts["shape"])
    if opts["type"] == "dct2":
        xr = rng.standard_normal(shape)
        _, _, jy, ty = run_both(opts, xr.astype(np.float32))
        assert_close(ty, R.dct_nd(xr, opts["shape"], "dct2", "forward", "none"), label="mp-dct")
    else:
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        _, _, jy, ty = run_both(opts, interleave(z))
        assert_close(uninterleave(ty), R.fft_nd(z, opts["shape"], "forward"), label=str(opts))
    assert_close(ty, jy, label=f"{opts} port vs JAX")


def test_fftconv_webgpu_tuning_knobs_recorded():
    opts = {"type": "fftconv", "shape": [32],
            "fftConv": {"boundary": "circular",
                        "tuning": {"pointwiseChunkElements": 4096,
                                   "extractCopyChunkElements": 8192}}}
    jplan, plan = jbuild(opts), tbuild(opts)
    for key in ("pointwiseChunkElements", "extractCopyChunkElements"):
        reason = f"ignored-webgpu-knob:fftConv.tuning.{key}"
        assert reason in plan.route.reasons and reason in jplan.route.reasons
    bad = {"type": "fftconv", "shape": [32], "fftConv": {"tuning": {"warpSpeed": 9}}}
    with pytest.raises(W.PlanError, match="fftConv.tuning"):
        jbuild(bad)
    with pytest.raises(T.PlanError, match="fftConv.tuning"):
        tbuild(bad)


def test_every_spec_field_is_consumed_or_recorded():
    """Every field of every spec dataclass is consumed by some module of the
    port outside spec.py or carried by the recorded-knob machinery (the
    TPU-only fields by ``policy.TPU_ONLY_KNOBS``)."""
    pkg = pathlib.Path(S.__file__).resolve().parent
    outside = "\n".join(p.read_text() for p in pkg.rglob("*.py")
                        if p.name != "spec.py" and "__pycache__" not in p.parts)
    spec_classes = [S.PlanSpec, S.TuningSpec, S.FftConvSpec, S.Conv2dSpec, S.LayoutSpec,
                    S.IoViewSpec, S.IoViewSide, S.ZeroPadSpec, S.ZeroPadStage, S.ChannelLane]
    recorded = {"ignored_webgpu_knobs"}
    missing = [f"{cls.__name__}.{f.name}" for cls in spec_classes for f in dc.fields(cls)
               if f.name not in recorded
               and not re.search(rf"\b{re.escape(f.name)}\b", outside)]
    assert not missing, f"spec fields consumed nowhere outside spec.py: {missing}"


def test_max_fused_elements_caps_fused_line():
    base = {"type": "c2c", "shape": [64], "batch": 64}
    for pol, norm in ((policy, normalize_spec), (jpolicy, j_normalize_spec)):
        ok, _ = pol.fused_eligibility(norm({**base, "tuning": {"impl": "pallas-auto"}}))
        capped, reasons = pol.fused_eligibility(norm(
            {**base, "tuning": {"impl": "pallas-auto", "maxFusedElements": 32}}))
        assert ok and not capped
        assert "line-exceeds-max-fused-elements" in reasons


def test_auto_needs_no_gate():
    """``impl: "auto"`` consults a recorded Pallas-vs-XLA verdict in the JAX
    package (shipped: xla) and probes it with ``runtime/pallas_gate.py``; the
    port has neither: ``auto`` means the Hopper kernels wherever they are
    eligible, with the reason saying so."""
    assert jpolicy.load_pallas_gate().get("winner") == "xla"
    opts = {"type": "c2c", "shape": [64], "batch": 64}
    ok, reasons = jpolicy.fused_eligibility(j_normalize_spec(opts))
    assert not ok and any("gate:xla" in r for r in reasons)
    ok, reasons = policy.fused_eligibility(normalize_spec(opts))
    assert ok and reasons == [AUTO]
    assert importlib.util.find_spec("webgpufft_tpu_torch.runtime.pallas_gate") is None
    assert not hasattr(policy, "load_pallas_gate")
    assert importlib.util.find_spec("webgpufft_tpu.runtime.pallas_gate") is not None


@pytest.mark.parametrize("opts", [
    {"type": "c2c", "shape": [16], "layout": {"input": {"strides": [1]}}},
    {"type": "c2c", "shape": [16], "ioView": {"inptu": {"shape": [8]}}},
    {"type": "c2c", "shape": [16], "zeroPad": {"raed": {"start": [0], "end": [8]}}},
    {"type": "fftconv", "shape": [16], "fftConv": {"boundry": "circular"}},
    {"type": "c2c", "shape": [16], "ioView": {"input": {"shpae": [8]}}}])
def test_option_dict_typos_rejected(opts):
    with pytest.raises(W.PlanError):
        W.create_plan(opts)
    with pytest.raises(T.PlanError):
        T.create_plan(opts, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_policy_matrix.py
# ---------------------------------------------------------------------------

# (shape, batch, impl, the JAX package's mode and axis reasons as its own test
# states them, the port's): equal where neither "auto" = xla nor the digit
# rule decided the JAX route
PORT_MATRIX = [
    ([64], 16, "auto", "xla", ["c2c-axis0-xla"], "pallas-fused", ["c2c-axis0-fused-lines"]),
    ([64], 16, "pallas-auto", "pallas-fused", ["c2c-axis0-fused-lines"],
     "pallas-fused", ["c2c-axis0-fused-lines"]),
    ([17], 16, "pallas-auto", "xla", ["c2c-axis0-xla"], "xla", ["c2c-axis0-xla"]),
    ([256, 256], 16, "pallas-auto", "pallas-fused",
     ["c2c-axis0-fused-cols", "c2c-axis1-fused-lines"],
     "pallas-fused", ["c2c-axis0-fused-cols", "c2c-axis1-fused-lines"]),
    ([64, 64], 16, "pallas-auto", "xla", ["c2c-axis0-xla", "c2c-axis1-xla"],
     "pallas-fused", ["c2c-axis0-fused-cols", "c2c-axis1-fused-lines"]),
    ([64, 64], 16, "auto", "xla", ["c2c-axis0-xla", "c2c-axis1-xla"],
     "pallas-fused", ["c2c-axis0-fused-cols", "c2c-axis1-fused-lines"]),
    ([64, 8], 16, "pallas-auto", "xla", ["c2c-axis0-xla", "c2c-axis1-xla"],
     "pallas-mixed", ["c2c-axis0-xla", "c2c-axis1-fused-lines"]),
    ([17, 64], 4, "auto", "xla", ["c2c-axis0-xla", "c2c-axis1-xla"],
     "pallas-mixed", ["c2c-axis0-xla", "c2c-axis1-fused-lines"]),
]


@pytest.mark.parametrize("shape,batch,impl,jmode,jaxis,tmode,taxis", PORT_MATRIX)
def test_c2c_strategy_matrix(shape, batch, impl, jmode, jaxis, tmode, taxis, rng, assert_close):
    opts = {"type": "c2c", "shape": shape, "batch": batch}
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    jplan, plan, jy, ty = run_both(opts, interleave(z), impl=impl)
    assert (jplan.route.mode, axis_reasons(jplan)) == (jmode, jaxis)
    assert (plan.route.mode, axis_reasons(plan)) == (tmode, taxis)
    assert plan.route.axis_kinds == jplan.route.axis_kinds
    assert (AUTO in plan.route.reasons) == (impl == "auto")
    assert_close(ty, jy, label=f"{shape} {impl} port vs JAX")


@pytest.mark.parametrize("batch,n,want_chunk", [
    (4096, 1024, 4096), (4096, 4096, 1024), (4096, 2048, 2048), (8192, 4096, 1024),
    (1, 2 ** 20, 1), (3, 2 ** 22, 1)])
def test_chunk_size_matrix(batch, n, want_chunk):
    """``chunked_batch`` bounds a TPU einsum operand at 2^22 elements; the
    port has no such function and no such bound, and a plan of these sizes
    (built where its tables are small) chunks nothing."""
    assert JT.chunked_batch(batch, n) == want_chunk
    assert JT.CHUNK_ELEMS == 1 << 22
    assert not hasattr(TT, "chunked_batch") and not hasattr(TT, "CHUNK_ELEMS")
    if n <= 4096:
        plan = tbuild({"type": "c2c", "shape": [n], "batch": batch})
        no_chunking(plan)
        assert plan.route.mode == "pallas-fused"


@pytest.mark.parametrize("kind,taxis", [
    ("c2c", ["c2c-axis0-fused-lines"]), ("r2c", ["r2c-axis0-fused-lines"]),
    ("dct2", ["dct-axis0-fft", "dct-axis0-fft-fused-lines"])])
def test_chunk_reason_recorded_across_families(kind, taxis):
    opts = {"type": kind, "shape": [4096], "batch": 4096, "direction": "forward"}
    assert any("large-batch-chunk" in r for r in jbuild(opts).route.reasons)
    plan = tbuild(opts)
    no_chunking(plan)
    assert (plan.route.mode, axis_reasons(plan)) == ("pallas-fused", taxis)


@pytest.mark.parametrize("kinds,shape,tuning", [
    (("mixed",), [60], {}), (("rader",), [101], {}),
    (("bluestein",), [101], {"raderMaxPrime": 50}), (("bluestein",), [34], {}),
    (("mixed", "rader", "bluestein"), [16, 17, 34], {})])
def test_axis_kinds_matrix(kinds, shape, tuning):
    opts = {"type": "c2c", "shape": shape, "batch": 2, "tuning": tuning}
    assert tbuild(opts).route.axis_kinds == jbuild(opts).route.axis_kinds == kinds


def test_fused_attempt_recorded_under_auto():
    opts = {"type": "c2c", "shape": [64], "batch": 16}
    jplan, plan = jbuild(opts), tbuild(opts)
    assert any(r.startswith("impl-auto-prefers-xla") for r in jplan.route.reasons)
    assert "pallas-fused" not in jplan.route.mode
    assert plan.route.reasons[0] == AUTO and plan.route.mode == "pallas-fused"
    assert plan.route.attempts[0] == jplan.route.attempts[0] == "pallas-fused"


def test_dct_route_reasons():
    opts = {"type": "dct2", "shape": [1024, 8], "batch": 2}
    for plan in (jbuild(opts), tbuild(opts)):
        assert "dct-axis0-fft" in plan.route.reasons
        assert "dct-axis1-matmul" in plan.route.reasons


def test_scale_folding_route(rng, assert_close):
    """The normalize scale is folded into the last DFT table: both plans
    carry the same scaled final-level table and no scale pass."""
    opts = {"type": "c2c", "shape": [64], "batch": 2, "normalize": "unitary",
            "tuning": {"impl": "xla"}}
    jplan, plan = jbuild(opts), tbuild(opts)
    jlast = [k for k in jplan._consts if k.endswith("/dft0")]
    last = [k for k in plan._consts if k.endswith("/dft0")]
    assert last and last == jlast
    for k in last:
        assert np.array_equal(np.asarray(plan._consts[k]), np.asarray(jplan._consts[k]))
