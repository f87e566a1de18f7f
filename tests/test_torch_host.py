"""Host side of the PyTorch port against the JAX package: options
validation, table builders, the einsum axis engine, route metadata and the
errors for what the slice does not carry, plus import hygiene (the port
never imports JAX).  Tolerance for computed outputs: 1e-5 * max|expected|.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu import spec as jspec
from webgpufft_tpu.core import axis as jaxis, cplx as jcplx, dft as jdft, engine as jengine
from webgpufft_tpu.utils import factors as jfactors, mathref as jmathref
from webgpufft_tpu_torch import spec as tspec
from webgpufft_tpu_torch.core import axis as taxis, cplx as tcplx, dft as tdft, engine as tengine
from webgpufft_tpu_torch.utils import factors as tfactors, mathref as tmathref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPEC_OPTS = [
    {"type": "c2c", "shape": [1024], "batch": 4096, "normalize": "unitary"},
    {"type": "c2c", "shape": [256, 256, 256], "direction": "inverse",
     "normalize": "backward", "tuning": {"impl": "pallas-auto", "maxSubLength": 16}},
    {"type": "c2c", "shape": [64], "tuning": {"chunkElements": 4096,
                                              "workgroupSizeX": 64}},
    {"type": "c2c", "shape": [8, 8], "precision": "f16-storage", "inPlace": True},
    {"type": "r2c", "shape": [32, 8], "batch": 2,
     "layout": {"inputStrides": [8, 1], "outputStrides": [8, 1]}},
    {"type": "fftconv", "shape": [16], "fftConv": {"boundary": "linear-full",
                                                    "kernelShape": [5]}},
    {"type": "dct2", "shape": [8, 8], "ioView": {"input": {"shape": [4, 4],
                                                           "placement": "center"}}},
]
BAD_OPTS = [
    {"type": "c2c", "shape": [64], "tuning": {"chunkElements": 1 << 23}},
    {"type": "c2c", "shape": [64], "tuning": {"chunkElements": 1024}},
    {"type": "c2c", "shape": [64], "tuning": {"impl": "cuda"}},
    {"type": "c2c", "shape": [0]},
    {"type": "c2r", "shape": [8], "direction": "forward"},
    {"type": "c2c", "shape": [8], "tuning": {"noSuchKnob": 1}},
]


@pytest.mark.parametrize("opts", SPEC_OPTS)
def test_normalize_spec_matches_jax(opts):
    assert (dataclasses.asdict(tspec.normalize_spec(opts))
            == dataclasses.asdict(jspec.normalize_spec(opts)))


@pytest.mark.parametrize("opts", BAD_OPTS)
def test_normalize_spec_rejects_what_jax_rejects(opts):
    with pytest.raises(jspec.PlanError) as want:
        jspec.normalize_spec(opts)
    with pytest.raises(tspec.PlanError) as got:
        tspec.normalize_spec(opts)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 18, 20, 32, 55, 64, 360, 1000])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_dft_tables_are_bitwise(n, direction):
    assert np.array_equal(tdft.dft_matrix(n, direction), jdft.dft_matrix(n, direction))
    assert np.array_equal(tdft.ct_twiddle(n, 12, direction),
                          jdft.ct_twiddle(n, 12, direction))


def test_factors_match_jax():
    for n in range(1, 5000):
        assert tfactors.split_two_balanced(n, 128) == jfactors.split_two_balanced(n, 128)
        assert tfactors.is_smooth(n) == jfactors.is_smooth(n)
    for n in (2, 360, 1024, 2310, 4096, 65536, 5 ** 6):
        assert tfactors.split_sublengths(n, 32) == jfactors.split_sublengths(n, 32)


def test_mathref_matches_jax(rng):
    z = rng.standard_normal((2, 6, 10)) + 1j * rng.standard_normal((2, 6, 10))
    for d in ("forward", "inverse"):
        for norm in ("none", "backward", "unitary"):
            assert tmathref.normalize_scale(norm, d, 60) == jmathref.normalize_scale(norm, d, 60)
            assert np.array_equal(tmathref.fft_nd(z, [6, 10], d, norm),
                                  jmathref.fft_nd(z, [6, 10], d, norm))


def test_cplx_helpers_match_jax(rng, assert_close):
    z = rng.standard_normal((5, 3)) + 1j * rng.standard_normal((5, 3))
    assert np.array_equal(tcplx.to_w4(z), jcplx.to_w4(z))
    ca, cb = tcplx.const_pair(z)
    ja, jb = jcplx.const_pair(z)
    assert np.array_equal(ca, ja) and np.array_equal(cb, jb)
    assert np.array_equal(tcplx.interleave(z), jcplx.interleave(z))
    assert np.array_equal(tcplx.uninterleave(tcplx.interleave(z)),
                          jcplx.uninterleave(jcplx.interleave(z)))
    d = rng.standard_normal((4, 5, 3, 2)).astype(np.float32)
    got = tcplx.cmul_const(torch.from_numpy(d), torch.from_numpy(ca), torch.from_numpy(cb))
    assert_close(got.numpy(), np.asarray(jcplx.cmul_const(jnp.asarray(d), ja, jb)))


# (n, max_sub): two-level folded (square and non-square) and three-level splits
AXIS_CASES = [(1024, 32), (2048, 32), (360, 32), (2310, 32), (512, 8), (7, 32), (1, 32)]


@pytest.mark.parametrize("n,max_sub", AXIS_CASES)
@pytest.mark.parametrize("out_scale", [1.0, 0.125])
def test_mixed_axis_plan_matches_jax(n, max_sub, out_scale, rng, assert_close):
    tp = taxis.MixedAxisPlan(n, "inverse", "ax", max_sub, out_scale=out_scale)
    jp = jaxis.MixedAxisPlan(n, "inverse", "ax", max_sub, out_scale=out_scale)
    assert tp.subs == jp.subs
    tc, jc = tp.consts(), jp.consts()
    assert set(tc) == set(jc)
    for k in jc:
        assert np.array_equal(tc[k], jc[k]), k
    tt = {k: torch.from_numpy(v) for k, v in tc.items()}
    x = rng.standard_normal((3, n, 2)).astype(np.float32)
    assert_close(tp.apply(torch.from_numpy(x), tt).numpy(),
                 np.asarray(jp.apply(jnp.asarray(x), jc)), label=f"apply n={n}")
    xm = rng.standard_normal((2, n, 5, 2)).astype(np.float32)
    assert_close(tp.apply_mid(torch.from_numpy(xm), tt).numpy(),
                 np.asarray(jp.apply_mid(jnp.asarray(xm), jc)), label=f"apply_mid n={n}")


def test_apply_nd_matches_jax(rng, assert_close):
    shape = (12, 18, 20)
    tun = jspec.TuningSpec()
    jplans = jengine.build_axis_plans(shape, "forward", tun)
    tplans = tengine.build_axis_plans(shape, "forward", tspec.TuningSpec())
    consts = jengine.collect_consts(jplans)
    x = rng.standard_normal((2, *shape, 2)).astype(np.float32)
    got = tengine.apply_nd(torch.from_numpy(x), tplans,
                           {k: torch.from_numpy(v) for k, v in consts.items()})
    assert_close(got.numpy(), np.asarray(jengine.apply_nd(jnp.asarray(x), jplans, consts)))
    assert tengine.plan_scale("unitary", "inverse", 64) == jengine.plan_scale("unitary", "inverse", 64)


@pytest.mark.parametrize("opts", [
    {"type": "c2c", "shape": [256, 256], "batch": 2, "tuning": {"impl": "pallas-auto"}},
    {"type": "c2c", "shape": [16, 256, 256], "normalize": "unitary",
     "tuning": {"impl": "pallas-auto"}},
    {"type": "c2c", "shape": [2310], "batch": 8, "direction": "inverse",
     "normalize": "backward", "tuning": {"impl": "pallas-auto"}},
    {"type": "c2c", "shape": [1024, 12], "direction": "inverse", "normalize": "unitary",
     "tuning": {"impl": "xla"}},
])
def test_tables_from_reference_equal_the_ports_own(opts):
    jplan = W.create_plan(opts, cache=W.PlanCache())
    got = T.tables_from_reference(jplan._consts_np, "cpu")  # before any JAX exec
    own = T.create_plan(opts, device="cpu", cache=T.PlanCache()).consts
    assert set(got) == set(own)
    for k in own:
        assert got[k].dtype == own[k].dtype and torch.equal(got[k], own[k]), k


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import webgpufft_tpu_torch\n"
            "from webgpufft_tpu_torch import _build\n"
            "from webgpufft_tpu_torch.core import axis, engine, fused, fused_cols\n"
            "from webgpufft_tpu_torch.plans import base, stages, transforms\n"
            "from webgpufft_tpu_torch.runtime import cache, policy\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None and"
            " (m in ('jax', 'webgpufft_tpu') or m.startswith(('jax.', 'webgpufft_tpu.')))]\n"
            "assert not bad, bad\n"
            "p = webgpufft_tpu_torch.create_plan({'type': 'c2c', 'shape': [64],"
            " 'batch': 8}, device='cpu')\n"
            "import torch; assert p(torch.zeros(8, 64, 2)).shape == (8, 64, 2)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cuda_plan_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        T.create_plan({"type": "c2c", "shape": [1024], "batch": 8}, cache=T.PlanCache())


@pytest.mark.parametrize("opts,item", [
    ({"type": "r2c", "shape": [16]}, "P4"),
    ({"type": "c2r", "shape": [16], "direction": "inverse"}, "P4"),
    ({"type": "dct2", "shape": [16]}, "P5"),
    ({"type": "fftconv", "shape": [16]}, "P6"),
    ({"type": "conv2d", "shape": [8, 8], "conv": {"kernelSize": 3}}, "P6"),
    ({"type": "c2c", "shape": [17]}, "P3"),                       # Rader
    ({"type": "c2c", "shape": [4099]}, "P3"),                     # Bluestein (prime > raderMaxPrime)
    ({"type": "c2c", "shape": [34]}, "P3"),                       # Bluestein (2 * 17)
    ({"type": "c2c", "shape": [1 << 16]}, "P3"),                  # four-step
    ({"type": "c2c", "shape": [64], "tuning": {"forceBluesteinAxes": [0]}}, "P3"),
    ({"type": "c2c", "shape": [8], "layout": {"inputStrides": [1]}}, "P7"),
    ({"type": "c2c", "shape": [8], "zeroPad": {"read": {"start": [2]}}}, "P7"),
    ({"type": "c2c", "shape": [8], "ioView": {"input": {"shape": [4]}}}, "P7"),
    ({"type": "c2c", "shape": [8], "precision": "bf16-storage"}, "P7"),
    ({"type": "c2c", "shape": [8], "inPlace": True}, "P7"),
    ({"type": "c2c", "shape": [8], "tuning": {"rigor": "measure"}}, "P8"),
    ({"type": "c2c", "shape": [8], "cache": {"snapshot": {"specs": []}}}, "P8"),
])
def test_options_outside_the_slice_raise(opts, item):
    with pytest.raises(T.PlanError, match=f"ROADMAP {item}"):
        T.create_plan(opts, device="cpu", cache=T.PlanCache())


def test_exec_misuse_raises():
    plan = T.create_plan({"type": "c2c", "shape": [64], "batch": 8}, device="cpu",
                         cache=T.PlanCache())
    x = torch.zeros(8, 64, 2)
    for bad, match in [(torch.zeros(8, 32, 2), "expected input shape"),
                       (torch.zeros(8, 64, 2, dtype=torch.float64), "dtype"),
                       (np.zeros((8, 64, 2), np.float32), "torch.Tensor"),
                       (torch.zeros(8, 64, 2, requires_grad=True), "ROADMAP P9")]:
        with pytest.raises(T.PlanError, match=match):
            plan(bad)
    with pytest.raises(T.PlanError, match="ROADMAP P7"):
        plan(x, out=torch.zeros(8, 64, 2))
    with pytest.raises(T.PlanError, match="ROADMAP P7"):
        plan.exec(x, input_offset_elements=4)
    with pytest.raises(T.PlanError, match="kernel="):
        plan(x, kernel=x)


def test_route_records_auto_and_ignored_tpu_knobs():
    plan = T.create_plan({"type": "c2c", "shape": [1024], "batch": 8, "tuning": {
        "chunkElements": 4096, "vmemLimitBytes": 1 << 20, "batchTile": 4,
        "fused_variant": "v2", "fused_precision": "default",
        "matmulPrecision": "high", "workgroupSizeX": 64}}, device="cpu",
        cache=T.PlanCache())
    assert plan.route.mode == "pallas-fused"
    for r in ("impl-auto-hopper-kernels", "ignored-webgpu-knob:workgroupSizeX",
              "ignored-tpu-knob:chunkElements", "ignored-tpu-knob:vmemLimitBytes",
              "ignored-tpu-knob:batchTile", "ignored-tpu-knob:fusedVariant",
              "ignored-tpu-knob:fusedPrecision", "ignored-tpu-knob:matmulPrecision"):
        assert r in plan.route.reasons, (r, plan.route.reasons)


def test_plan_cache_keys_on_spec_and_device():
    cache = T.PlanCache()
    opts = {"type": "c2c", "shape": [64], "batch": 8}
    p = T.create_plan(opts, device="cpu", cache=cache)
    assert T.create_plan(dict(opts), device="cpu", cache=cache) is p
    assert cache.get(tspec.normalize_spec(opts), torch.device("cpu")) is p
    assert T.create_fft_plan(opts, device="cpu") is not p  # the default cache
    assert len(cache) == 1
    cache.clear()
    assert len(cache) == 0 and T.create_plan(opts, device="cpu", cache=cache) is not p
