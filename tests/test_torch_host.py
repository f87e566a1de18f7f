"""Host side of the PyTorch port against the JAX package: options
validation, table builders, the numpy oracles, the einsum axis engine, route
metadata and the errors for what the port does not carry yet, plus import
hygiene (the port never imports JAX).  Tolerance for computed outputs: 1e-5 * max|expected|.
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


@pytest.mark.parametrize("n", [1, 2, 5, 17, 101, 323, 4099])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_bluestein_tables_are_bitwise(n, direction):
    assert np.array_equal(tdft.bluestein_chirp(n, direction),
                          jdft.bluestein_chirp(n, direction))
    m = tfactors.next_smooth_at_least(max(2 * n - 1, 1))
    assert np.array_equal(tdft.bluestein_kernel_fft(n, m, direction),
                          jdft.bluestein_kernel_fft(n, m, direction))


@pytest.mark.parametrize("p", [3, 5, 7, 13, 23, 101, 4093])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_rader_tables_are_bitwise(p, direction):
    got, want = tdft.rader_tables(p, direction), jdft.rader_tables(p, direction)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("n0", [4, 8, 16, 256, 1024])
def test_real_transform_tables_are_bitwise(n0):
    from webgpufft_tpu.plans import transforms as jtr
    from webgpufft_tpu_torch.plans import transforms as ttr
    assert ttr.packed_shape((n0, 5, 3)) == jtr.packed_shape((n0, 5, 3))
    for inverse in (False, True):
        got = ttr._half_trick_consts(n0, inverse)
        want = jtr._half_trick_consts(n0, inverse)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    q = np.exp(0.3j * np.arange(n0)) * (1 + np.arange(n0))
    for name in ("_conj_pair", "_re_pair"):
        for g, w in zip(getattr(ttr, name)(q), getattr(jtr, name)(q)):
            assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_real_oracles_match_jax(rng):
    for shape in [(8,), (9, 4), (6, 5, 3)]:
        x = rng.standard_normal((2, *shape))
        for norm in ("none", "backward", "unitary"):
            packed = jmathref.r2c_packed(x, shape, norm)
            assert np.array_equal(tmathref.r2c_packed(x, shape, norm), packed)
            assert np.array_equal(tmathref.c2r_packed(packed, shape, norm),
                                  jmathref.c2r_packed(packed, shape, norm))


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
    own = tengine.collect_consts(tplans)
    assert set(own) == set(consts) and all(np.array_equal(own[k], consts[k]) for k in consts)
    x = rng.standard_normal((2, *shape, 2)).astype(np.float32)
    got = tengine.apply_nd(torch.from_numpy(x), tplans,
                           {k: torch.from_numpy(v) for k, v in consts.items()})
    assert_close(got.numpy(), np.asarray(jengine.apply_nd(jnp.asarray(x), jplans, consts)))
    assert tengine.plan_scale("unitary", "inverse", 64) == jengine.plan_scale("unitary", "inverse", 64)


@pytest.mark.parametrize("opts,port_only,jax_only", [
    ({"type": "c2c", "shape": [256, 256], "batch": 2, "tuning": {"impl": "pallas-auto"}},
     "", ""),
    # axis 0 = 16 = 4 * 4: the JAX package keeps a rank > 1 axis with a digit
    # below 16 on its einsum route (ax0/*), the port runs it on K2 (fc0/*)
    ({"type": "c2c", "shape": [16, 256, 256], "normalize": "unitary",
      "tuning": {"impl": "pallas-auto"}}, "fc0/", "ax0/"),
    ({"type": "c2c", "shape": [2310], "batch": 8, "direction": "inverse",
      "normalize": "backward", "tuning": {"impl": "pallas-auto"}}, "", ""),
    ({"type": "c2c", "shape": [1024, 12], "direction": "inverse", "normalize": "unitary",
      "tuning": {"impl": "xla"}}, "", ""),
])
def test_tables_from_reference_equal_the_ports_own(opts, port_only, jax_only):
    jplan = W.create_plan(opts, cache=W.PlanCache())
    got = T.tables_from_reference(jplan._consts_np, "cpu")  # before any JAX exec
    own = T.create_plan(opts, device="cpu", cache=T.PlanCache()).consts
    assert bool(set(own) - set(got)) == bool(port_only)
    assert all(k.startswith(port_only) for k in set(own) - set(got))
    assert all(k.startswith(jax_only) for k in set(got) - set(own))
    for k in set(own) & set(got):
        assert got[k].dtype == own[k].dtype and torch.equal(got[k], own[k]), k


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import webgpufft_tpu_torch\n"
            "from webgpufft_tpu_torch import _build\n"
            "from webgpufft_tpu_torch.core import axis, engine, fused, fused_cols\n"
            "from webgpufft_tpu_torch.plans import base, conv2d, fftconv, stages, transforms\n"
            "from webgpufft_tpu_torch.runtime import cache, policy\n"
            "from webgpufft_tpu_torch.utils import bufferview, factors, mathref\n"
            "from webgpufft_tpu_torch.examples import control_toolkit, navier_stokes3d\n"
            "from webgpufft_tpu_torch.examples import multichip_fft, navier_stokes2d, poisson3d\n"
            "from webgpufft_tpu_torch.parallel import collectives, nufft, plans, sharded\n"
            "from webgpufft_tpu_torch import filtering, ltisys, ndimage, splines\n"
            "from webgpufft_tpu_torch.probes import planes, stages, stream\n"
            "from webgpufft_tpu_torch import (fft, fftapi, fftpack, fftpack_convolve,"
            " pyfftw, scipy_backend, shorttime, torch_fft, windows)\n"
            "import webgpufft_tpu_torch.fftpack.convolve\n"
            "from webgpufft_tpu_torch.core import cplx\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None and"
            " (m in ('jax', 'webgpufft_tpu') or m.startswith(('jax.', 'webgpufft_tpu.')))]\n"
            "assert not bad, bad\n"
            "p = webgpufft_tpu_torch.create_plan({'type': 'c2c', 'shape': [64],"
            " 'batch': 8}, device='cpu')\n"
            "import torch; assert p(torch.zeros(8, 64, 2)).shape == (8, 64, 2)\n"
            "assert fft.rfft(torch.zeros(8, 64)).shape == (8, 33, 2)\n"
            "for t in ('dct2', 'fftconv'):\n"
            "    webgpufft_tpu_torch.create_plan({'type': t, 'shape': [64]}, device='cpu')\n"
            "webgpufft_tpu_torch.create_plan({'type': 'conv2d', 'shape': [8, 8],"
            " 'conv': {'kernelSize': 3}}, device='cpu')\n"
            "bad = [m for m in sys.modules if m in ('jax', 'webgpufft_tpu')"
            " and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cuda_plan_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        T.create_plan({"type": "c2c", "shape": [1024], "batch": 8}, cache=T.PlanCache())


@pytest.mark.parametrize("opts,item", [
    ({"type": "r2c", "shape": [16], "layout": {"inputStrides": [1]}}, None),
    ({"type": "c2r", "shape": [16], "direction": "inverse",
      "precision": "bf16-storage"}, None),
    ({"type": "dct2", "shape": [16]}, None),
    ({"type": "fftconv", "shape": [16]}, None),
    ({"type": "conv2d", "shape": [8, 8], "conv": {"kernelSize": 3}}, None),
    ({"type": "dst4", "shape": [17]}, None),
    ({"type": "dct1", "shape": [8, 8]}, None),
    ({"type": "r2c", "shape": [8, 8], "zeroPad": {"read": {"start": [2, 0]}}}, None),
    ({"type": "c2r", "shape": [34], "direction": "inverse",
      "ioView": {"output": {"shape": [16]}}}, None),
    ({"type": "r2c", "shape": [64], "tuning": {"rigor": "measure"}}, None),
    ({"type": "c2c", "shape": [8], "layout": {"inputStrides": [1]}}, None),
    ({"type": "c2c", "shape": [8], "zeroPad": {"read": {"start": [2]}}}, None),
    ({"type": "c2c", "shape": [8], "ioView": {"input": {"shape": [4]}}}, None),
    ({"type": "c2c", "shape": [8], "precision": "bf16-storage"}, None),
    ({"type": "c2c", "shape": [8], "inPlace": True}, None),
    ({"type": "c2c", "shape": [8], "tuning": {"rigor": "measure"}}, None),
    ({"type": "c2c", "shape": [8], "cache": {"snapshot": {
        "schema": "webgpufft-tpu.plan-cache", "version": 3, "specs": []}}}, None),
])
def test_options_outside_the_slice_raise(opts, item):
    """Every plan type and staging option of ``spec.py`` builds; what is
    still outside the port raises naming its ROADMAP item."""
    if item is None:
        plan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
        assert plan.spec.plan_type == opts["type"]
        return
    with pytest.raises(T.PlanError, match=f"ROADMAP {item}"):
        T.create_plan(opts, device="cpu", cache=T.PlanCache())


def test_exec_misuse_raises():
    plan = T.create_plan({"type": "c2c", "shape": [64], "batch": 8}, device="cpu",
                         cache=T.PlanCache())
    x = torch.zeros(8, 64, 2)
    for bad, match in [(torch.zeros(8, 32, 2), "expected input shape"),
                       (torch.zeros(8, 64, 2, dtype=torch.float64), "dtype"),
                       (np.zeros((8, 64, 2), np.float32), "torch.Tensor")]:
        with pytest.raises(T.PlanError, match=match):
            plan(bad)
    # a tensor that requires grad is differentiated, not refused
    xg = torch.ones(8, 64, 2, requires_grad=True)
    g, = torch.autograd.grad(plan(xg).pow(2).sum(), xg)
    assert torch.allclose(g, 2 * 64 * xg.detach(), atol=1e-4)
    with pytest.raises(T.PlanError, match="out= requires an output side that can merge"):
        plan(x, out=torch.zeros(8, 64, 2))
    with pytest.raises(T.PlanError, match="expects a flat buffer"):
        plan.exec(x, input_offset_elements=4)
    with pytest.raises(T.PlanError, match="kernel="):
        plan(x, kernel=x)


@pytest.mark.parametrize("kind", ["dct1", "dct2", "dct3", "dct4",
                                  "dst1", "dst2", "dst3", "dst4"])
def test_trig_oracles_match_jax(kind, rng):
    for n in (2, 7, 16):
        for d in ("forward", "inverse"):
            assert np.array_equal(tmathref.trig_matrix(kind, n, d),
                                  jmathref.trig_matrix(kind, n, d))
    x = rng.standard_normal((2, 5, 6))
    for norm in ("none", "backward", "unitary"):
        assert np.array_equal(tmathref.dct_nd(x, (5, 6), kind, "inverse", norm),
                              jmathref.dct_nd(x, (5, 6), kind, "inverse", norm))


@pytest.mark.parametrize("boundary", ["circular", "linear-full", "linear-same",
                                      "linear-valid"])
def test_conv_oracles_match_jax(boundary, rng):
    x = rng.standard_normal((2, 9, 6)) + 1j * rng.standard_normal((2, 9, 6))
    k = rng.standard_normal((3, 2)) + 1j * rng.standard_normal((3, 2))
    assert tmathref.fftconv_out_shape([9, 6], [3, 2], boundary) == \
        jmathref.fftconv_out_shape([9, 6], [3, 2], boundary)
    for mode in ("convolution", "correlation"):
        kw = dict(batch=2, mode=mode, boundary=boundary, kernel_shape=[3, 2])
        assert np.array_equal(tmathref.fftconv(x, k, [9, 6], **kw),
                              jmathref.fftconv(x, k, [9, 6], **kw))
    w = rng.standard_normal((3, 3))
    assert np.array_equal(tmathref.conv2d_direct(x.real, w, pad=(1, 0, 2, 1)),
                          jmathref.conv2d_direct(x.real, w, pad=(1, 0, 2, 1)))


@pytest.mark.parametrize("name", ["create_fftconv_channel_lane_preset",
                                  "create_fftconv_kernel_major_channel_lane_preset",
                                  "create_fftconv_batch_major_channel_lane_preset"])
def test_channel_lane_presets_match_jax(name):
    opts = {"shape": [256], "batch": 4, "kernelCount": 2, "kernelShape": [9],
            "mode": "correlation", "boundary": "linear-same",
            "layout": {"interleavedComplex": True},
            "input": {"channels": 64, "channelIndex": 3, "offsetElements": 5},
            "output": {"channels": 128, "kernelStepChannels": 64,
                       "channelStrideElements": 300, "batchStrideElements": 40000}}
    assert getattr(T, name)(opts) == getattr(W, name)(opts)
    for bad in ({**opts, "layout": {"strides": [1]}}, {**opts, "input": {}}):
        with pytest.raises(W.PlanError) as want:
            getattr(W, name)(bad)
        with pytest.raises(T.PlanError) as got:
            getattr(T, name)(bad)
        assert str(got.value) == str(want.value)


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
