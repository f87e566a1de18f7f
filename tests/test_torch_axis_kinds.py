"""Rader, Bluestein and four-step axes: the JAX package against the PyTorch
port (``device="cpu"``).

Each axis plan on its own (tables bitwise, ``apply`` and ``apply_mid``), then
whole c2c plans through ``create_plan``: same options, same input from a
numpy seed, output within 1e-5 * max|expected| of the JAX plan's, and the
same route metadata, except where the JAX package's rank > 1 digit rule (no
kernel on an axis whose split has a digit below 16), which the port does not
have, decided the route: there the port's route is written out.  The JAX
side runs as its own tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu import spec as jspec
from webgpufft_tpu.core import axis as jaxis
from webgpufft_tpu_torch import spec as tspec
from webgpufft_tpu_torch.core import axis as taxis
from webgpufft_tpu_torch.core.cplx import interleave


def _tuning(**kw):
    return jspec.TuningSpec(**kw), tspec.TuningSpec(**kw)


def _pair(kind, n, direction, **tun):
    jt, tt = _tuning(**tun)
    cls = {"rader": "RaderAxisPlan", "bluestein": "BluesteinAxisPlan"}.get(kind)
    if cls is None:
        return (jaxis.make_smooth_plan(n, direction, "ax", tuning=jt),
                taxis.make_smooth_plan(n, direction, "ax", tuning=tt))
    return (getattr(jaxis, cls)(n, direction, "ax", tuning=jt),
            getattr(taxis, cls)(n, direction, "ax", tuning=tt))


# (kind, n, tuning): the inner plans of Rader/Bluestein are mixed-radix
# unless fourStepMinN pulls them onto four-step
PLAN_CASES = [
    ("rader", 7, {}), ("rader", 13, {}), ("rader", 101, {}),
    ("rader", 101, {"four_step_min_n": 64}),         # m = 100 = 10 x 10 four-step
    ("rader", 23, {}),                                # m = 22 not smooth: wrapped kernel
    ("bluestein", 17, {}), ("bluestein", 323, {}),    # 17 * 19
    ("bluestein", 323, {"four_step_min_n": 512}),
    ("four-step", 4096, {"four_step_min_n": 4096}),   # 64 x 64
    ("four-step", 8192, {"four_step_min_n": 4096}),   # 64 x 128: not square
    ("four-step", 2048, {"four_step_min_n": 1024, "max_sub_length": 8}),
]


@pytest.mark.parametrize("kind,n,tun", PLAN_CASES)
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_axis_plan_matches_jax(kind, n, tun, direction, rng, assert_close):
    jp, tp = _pair(kind, n, direction, **tun)
    assert tp.kind == jp.kind == kind
    assert (tp.supports_mid, tp.prefer_mid) == (jp.supports_mid, jp.prefer_mid)
    jc, tc = jp.consts(), tp.consts()
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].dtype == jc[k].dtype and np.array_equal(tc[k], jc[k]), k
    tt = {k: torch.from_numpy(v) for k, v in tc.items()}
    x = rng.standard_normal((3, n, 2)).astype(np.float32)
    assert_close(tp.apply(torch.from_numpy(x), tt).numpy(),
                 np.asarray(jp.apply(jnp.asarray(x), jc)), label=f"{kind} {n} apply")
    xm = rng.standard_normal((2, n, 3, 2)).astype(np.float32)
    assert_close(tp.apply_mid(torch.from_numpy(xm), tt).numpy(),
                 np.asarray(jp.apply_mid(jnp.asarray(xm), jc)),
                 label=f"{kind} {n} apply_mid")
    # a non-last axis through apply_along_axis: the mid form or the
    # movedim fallback, whichever the plan prefers
    x3 = rng.standard_normal((2, n, 5, 2)).astype(np.float32)
    assert_close(taxis.apply_along_axis(torch.from_numpy(x3), tp, 1, tt).numpy(),
                 np.asarray(jaxis.apply_along_axis(jnp.asarray(x3), jp, 1, jc)),
                 label=f"{kind} {n} along axis 1")


def test_bluestein_pads_the_axis_not_the_component_dim(rng, assert_close):
    """Zero padding must land on the transform axis: a pad of the (re, im)
    dim gives finite but wrong output."""
    tp = taxis.BluesteinAxisPlan(5, "forward", "ax", tuning=tspec.TuningSpec())
    tt = {k: torch.from_numpy(v) for k, v in tp.consts().items()}
    z = rng.standard_normal((4, 5)) + 1j * rng.standard_normal((4, 5))
    want = np.fft.fft(z, axis=-1)
    got = tp.apply(torch.from_numpy(interleave(z)), tt).numpy()
    assert_close(got[..., 0] + 1j * got[..., 1], want, label="rows")
    zm = rng.standard_normal((2, 5, 3)) + 1j * rng.standard_normal((2, 5, 3))
    got = tp.apply_mid(torch.from_numpy(interleave(zm)), tt).numpy()
    assert_close(got[..., 0] + 1j * got[..., 1], np.fft.fft(zm, axis=1), label="mid")


def test_four_step_eligibility_matches_jax():
    for tun in ({}, {"four_step_min_n": 4096}, {"large_route": "out-of-core"},
                {"large_route": "chunk", "four_step_min_n": 16},
                {"disable_four_step": True, "four_step_min_n": 16}):
        jt, tt = _tuning(**tun)
        for n in (16, 97, 1000, 4096, 8192, 1 << 16, 1 << 20, 3 ** 10):
            assert taxis.four_step_eligible(n, tt) == jaxis.four_step_eligible(n, jt), (n, tun)


def _axis_reasons(route):
    return [r for r in route.reasons if r.startswith("c2c-axis") or "four-step" in r]


_LAST = ("pallas-mixed", ["c2c-axis0-xla", "c2c-axis1-fused-lines"])
# (shape, batch, tuning, the port's (mode, axis reasons) where the digit rule
# decided the JAX route, else None): Rader on the last and on a non-last
# axis, Bluestein forced and on a non-smooth composite, four-step on the
# last axis and on axis 0 of (4096, 4).  A short smooth axis beside them now
# takes K1 (8 lines suffice) or K2 (202 lanes under the 6 of (6, 101)).
C2C_CASES = [
    ([7], 3, {"forceRaderAxes": [0]}, None),
    ([13], 3, {"forceRaderAxes": [0]}, None),
    ([101], 3, {}, None),
    ([7, 6], 2, {"forceRaderAxes": [0]}, _LAST),
    ([13, 4], 2, {"forceRaderAxes": [0]}, _LAST),
    ([101, 6], 2, {}, _LAST),
    ([6, 101], 2, {}, ("pallas-mixed", ["c2c-axis0-fused-cols", "c2c-axis1-xla"])),
    ([101, 6], 1, {"fourStepMinN": 64}, _LAST),
    ([64], 2, {"forceBluesteinAxes": [0]}, None),
    ([12, 16], 2, {"forceBluesteinAxes": [1]}, _LAST),
    ([323], 2, {}, None),
    ([323, 4], 1, {}, _LAST),
    ([4096], 2, {"fourStepMinN": 4096}, None),
    ([8192], 1, {"fourStepMinN": 4096}, None),
    ([8192], 1, {"largeRoute": "out-of-core"}, None),
    ([4096, 4], 1, {"fourStepMinN": 4096},
     ("pallas-mixed", ["c2c-axis0-xla-four-step", "c2c-axis1-fused-lines"])),
]


@pytest.mark.parametrize("shape,batch,tun,port_route", C2C_CASES)
@pytest.mark.parametrize("direction,normalize", [("forward", "unitary"),
                                                 ("inverse", "backward")])
def test_c2c_plan_matches_jax(shape, batch, tun, port_route, direction, normalize, rng,
                              assert_close):
    opts = {"type": "c2c", "shape": shape, "batch": batch, "direction": direction,
            "normalize": normalize, "tuning": {"impl": "pallas-auto", **tun}}
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    x = interleave(z)
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert_close(tplan(torch.from_numpy(x)).numpy(), np.asarray(jplan(x)),
                 label=f"{shape} {tun}")
    assert tplan.route.axis_kinds == jplan.route.axis_kinds
    if port_route is None:
        port_route = (jplan.route.mode, _axis_reasons(jplan.route))
    else:
        assert port_route != (jplan.route.mode, _axis_reasons(jplan.route))
    assert (tplan.route.mode, _axis_reasons(tplan.route)) == port_route


@pytest.mark.parametrize("shape,batch,tun", [C2C_CASES[i][:3] for i in (3, 7, 10, 15)])
def test_c2c_plan_runs_on_the_jax_tables(shape, batch, tun):
    """Rader (int32 index tables), Bluestein and four-step tables of the JAX
    plan load into the port's plan and give its output bit for bit (every
    axis on the einsum route in both packages)."""
    opts = {"type": "c2c", "shape": shape, "batch": batch, "tuning": {"impl": "xla", **tun}}
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tables = T.tables_from_reference(jplan._consts_np, "cpu")
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert {k: v.dtype for k, v in tables.items()} == \
        {k: v.dtype for k, v in tplan.consts.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (batch, *shape, 2)).astype(np.float32))
    own = tplan(x)
    assert torch.equal(tplan.load_consts(tables)(x), own)
