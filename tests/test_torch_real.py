"""r2c and c2r: the JAX package against the PyTorch port (``device="cpu"``).

Same options, same input from a numpy seed, output within
1e-5 * max|expected| of the JAX plan's (and of the numpy packed oracle),
on ``tests/test_real.py``'s shape lists in every normalize mode.  Under
``impl: "xla"`` the route metadata equals the JAX package's; under the
default the port adds per-axis reasons.  On the CPU the port's kernel
wrappers run their plain torch versions.
"""

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu.utils import mathref as R
from webgpufft_tpu_torch.core.cplx import interleave, uninterleave
from webgpufft_tpu_torch.utils import mathref as TR

R2C_SHAPES = [(8,), (9,), (1024,), (17,), (8, 8), (9, 4), (12, 5, 3), (4, 3, 2, 5)]
C2R_SHAPES = [(8,), (9,), (8, 8), (9, 4), (12, 5, 3), (4, 3, 2, 5)]
NORMALIZE = ["none", "backward", "unitary"]


def _plans(kind, shape, batch, normalize, impl="auto", **tuning):
    opts = {"type": kind, "shape": list(shape), "batch": batch, "normalize": normalize,
            "direction": "forward" if kind == "r2c" else "inverse",
            "tuning": {"impl": impl, **tuning}}
    return (W.create_plan(opts, cache=W.PlanCache()),
            T.create_plan(opts, device="cpu", cache=T.PlanCache()))


def _check_route(kind, impl, jplan, tplan, rank):
    if impl == "xla":
        assert (tplan.route.mode, tplan.route.impl, tplan.route.reasons) == \
            (jplan.route.mode, jplan.route.impl, jplan.route.reasons)
    else:
        for d in range(rank):
            assert any(r.startswith(f"{kind}-axis{d}-") for r in tplan.route.reasons), \
                tplan.route.reasons
    assert tplan.route.axis_kinds == jplan.route.axis_kinds


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("shape", R2C_SHAPES)
def test_r2c_matches_jax(shape, normalize, impl, rng, assert_close):
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    jplan, tplan = _plans("r2c", shape, 2, normalize, impl)
    got = tplan(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tplan.output_shape == (2, shape[0] // 2 + 1, *shape[1:], 2)
    assert_close(got.numpy(), np.asarray(jplan(x)), label=f"r2c{shape}")
    ref = TR.r2c_packed(x.astype(np.float64), shape, normalize)
    assert_close(uninterleave(got.numpy()), ref, label=f"r2c{shape} vs numpy")
    _check_route("r2c", impl, jplan, tplan, len(shape))


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("shape", C2R_SHAPES)
def test_c2r_matches_jax(shape, normalize, impl, rng, assert_close):
    x = rng.standard_normal((2, *shape))
    packed = interleave(R.r2c_packed(x, shape))
    jplan, tplan = _plans("c2r", shape, 2, normalize, impl)
    got = tplan(torch.from_numpy(packed))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, *shape)
    assert_close(got.numpy(), np.asarray(jplan(packed)), label=f"c2r{shape}")
    if normalize == "backward":
        assert_close(got.numpy(), x, label=f"c2r{shape} round trip")
    _check_route("c2r", impl, jplan, tplan, len(shape))


# the kernel route on the real glue: body and Nyquist slabs of the rest
# axes through K2 (axis 1) and K1 (axis 2), and the half-length axis 0
# through K2 whatever its digits (16 = 4 * 4, 3, the widened 9 = 3 * 3): the
# JAX package keeps such an axis of a rank > 1 plan on its einsum route, the
# port has no digit rule
@pytest.mark.parametrize("kind", ["r2c", "c2r"])
@pytest.mark.parametrize("shape,mode,want", [
    ((32, 256, 256), "pallas-fused",
     ("axis0-fused-cols", "axis1-fused-cols", "axis2-fused-lines")),
    ((6, 256), "pallas-fused", ("axis0-fused-cols", "axis1-fused-lines")),
    ((2048,), "pallas-fused", ("axis0-fused-lines",)),
    ((9, 256), "pallas-fused", ("axis0-fused-cols", "axis1-fused-lines")),   # odd n0: widened
    ((34, 256), "pallas-mixed", ("axis0-xla", "axis1-fused-lines")),         # half 17: no split
])
def test_real_plans_on_the_kernels(kind, shape, mode, want, rng, assert_close):
    batch = 2 if len(shape) == 3 else 8
    x = rng.standard_normal((batch, *shape))
    jplan, tplan = _plans(kind, shape, batch, "backward")
    assert tplan.route.mode == mode, tplan.route.reasons
    assert [r for r in tplan.route.reasons if "-axis" in r] == [f"{kind}-{w}" for w in want]
    if kind == "r2c":
        inp = x.astype(np.float32)
    else:
        inp = interleave(R.r2c_packed(x, shape))
    got = tplan(torch.from_numpy(inp)).numpy()
    assert_close(got, np.asarray(jplan(inp)), label=f"{kind}{shape}")


def test_nyquist_slab_routes_on_its_own_size():
    """K1 needs 8 lines.  At batch 1, r2c [4, 16, 256] gives the body 32
    lines and the Nyquist slab 16: both take K1.  r2c [16, 2, 256] gives
    the body 16 and the slab 2, which stays on the einsum route."""
    _, p = _plans("r2c", (4, 16, 256), 1, "none")
    assert "r2c-axis2-fused-lines" in p.route.reasons
    assert not any("nyquist" in r for r in p.route.reasons), p.route.reasons
    _, p = _plans("r2c", (16, 2, 256), 1, "none")
    assert "r2c-axis2-fused-lines" in p.route.reasons            # 8 * 2 body lines
    assert "r2c-axis2-nyquist-xla" in p.route.reasons            # 2 slab lines


def test_c2r_ignores_self_conjugate_imag(rng, assert_close):
    for shape in [(8,), (8, 6), (9,)]:
        x = rng.standard_normal((1, *shape))
        dirty = R.r2c_packed(x, shape).copy()
        dirty[:, 0] += 0.7j
        if shape[0] % 2 == 0:
            dirty[:, -1] += 0.3j
        jplan, tplan = _plans("c2r", shape, 1, "backward")
        got = tplan(torch.from_numpy(interleave(dirty))).numpy()
        assert_close(got, np.asarray(jplan(interleave(dirty))), label=f"dirty {shape}")
        if len(shape) == 1:
            assert_close(got, x, label=f"self-conj imag ignored {shape}")


def test_unitary_round_trip_is_identity(rng, assert_close):
    x = rng.standard_normal((3, 24, 6)).astype(np.float32)
    _, fwd = _plans("r2c", (24, 6), 3, "unitary")
    _, inv = _plans("c2r", (24, 6), 3, "unitary")
    assert_close(inv(fwd(torch.from_numpy(x))).numpy(), x, label="unitary round trip")


def test_r2c_takes_real_input():
    """An r2c plan takes real (batch, *shape) input and rejects the
    interleaved layout; c2r takes interleaved packed input."""
    _, r2c = _plans("r2c", (16, 4), 2, "none")
    assert r2c.input_shape == (2, 16, 4) and not r2c.input_interleaved
    assert tuple(r2c(torch.zeros(2, 16, 4)).shape) == (2, 9, 4, 2)
    with pytest.raises(T.PlanError, match="expected input shape"):
        r2c(torch.zeros(2, 16, 4, 2))
    _, c2r = _plans("c2r", (16, 4), 2, "none")
    assert c2r.input_shape == (2, 9, 4, 2) and c2r.input_interleaved
    with pytest.raises(T.PlanError, match="expected input shape"):
        c2r(torch.zeros(2, 9, 4))


def test_real_impl_pallas_raises_where_an_axis_is_off_the_kernels():
    with pytest.raises(T.PlanError, match="impl='pallas'"):
        _plans("r2c", (8, 8), 2, "none", impl="pallas")


@pytest.mark.parametrize("kind,shape,tuning", [
    ("r2c", (8, 13), {"forceRaderAxes": [1]}),       # int32 Rader tables
    ("c2r", (9, 4), {}),                               # odd n0: mirror path
    ("r2c", (8192,), {"fourStepMinN": 2048}),          # four-step half axis
    ("c2r", (16, 17), {}),                             # Rader on the rest axis
    ("c2r", (8, 34), {"forceBluesteinAxes": [1]}),
])
def test_real_plan_runs_on_the_jax_tables(kind, shape, tuning, rng):
    jplan, tplan = _plans(kind, shape, 2, "backward", impl="xla", **tuning)
    tables = T.tables_from_reference(jplan._consts_np, "cpu")
    assert {k: v.dtype for k, v in tables.items()} == \
        {k: v.dtype for k, v in tplan.consts.items()}
    x = rng.standard_normal((2, *shape))
    inp = x.astype(np.float32) if kind == "r2c" else interleave(R.r2c_packed(x, shape))
    inp = torch.from_numpy(inp)
    own = tplan(inp)
    assert torch.equal(tplan.load_consts(tables)(inp), own)


def test_four_step_in_r2c_c2r_matches_jax(rng, assert_close):
    """r2c/c2r ride the four-step for their half-length axis-0 FFT."""
    x = rng.standard_normal((1, 8192)).astype(np.float32)
    jf, tf = _plans("r2c", (8192,), 1, "none", fourStepMinN=2048)
    _, ti = _plans("c2r", (8192,), 1, "backward", fourStepMinN=2048)
    assert tf.route.mode == "four-step-hbm", tf.route.reasons
    y = tf(torch.from_numpy(x))
    assert_close(y.numpy(), np.asarray(jf(x)), label="r2c four-step")
    assert_close(ti(y).numpy(), x, label="c2r four-step round trip")


def test_load_consts_keeps_integer_tables_and_checks_kinds():
    plan = T.create_plan({"type": "c2c", "shape": [13], "batch": 2,
                          "tuning": {"forceRaderAxes": [0]}},
                         device="cpu", cache=T.PlanCache())
    own = plan.consts
    assert own["ax0/perm_in"].dtype == torch.int32
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 13, 2)).astype(np.float32))
    y = plan(x)
    as_numpy = {k: v.numpy() for k, v in own.items()}
    assert torch.equal(plan.load_consts(as_numpy)(x), y)
    assert plan.consts["ax0/perm_in"].dtype == torch.int32
    with pytest.raises(T.PlanError, match="dtype"):
        plan.load_consts({**own, "ax0/perm_in": own["ax0/perm_in"].float()})
