"""The c2c slice: ``webgpufft_tpu.create_plan`` against
``webgpufft_tpu_torch.create_plan(..., device="cpu")``.

Same options, same input (numpy, from a seed), same output at
1e-5 * max|expected|, and the same route metadata: ``route.mode`` and the
``c2c-axis{d}-{kind}`` reasons.  On the CPU the port's kernel wrappers run
their plain torch versions; the JAX package runs its Pallas kernels in
interpret mode, as its own tests do.

One routing rule differs by design: the JAX package keeps a rank > 1 axis
whose split has a digit below 16 off its kernels (a Mosaic VMEM fact); the
port has no such rule.  For exactly those cases ``PORT_ROUTES`` writes out
the port's mode and per-axis kinds; outputs are compared all the same.
"""

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu.utils import mathref as R
from webgpufft_tpu_torch.core.cplx import interleave

CASES = [([1024], 8, "forward", "unitary"), ([2048], 8, "inverse", "backward"),
         ([256, 256], 2, "forward", "none"), ([16, 256, 256], 1, "inverse", "unitary")]
MODES = {("pallas-auto", 1): "pallas-fused", ("pallas-auto", 2): "pallas-fused",
         ("pallas-auto", 3): "pallas-mixed"}


def _axis_reasons(route):
    return [r for r in route.reasons if r.startswith("c2c-axis")]


_LAST = ("pallas-mixed", ["xla", "fused-lines"])
# case -> (mode, kind of each axis) where the port's route differs from the
# JAX package's because the port has no rank > 1 digit rule
PORT_ROUTES = {
    "16x256x256": ("pallas-fused", ["fused-cols", "fused-cols", "fused-lines"]),
    "12x18": _LAST, "1x64": _LAST,
    "8x8-b2-forward-none": _LAST, "8x8-b2-inverse-none": _LAST,
    "16x12-b2-forward-none": _LAST, "16x12-b2-inverse-none": _LAST,
    "9x4-b2-forward-none": _LAST, "9x4-b2-inverse-none": _LAST,
    "17x8-b2-forward-none": _LAST, "17x8-b2-inverse-none": _LAST,
    "34x6-b2-forward-none": _LAST, "34x6-b2-inverse-none": _LAST,
    "4x4x4-b2-forward-none": ("pallas-mixed", ["xla", "xla", "fused-lines"]),
    "4x4x4-b2-inverse-none": ("pallas-mixed", ["xla", "xla", "fused-lines"]),
    "32x15-b2-forward-none": _LAST, "32x15-b2-inverse-none": _LAST,
    "32x15-b2-inverse-backward": _LAST,
    "512x4-b2-forward-none-maxSubLength=8": _LAST,
}


def _check_route(key, jplan, tplan, impl="pallas-auto"):
    """The port's route equals the JAX package's, or what ``PORT_ROUTES``
    writes out for a case the digit rule decided (never under "xla")."""
    assert tplan.route.axis_kinds == jplan.route.axis_kinds
    if impl != "xla" and key in PORT_ROUTES:
        mode, kinds = PORT_ROUTES[key]
        assert tplan.route.mode == mode, tplan.route.reasons
        assert _axis_reasons(tplan.route) == [f"c2c-axis{d}-{k}" for d, k in enumerate(kinds)]
        assert (tplan.route.mode, _axis_reasons(tplan.route)) != \
            (jplan.route.mode, _axis_reasons(jplan.route))
    else:
        assert tplan.route.mode == jplan.route.mode
        assert _axis_reasons(tplan.route) == _axis_reasons(jplan.route)


def _opts(shape, batch, direction, normalize, impl):
    return {"type": "c2c", "shape": shape, "batch": batch, "direction": direction,
            "normalize": normalize, "tuning": {"impl": impl}}


@pytest.mark.parametrize("impl", ["pallas-auto", "xla"])
@pytest.mark.parametrize("shape,batch,direction,normalize", CASES)
def test_plan_matches_jax(shape, batch, direction, normalize, impl, rng, assert_close):
    opts = _opts(shape, batch, direction, normalize, impl)
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    x = interleave(z)
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    got = tplan(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, *shape, 2)
    assert_close(got.numpy(), np.asarray(jplan(x)), label=f"{shape} {impl}")
    assert jplan.route.mode == MODES.get((impl, len(shape)), "xla")
    _check_route("x".join(map(str, shape)), jplan, tplan, impl)


@pytest.mark.parametrize("shape,batch,direction,normalize", CASES[:3])
def test_plan_runs_on_the_jax_tables(shape, batch, direction, normalize):
    """The JAX plan's tables, converted and loaded, give the port's output
    bit for bit (they are the same tables)."""
    opts = _opts(shape, batch, direction, normalize, "pallas-auto")
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tables = T.tables_from_reference(jplan._consts_np, "cpu")  # before any JAX exec
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (batch, *shape, 2)).astype(np.float32))
    own = tplan(x)
    assert torch.equal(tplan.load_consts(tables)(x), own)


def test_impl_pallas_raises_in_both_packages():
    opts = _opts([17, 256, 256], 1, "forward", "none", "pallas")  # axis 0 cannot split
    with pytest.raises(W.PlanError, match="impl='pallas'"):
        W.create_plan(opts, cache=W.PlanCache())
    with pytest.raises(T.PlanError, match="impl='pallas'"):
        T.create_plan(opts, device="cpu", cache=T.PlanCache())
    # axis 0 = 16 = 4 * 4 is off the JAX package's kernels (digit below 16)
    # and on the port's
    opts = _opts([16, 256, 256], 1, "forward", "none", "pallas")
    with pytest.raises(W.PlanError, match="impl='pallas'"):
        W.create_plan(opts, cache=W.PlanCache())
    assert T.create_plan(opts, device="cpu", cache=T.PlanCache()).route.mode == "pallas-fused"


@pytest.mark.parametrize("shape,batch", [([7], 8), ([1024], 4), ([12, 18], 3), ([1, 64], 8)])
def test_routes_off_the_kernels_match_jax(shape, batch, rng, assert_close):
    """Lengths without a split, too few lines and unit axes take the einsum
    route in both packages; small digits in a rank > 1 plan only in the JAX
    package."""
    opts = _opts(shape, batch, "forward", "backward", "pallas-auto")
    x = rng.standard_normal((batch, *shape, 2)).astype(np.float32)
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert_close(tplan(torch.from_numpy(x)).numpy(), np.asarray(jplan(x)), label=str(shape))
    _check_route("x".join(map(str, shape)), jplan, tplan)


def _reference_case_lists():
    """The c2c cases of tests/test_c2c.py and tests/test_fused.py as
    (shape, batch, direction, normalize, tuning), repeats merged."""
    cases = []
    for shape in [(4,), (8,), (16,), (1024,), (12,), (60,), (2310,),   # mixed radix
                  (17,), (97,), (101,),                                # Rader primes
                  (34,), (646,),                                       # Bluestein composites
                  (8, 8), (16, 12), (9, 4), (17, 8), (34, 6), (4, 4, 4), (8, 3, 5),
                  (4, 3, 2, 5), (32, 15), (1, 8), (30,)]:
        for direction in ("forward", "inverse"):
            cases.append((shape, 2, direction, "none", {}))
    for normalize in ("none", "backward", "unitary"):
        for direction in ("forward", "inverse"):
            cases.append(((24,), 3, direction, normalize, {}))
    cases += [((13,), 2, "forward", "none", {"forceBluesteinAxes": [0]}),
              ((13,), 2, "forward", "none", {"forceRaderAxes": [0]}),
              ((31,), 1, "forward", "none", {"raderMaxPrime": 20}),
              ((30,), 1, "forward", "none", {}), ((30,), 37, "forward", "none", {}),
              ((512, 4), 2, "forward", "none", {"maxSubLength": 8}),
              ((32, 15), 2, "inverse", "backward", {})]
    for n in (16, 64, 256, 1024, 4096, 12, 60, 2310):              # test_fused.py
        for direction in ("forward", "inverse"):
            cases.append(((n,), 16, direction, "none", {}))
    cases += [((1024,), 16, "inverse", "backward", {}),
              ((1024,), 16, "inverse", "unitary", {}),
              ((256,), 32, "forward", "none", {}),
              ((256,), 32, "forward", "none", {"impl": "xla"}),
              ((17,), 16, "forward", "none", {}), ((64,), 2, "forward", "none", {})]
    unique = {}
    for shape, batch, direction, normalize, tuning in cases:
        key = "-".join(["x".join(map(str, shape)), f"b{batch}", direction, normalize]
                       + [f"{k}={v}" for k, v in tuning.items()])
        unique[key] = (shape, batch, direction, normalize, tuning)
    return [pytest.param(*c, id=k) for k, c in unique.items()]


@pytest.mark.parametrize("shape,batch,direction,normalize,tuning", _reference_case_lists())
def test_reference_case_lists_match_jax(shape, batch, direction, normalize, tuning,
                                        rng, assert_close, request):
    """Every c2c case of the JAX package's own c2c and fused-kernel tests,
    through both packages under ``impl: "pallas-auto"`` unless the case
    names another impl: the same output (and the numpy oracle's), mode,
    axis kinds and per-axis reasons (``PORT_ROUTES`` where the digit rule
    decided)."""
    opts = {"type": "c2c", "shape": list(shape), "batch": batch, "direction": direction,
            "normalize": normalize, "tuning": {"impl": "pallas-auto", **tuning}}
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    x = interleave(z)
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    got = tplan(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(jplan(x)), label=f"{shape} vs JAX")
    ref = R.fft_nd(z, shape, direction, normalize)
    assert_close(got, np.stack([ref.real, ref.imag], -1), label=f"{shape} vs numpy")
    _check_route(request.node.callspec.id, jplan, tplan, tuning.get("impl", "pallas-auto"))
