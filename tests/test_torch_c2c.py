"""The c2c slice: ``webgpufft_tpu.create_plan`` against
``webgpufft_tpu_torch.create_plan(..., device="cpu")``.

Same options, same input (numpy, from a seed), same output at
1e-5 * max|expected|, and the same route metadata: ``route.mode`` and the
``c2c-axis{d}-{kind}`` reasons.  On the CPU the port's kernel wrappers run
their plain torch versions; the JAX package runs its Pallas kernels in
interpret mode, as its own tests do.
"""

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.core.cplx import interleave

CASES = [([1024], 8, "forward", "unitary"), ([2048], 8, "inverse", "backward"),
         ([256, 256], 2, "forward", "none"), ([16, 256, 256], 1, "inverse", "unitary")]
MODES = {("pallas-auto", 1): "pallas-fused", ("pallas-auto", 2): "pallas-fused",
         ("pallas-auto", 3): "pallas-mixed"}


def _axis_reasons(route):
    return [r for r in route.reasons if r.startswith("c2c-axis")]


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
    assert tplan.route.mode == jplan.route.mode == MODES.get((impl, len(shape)), "xla")
    assert _axis_reasons(tplan.route) == _axis_reasons(jplan.route)
    assert tplan.route.axis_kinds == jplan.route.axis_kinds


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
    opts = _opts([16, 256, 256], 1, "forward", "none", "pallas")  # axis 0 cannot split
    with pytest.raises(W.PlanError, match="impl='pallas'"):
        W.create_plan(opts, cache=W.PlanCache())
    with pytest.raises(T.PlanError, match="impl='pallas'"):
        T.create_plan(opts, device="cpu", cache=T.PlanCache())


@pytest.mark.parametrize("shape,batch", [([7], 8), ([1024], 4), ([12, 18], 3), ([1, 64], 8)])
def test_routes_off_the_kernels_match_jax(shape, batch, rng, assert_close):
    """Lengths without a split, too few lines, small digits and unit axes
    take the einsum route in both packages."""
    opts = _opts(shape, batch, "forward", "backward", "pallas-auto")
    x = rng.standard_normal((batch, *shape, 2)).astype(np.float32)
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert_close(tplan(torch.from_numpy(x)).numpy(), np.asarray(jplan(x)), label=str(shape))
    assert tplan.route.mode == jplan.route.mode
    assert _axis_reasons(tplan.route) == _axis_reasons(jplan.route)
