"""K2's tall tiles in the ring design, on the CPU.

For tiles of 8192 points or more K2 runs persistent CTAs that land the next
tile in a ring of shared-memory stages while the current one runs its
passes (``csrc/stage.cuh``, ``csrc/cols.cuh``); below, the direct design.
Neither changes the function, so the plain version stays the reference:
here K2's wrapper and its design probe (``probes.cols_variant``) on CPU
tensors, which run that plain version, are held against the JAX package's
kernel (the Pallas call in interpret mode, as its own tests run it) at
heights and column counts the ring serves on the card, forward and
adjoint.  Then the ring's exchange layout against the banks, and the card
sweep's unit counts (``chip_smoke.ring_units``).  Tolerance: 1e-5 *
max|expected|.  tests/test_torch_cuda.py holds both designs against the
plain version on the card.
"""

import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpufft_tpu.core import fused_cols as jcols
from webgpufft_tpu.spec import TuningSpec
from webgpufft_tpu_torch import _build, probes
from webgpufft_tpu_torch.core import fused_cols
from webgpufft_tpu_torch.probes import variants

REPO = pathlib.Path(__file__).resolve().parent.parent
BIG_VMEM = TuningSpec(vmem_limit_bytes=256 << 20)


def _tables(consts):
    return {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in consts.items()}


def _conj(a):
    return np.stack([a[..., 0], -a[..., 1]], -1)


# ---- K2 against the JAX package ----------------------------------------------

@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("h,lanes", [(512, 66), (1024, 2048), (2048, 10)])
def test_tall_tiles_match_jax(h, lanes, adjoint, rng, assert_close):
    pre = 2
    x = rng.standard_normal((pre, h, lanes)).astype(np.float32)
    consts = {}
    fn = jcols.build_fused_cols(pre, h, lanes, "inverse", 1.0 / h, consts, "p", BIG_VMEM)
    jx = _conj(x.reshape(pre, h, -1, 2)).reshape(x.shape) if adjoint else x
    want = np.asarray(fn(jnp.asarray(jx), {k: jnp.asarray(v) for k, v in consts.items()}))
    if adjoint:
        want = _conj(want.reshape(pre, h, -1, 2)).reshape(want.shape)
    t = _tables(fused_cols.cols_consts(h, "inverse", 1.0 / h, "p"))
    before = (fused_cols.fused_cols.launches, variants.cols_variant.launches)
    got = fused_cols.fused_cols(torch.from_numpy(x), t, adjoint=adjoint)
    probe = probes.cols_variant(torch.from_numpy(x), t, "ring", adjoint=adjoint)
    # CPU tensors never launch
    assert (fused_cols.fused_cols.launches, variants.cols_variant.launches) == before
    assert_close(got.numpy(), want, label=f"K2 h={h} lanes={lanes} adjoint={adjoint}")
    assert_close(probe.numpy(), want, label=f"K2 probe h={h} lanes={lanes} adjoint={adjoint}")


def test_cols_in_place_writes_the_input(rng, assert_close):
    x = torch.from_numpy(rng.standard_normal((3, 1024, 66)).astype(np.float32))
    t = _tables(fused_cols.cols_consts(1024, "forward", 1.0, "p"))
    want = fused_cols.fused_cols_reference(x, t)
    got = probes.cols_inplace(x, t)
    assert got is x
    assert_close(x.numpy(), want.numpy(), label="K2 in place")


@pytest.mark.parametrize("design", ["ring-tma", "ring-other", "classic"])
def test_cols_variant_refuses_designs_it_does_not_have(design):
    t = _tables(fused_cols.cols_consts(512, "forward", 1.0, "p"))
    with pytest.raises(ValueError, match="design must be one of"):
        probes.cols_variant(torch.zeros(2, 512, 8), t, design)


def test_cols_variant_checks_layout_before_anything_else():
    t = _tables(fused_cols.cols_consts(512, "forward", 1.0, "p"))
    with pytest.raises(ValueError, match="L even"):
        probes.cols_variant(torch.zeros(2, 512, 7), t, "ring")
    with pytest.raises(ValueError, match="unsupported device"):
        probes.cols_variant(torch.zeros(2, 512, 8, device="meta"), t, "direct")


# ---- the ring's exchange layout ----------------------------------------------

@pytest.mark.parametrize("tc", [1, 2, 4, 8, 16])
def test_padded_exchange_spreads_a_warps_strided_rows(tc):
    """The K2 ring's exchange layout, one point of padding in 16 over the
    tile's row-major index (``padded`` in ``csrc/stage.cuh``): a warp
    (32 // tc rows of tc columns) writing rows R apart (the first pass's
    autosort, R = 16) touches no bank more often than the two wavefronts its
    256 bytes need at least."""
    assert "return i + (i >> 4);" in (_build.CSRC / "stage.cuh").read_text()
    rows = 32 // tc
    for r0 in range(4):
        words = []
        for j in range(rows):
            for u in range(tc):
                i = (j * 16 + r0) * tc + u
                p = i + (i >> 4)
                words += [2 * p, 2 * p + 1]
        banks = np.bincount(np.asarray(words) % 32, minlength=32)
        assert banks.max() <= 2, (tc, r0, banks)


# ---- the card sweep's unit counts -------------------------------------------

@pytest.mark.parametrize("grid", [8, 131, 132, 264, 528])
def test_ring_units_turn_every_stage_and_leave_a_ragged_tail(grid):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    stages = re.search(r"constexpr int kRingStages = ([0-9]+);",
                       (_build.CSRC / "stage.cuh").read_text())
    assert stages and int(stages.group(1)) == chip_smoke.RING_STAGES
    units = chip_smoke.ring_units(grid)
    assert units % grid != 0   # the last turn is ragged
    for cta in range(grid):
        walked = len(range(cta, units, grid))
        for stage in range(chip_smoke.RING_STAGES):
            fills = len(range(stage, walked, chip_smoke.RING_STAGES))
            assert fills >= 3, (cta, stage)   # used, then reused twice
