"""K2 (columns kernel): the PyTorch port against the JAX package.

The JAX side runs ``webgpufft_tpu.core.fused_cols.build_fused_cols`` in
interpret mode on the CPU (with a VMEM budget large enough to tile every
case here); the port's side is ``fused_cols`` on a CPU tensor, which runs
the plain torch version of the CUDA kernel.  Tolerance: 1e-5 * max|expected|.
tests/test_torch_cuda.py holds the CUDA kernel against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpufft_tpu.core import fused_cols as jcols
from webgpufft_tpu.spec import TuningSpec
from webgpufft_tpu_torch.core import fused_cols

PRE = 2
BIG_VMEM = TuningSpec(vmem_limit_bytes=256 << 20)
# heights K2's rule gives the general design (fused_cols.GENERAL_COLS), on
# a chain of their own (cols_chain): the paths' and a few others
GENERAL_SAMPLE = [h for h in (1080, 1920, 3000, 6561, 9, 32, 2401, 210)
                  if h in {g.h for g in fused_cols.GENERAL_COLS}]


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("lanes", [128, 512])
@pytest.mark.parametrize("h", [256, 2048, 360, 7])
def test_cols_match_jax(h, lanes, direction, rng, assert_close):
    scale = 1.0 / h if direction == "inverse" else 1.0
    x = rng.standard_normal((PRE, h, lanes)).astype(np.float32)
    consts = {}
    fn = jcols.build_fused_cols(PRE, h, lanes, direction, scale, consts, "p", BIG_VMEM)
    want = np.asarray(fn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in consts.items()}))
    own = fused_cols.cols_consts(h, direction, scale, "p")
    assert set(own) - set(consts) == {"p/cw", "p/cp"}  # the CUDA kernel's own
    for k, v in consts.items():  # same host tables, bit for bit
        assert np.array_equal(own[k], v), k
    tables = {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in own.items()}
    before = fused_cols.fused_cols.launches
    got = fused_cols.fused_cols(torch.from_numpy(x), tables)
    assert fused_cols.fused_cols.launches == before  # CPU tensors never launch
    assert got.shape == (PRE, h, lanes) and got.dtype == torch.float32
    assert_close(got.numpy(), want, label=f"K2 h={h} lanes={lanes} {direction}")


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("h", GENERAL_SAMPLE)
def test_general_chain_matches_jax(h, adjoint, direction, rng, assert_close):
    """The CUDA kernel's pass schedule at a height of the general design
    (``fused_cols_chain_reference`` on ``cols_chain(h)`` with the ``cw``
    of ``cols_consts``) against the JAX package's K2 in interpret mode;
    the adjoint as conj(F conj x)."""
    chain = fused_cols.cols_chain(h)
    assert chain == next(g.chain for g in fused_cols.GENERAL_COLS if g.h == h)
    scale = 1.0 / h if direction == "inverse" else 1.0
    x = rng.standard_normal((PRE, h, 128)).astype(np.float32)
    consts = {}
    fn = jcols.build_fused_cols(PRE, h, 128, direction, scale, consts, "p", BIG_VMEM)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    if adjoint:
        conj = x.copy()
        conj[..., 1::2] *= -1
        want = np.asarray(fn(jnp.asarray(conj), jc)).copy()
        want[..., 1::2] *= -1
    else:
        want = np.asarray(fn(jnp.asarray(x), jc))
    tables = {k.rsplit("/", 1)[1]: torch.from_numpy(v)
              for k, v in fused_cols.cols_consts(h, direction, scale, "p").items()}
    got = fused_cols.fused_cols_chain_reference(torch.from_numpy(x), tables, adjoint)
    assert_close(got.numpy(), want, label=f"K2 general h={h} {chain} {direction} adj={adjoint}")


@pytest.mark.parametrize("h", [256, 2048, 360, 7, 16, 13, 16384, 17])
def test_split_matches_jax(h):
    assert fused_cols.choose_split(h) == jcols.choose_split(h)
    assert fused_cols.supports_length(h) == jcols.supports_length(h)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("h", [256, 2048, 360, 7, 2, 3, 16, 1352] + GENERAL_SAMPLE)
def test_tables_from_reference_are_bitwise(h, direction):
    """The JAX package's K2 tables pass through, and the CUDA kernel's tables
    (``cw``, ``cp``), rebuilt from the length, direction and scale that those
    tables give, equal the port's own bit for bit."""
    scale = 1.0 / h if direction == "inverse" else 0.125
    ref = jcols.cols_consts(h, direction, scale, "fc1")
    got = fused_cols.tables_from_reference(ref, "fc1")
    own = fused_cols.cols_consts(h, direction, scale, "fc1")
    assert set(got) == set(own) == {f"fc1/{k}" for k in fused_cols.TABLE_NAMES}
    for k in own:
        assert got[k].dtype == own[k].dtype and np.array_equal(got[k], own[k]), k


def test_wrapper_rejects_unsupported_device():
    tables = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="meta")
              for k, v in fused_cols.cols_consts(256, "forward", 1.0, "p").items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_cols.fused_cols(torch.empty(2, 256, 128, device="meta"), tables)
