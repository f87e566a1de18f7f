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
    for k, v in consts.items():  # same host tables, bit for bit
        assert np.array_equal(own[k], v), k
    tables = {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in own.items()}
    before = fused_cols.fused_cols.launches
    got = fused_cols.fused_cols(torch.from_numpy(x), tables)
    assert fused_cols.fused_cols.launches == before  # CPU tensors never launch
    assert got.shape == (PRE, h, lanes) and got.dtype == torch.float32
    assert_close(got.numpy(), want, label=f"K2 h={h} lanes={lanes} {direction}")


@pytest.mark.parametrize("h", [256, 2048, 360, 7, 16, 13, 16384, 17])
def test_split_matches_jax(h):
    assert fused_cols.choose_split(h) == jcols.choose_split(h)
    assert fused_cols.supports_length(h) == jcols.supports_length(h)


def test_wrapper_rejects_unsupported_device():
    tables = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="meta")
              for k, v in fused_cols.cols_consts(256, "forward", 1.0, "p").items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_cols.fused_cols(torch.empty(2, 256, 128, device="meta"), tables)
