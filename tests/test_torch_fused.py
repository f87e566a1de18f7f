"""K1 (fused line kernel): the PyTorch port against the JAX package.

The JAX side runs ``webgpufft_tpu.core.fused.build_fused_lines`` as its own
tests do on the CPU (the Pallas call in interpret mode); the port's side is
``fused_lines`` on a CPU tensor, which runs the plain torch version of the
CUDA kernel.  Tolerance: 1e-5 * max|expected| (conftest._assert_close).

The CUDA kernel itself is held against this plain version on a GPU by
tests/test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpufft_tpu.core import fused as jfused
from webgpufft_tpu.spec import TuningSpec
from webgpufft_tpu_torch.core import fused
from webgpufft_tpu_torch.utils.mathref import normalize_scale

LINES = 8


def _input(rng, n, lines=LINES):
    return rng.standard_normal((lines, n, 2)).astype(np.float32)


def _tables(n, direction, scale, device="cpu"):
    return {k.rsplit("/", 1)[1]: torch.as_tensor(v, device=device)
            for k, v in fused.lines_consts(n, direction, scale, "p").items()}


@pytest.mark.parametrize("normalize", ["none", "backward", "unitary"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [1024, 2048, 360, 1000, 2310, 8192, 16384, 512, 256])
def test_lines_match_jax(n, direction, normalize, rng, assert_close):
    scale = normalize_scale(normalize, direction, n)
    x = _input(rng, n)
    consts = {}
    fn = jfused.build_fused_lines(n, LINES, direction, TuningSpec(), consts,
                                  scale, prefix="p")
    want = np.asarray(fn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in consts.items()}))
    before = fused.fused_lines.launches
    got = fused.fused_lines(torch.from_numpy(x), _tables(n, direction, scale))
    assert fused.fused_lines.launches == before  # CPU tensors never launch
    assert got.shape == (LINES, n, 2) and got.dtype == torch.float32
    assert_close(got.numpy(), want, label=f"K1 n={n} {direction} {normalize}")


@pytest.mark.parametrize("n", [1024, 2048, 360, 1000, 2310, 16384])
def test_split_matches_jax(n):
    assert fused.choose_split(n) == jfused.choose_split(n)
    assert fused.supports_length(n) == jfused.supports_length(n, TuningSpec())


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [2048, 360, 1000, 2310, 4, 1352, 16384])
def test_tables_from_reference_are_bitwise(n, direction):
    """The K1 tables recovered from the JAX package's Mosaic layout equal
    the port's own, bit for bit (non-square splits pin the digit order),
    and so do the CUDA kernel's tables (``cw``, ``cp``), rebuilt from the
    length, direction and scale that the recovered tables give."""
    scale = 1.0 / math.sqrt(n)
    ref = jfused.fused_consts(n, direction, scale, "fl0")
    got = fused.tables_from_reference(ref, "fl0")
    own = fused.lines_consts(n, direction, scale, "fl0")
    assert set(got) == set(own) == {f"fl0/{k}" for k in fused.TABLE_NAMES}
    for k in own:
        assert got[k].shape == own[k].shape, k
        assert np.array_equal(got[k], own[k]), k


def test_wrapper_rejects_unsupported_device():
    t = _tables(64, "forward", 1.0, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_lines(torch.empty(8, 64, 2, device="meta"), t)

