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
@pytest.mark.parametrize("n", [1024, 2048, 360, 1000, 2310, 8192, 16384, 512, 256, 2079, 3000,
                               6144, 8232, 16, 64, 128, 6, 77, 1080, 1200, 1920, 2401])
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
@pytest.mark.parametrize("n", [2048, 360, 1000, 2310, 4, 1352, 16384, 2079, 6144])
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


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [2079, 3000, 6144, 8232])
def test_mixed_design_chain_matches_jax(n, direction, adjoint, rng, assert_close):
    """At lengths K1's rule gives the mixed-radix design, the kernel's pass
    schedule on the CPU (``fused_lines_chain_reference``: its chain of
    composite radices, its ``cw`` table) against the JAX package's K1 on a
    few lines, with the unitary scale; the adjoint against the JAX
    transform's conjugate transpose."""
    from webgpufft_tpu_torch.core import radix
    assert radix.lines_design(n) == "mixed"
    lines = 3
    scale = normalize_scale("unitary", direction, n)
    x = _input(rng, n, lines)
    consts = {}
    fn = jfused.build_fused_lines(n, lines, direction, TuningSpec(), consts, scale, prefix="p")
    run = lambda v: np.asarray(fn(jnp.asarray(v), {k: jnp.asarray(c) for k, c in consts.items()}))
    if adjoint:   # conj(F conj x)
        conj = x * np.array([1, -1], np.float32)
        want = run(conj) * np.array([1, -1], np.float32)
    else:
        want = run(x)
    got = fused.fused_lines_chain_reference(torch.from_numpy(x), _tables(n, direction, scale),
                                            adjoint)
    assert_close(got.numpy(), want, label=f"K1 chain model n={n} {direction} adjoint={adjoint}")


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [96, 1080, 1200, 1920, 2000, 2401])
def test_general_design_chain_matches_jax(n, direction, adjoint, rng, assert_close):
    """At lengths K1's rule gives the general design (two to four passes of
    radices up to 32: 96 = 12 * 8, 1920 in three, 7^4 in four), the
    kernel's pass schedule on the CPU (``fused_lines_chain_reference``: the
    table's chain and ``cw`` table) against the JAX package's K1 on a few
    lines, with the unitary scale; the adjoint against the JAX transform's
    conjugate transpose."""
    from webgpufft_tpu_torch.core import radix
    assert radix.lines_design(n) == "general"
    lines = 3
    scale = normalize_scale("unitary", direction, n)
    x = _input(rng, n, lines)
    consts = {}
    fn = jfused.build_fused_lines(n, lines, direction, TuningSpec(), consts, scale, prefix="p")
    run = lambda v: np.asarray(fn(jnp.asarray(v), {k: jnp.asarray(c) for k, c in consts.items()}))
    if adjoint:   # conj(F conj x)
        conj = x * np.array([1, -1], np.float32)
        want = run(conj) * np.array([1, -1], np.float32)
    else:
        want = run(x)
    got = fused.fused_lines_chain_reference(torch.from_numpy(x), _tables(n, direction, scale),
                                            adjoint)
    assert_close(got.numpy(), want, label=f"K1 general chain n={n} {direction} adjoint={adjoint}")


def test_wrapper_rejects_unsupported_device():
    t = _tables(64, "forward", 1.0, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_lines(torch.empty(8, 64, 2, device="meta"), t)

