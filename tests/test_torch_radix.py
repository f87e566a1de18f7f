"""The radix-chain FFT behind the port's CUDA kernels, on the CPU.

``webgpufft_tpu_torch.core.radix`` chooses the chain of radices for a
length, builds the twiddle and parameter tables the CUDA kernels read, and
models their pass schedule in plain torch (same passes, index maps, tables
and butterfly algebra).  Here the model is held against the kernels' plain
versions (``fused_lines_reference``, ``fused_cols_reference``) and against
``numpy.fft``, the chooser is checked for every eligible length, and the
tables against float64.  The CUDA code itself is held against the plain
versions on a GPU by tests/test_torch_cuda.py.

Tolerance: 1e-5 * max|expected| (tests/conftest._assert_close).
"""

import math

import numpy as np
import pytest
import torch

from webgpufft_tpu_torch.core import fused, fused_cols, radix
from webgpufft_tpu_torch.utils import factors
from webgpufft_tpu_torch.utils.mathref import normalize_scale

# squares, non-squares, every radix, both shared-memory extremes
LENGTHS = [1024, 2048, 360, 1000, 2310, 1352, 4096, 16384, 16, 6, 121, 32, 8192]
ELIGIBLE = [n for n in range(2, radix.MAX_LENGTH + 1)
            if fused.choose_split(n) or fused_cols.choose_split(n)]


def _tables(consts):
    return {k.rsplit("/", 1)[1]: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in consts.items()}


def _numpy_fft(z, direction, scale, axis):
    if direction == "forward":
        return np.fft.fft(z, axis=axis) * scale
    return np.fft.ifft(z, axis=axis) * (z.shape[axis] * scale)


@pytest.mark.parametrize("normalize", ["none", "backward", "unitary"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", LENGTHS)
def test_lines_chain_model_matches_plain_and_numpy(n, direction, normalize, rng, assert_close):
    scale = normalize_scale(normalize, direction, n)
    lines = 2 if n > 4096 else 5
    x = rng.standard_normal((lines, n, 2)).astype(np.float32)
    tables = _tables(fused.lines_consts(n, direction, scale, "p"))
    got = fused.fused_lines_chain_reference(torch.from_numpy(x), tables)
    assert got.shape == (lines, n, 2) and got.dtype == torch.float32
    plain = fused.fused_lines_reference(torch.from_numpy(x), tables)
    assert_close(got.numpy(), plain.numpy(), label=f"K1 model vs plain n={n}")
    want = _numpy_fft(x[..., 0].astype(np.float64) + 1j * x[..., 1], direction, scale, 1)
    assert_close(got.numpy(), np.stack([want.real, want.imag], -1),
                 label=f"K1 model vs numpy n={n} {direction} {normalize}")


@pytest.mark.parametrize("normalize", ["none", "backward", "unitary"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("h", LENGTHS)
def test_cols_chain_model_matches_plain_and_numpy(h, direction, normalize, rng, assert_close):
    scale = normalize_scale(normalize, direction, h)
    pre, cols = 2, 3
    x = rng.standard_normal((pre, h, 2 * cols)).astype(np.float32)
    tables = _tables(fused_cols.cols_consts(h, direction, scale, "p"))
    got = fused_cols.fused_cols_chain_reference(torch.from_numpy(x), tables)
    assert got.shape == (pre, h, 2 * cols) and got.dtype == torch.float32
    plain = fused_cols.fused_cols_reference(torch.from_numpy(x), tables)
    assert_close(got.numpy(), plain.numpy(), label=f"K2 model vs plain h={h}")
    z = x.reshape(pre, h, cols, 2).astype(np.float64)
    want = _numpy_fft(z[..., 0] + 1j * z[..., 1], direction, scale, 1)
    assert_close(got.numpy(), np.stack([want.real, want.imag], -1).reshape(pre, h, 2 * cols),
                 label=f"K2 model vs numpy h={h} {direction} {normalize}")


@pytest.mark.parametrize("h", [2, 3, 5, 7, 11, 13, 8, 4, 16])
def test_one_pass_chain_model_matches_plain(h, rng, assert_close):
    """Lengths that are one butterfly, no pass through shared memory."""
    assert radix.radix_chain(h) == (h,)
    x = rng.standard_normal((3, h, 8)).astype(np.float32)
    for direction in ("forward", "inverse"):
        tables = _tables(fused_cols.cols_consts(h, direction, 0.25, "p"))
        assert_close(fused_cols.fused_cols_chain_reference(torch.from_numpy(x), tables).numpy(),
                     fused_cols.fused_cols_reference(torch.from_numpy(x), tables).numpy(),
                     label=f"h={h} {direction}")


@pytest.mark.parametrize("n", ELIGIBLE)
def test_radix_chain_for_every_eligible_length(n):
    chain = radix.radix_chain(n)
    assert math.prod(chain) == n
    assert all(r in radix.KERNEL_RADICES for r in chain)
    assert list(chain) == sorted(chain, reverse=True)
    assert len(chain) <= radix.MAX_PASSES
    # the odd part is the greedy factorization's; the power of two takes the
    # fewest passes of radix <= 16, spread evenly
    greedy = factors.factorize_supported_radices(n)
    assert [r for r in chain if r % 2] == [r for r in greedy if r % 2]
    two = [r for r in chain if r % 2 == 0]
    a = sum(r.bit_length() - 1 for r in two)
    assert len(two) == -(-a // 4) and (not two or max(two) <= 2 * min(two))
    radix.radix_chain.cache_clear()
    assert radix.radix_chain(n) == chain            # deterministic


def test_radix_chain_examples_and_refusals():
    assert radix.KERNEL_RADICES == factors.SUPPORTED_RADICES + (16,)
    assert radix.radix_chain(16384) == (16, 16, 8, 8)
    assert radix.radix_chain(1024) == (16, 8, 8)
    assert radix.radix_chain(256) == (16, 16)
    assert radix.radix_chain(32) == (8, 4)
    assert radix.radix_chain(2310) == (11, 7, 5, 3, 2)
    assert radix.radix_chain(1352) == (13, 13, 8)
    assert radix.radix_chain(16) == (16,)
    for bad in (1, 17, 34):
        with pytest.raises(ValueError):
            radix.radix_chain(bad)
    with pytest.raises(ValueError, match="do not multiply"):
        radix.chain_twiddles(16, "forward", (4, 2))
    with pytest.raises(ValueError, match="do not multiply"):
        radix.radix_chain_reference(torch.zeros(1, 16, 2), (8, 4), {})


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [6, 360, 1024, 2310, 16384])
def test_roots_table_is_float64_rounded_once(n, direction):
    """Every root within 1 ulp of f32 of the float64 value (in fact the
    nearest f32), and exact at the quarter turns."""
    got = radix.roots_table(n, direction)
    assert got.shape == (n, 2) and got.dtype == np.float32
    sign = -1.0 if direction == "forward" else 1.0
    ang = sign * 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    want = np.stack([np.cos(ang), np.sin(ang)], -1)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp)
    assert got[0, 0] == 1.0 and got[0, 1] == 0.0


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [6, 16, 360, 1024, 1352, 2310])
def test_chain_twiddles_are_the_roots_in_pass_order(n, direction):
    chain = radix.radix_chain(n)
    tw = radix.chain_twiddles(n, direction, chain)
    roots = radix.roots_table(n, direction)
    assert tw.shape == (n, 2) and tw.dtype == np.float32
    ns = 1
    seen = 0
    for r_p in chain:
        for r in range(1, r_p):
            for k in range(ns):
                e = ns - 1 + (r - 1) * ns + k
                assert np.array_equal(tw[e], roots[r * k * (n // (ns * r_p))]), (r_p, r, k)
                seen += 1
        ns *= r_p
    assert seen == n - 1 and np.array_equal(tw[n - 1], [1.0, 0.0])


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_sub_line_table_is_the_head_of_the_line_table(direction):
    """For every length K1 accepts whose chain has two passes or more, with
    C its last radix and M = N / C: the table of the chain without its last
    radix, at M points, equals the first M - 1 entries of the N-point table
    (so a line split at its last radix runs its sub-lines on the tables the
    kernels read already) bit for bit, except at entries whose exact value
    is 0: ``roots_table`` rounds 2 * pi * j in float64 before it divides by
    N, so cos and sin of a multiple of pi / 2 come out as a residue below
    2e-15 that differs between N and M.  The next (C - 1) * M entries are
    W_N^(q * j), q in [1, C), j in [0, M), as the N-point roots table holds
    them, bit for bit."""
    checked = residues = 0
    for n in range(4, radix.MAX_LENGTH + 1):
        if not fused.choose_split(n):
            continue
        chain = radix.radix_chain(n)
        if len(chain) < 2:
            continue
        c = chain[-1]
        m = n // c
        full = radix.chain_twiddles(n, direction, chain)
        head = radix.chain_twiddles(m, direction, chain[:-1])[:m - 1]
        zero = np.abs(head) < 1e-14
        assert np.array_equal(head[~zero], full[:m - 1][~zero]), n
        assert np.abs(head[zero] - full[:m - 1][zero]).max(initial=0.0) < 2e-15, n
        residues += int((head[zero] != full[:m - 1][zero]).sum())
        q, j = np.meshgrid(np.arange(1, c), np.arange(m), indexing="ij")
        roots = radix.roots_table(n, direction)
        assert np.array_equal(full[m - 1:n - 1], roots[(q * j).reshape(-1)]), n
        checked += 1
    assert checked == 821 and 0 < residues < 1000


@pytest.mark.parametrize("direction,sign", [("forward", -1.0), ("inverse", 1.0)])
def test_chain_consts_hold_scale_and_sign(direction, sign):
    c = radix.chain_consts(360, direction, 1.0 / 360, "ax")
    assert set(c) == {"ax/cw", "ax/cp"}
    assert c["ax/cp"].dtype == np.float32
    assert np.array_equal(c["ax/cp"], np.array([1.0 / 360, sign], np.float32))
    assert fused.TABLE_NAMES[-2:] == fused_cols.TABLE_NAMES[-2:] == radix.TABLE_NAMES
