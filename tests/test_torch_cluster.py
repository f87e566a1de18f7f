"""K1's and K2's cluster design on the CPU: its schedule, its tables, its rule.

The CUDA kernel (``webgpufft_tpu_torch/csrc/cluster.cuh``) splits a line
(K1) or a tile of columns (K2) of the lengths from 11583 over a
thread-block cluster: the first pass across the cluster, each output sent
to the CTA that owns its residue class, the later passes on each CTA's own
classes.  ``radix.cluster_chain_reference`` is that schedule in plain
torch (the same classes, index maps, ``cw`` entries and butterflies); here
it is held to ``numpy.fft`` at every length of the two tables, forward,
inverse and adjoint, to the JAX package's K1 and K2 (Pallas in interpret
mode) at 16000 samples, and to ``radix_chain_reference`` bit for bit; so is
its schedule in the kernel built for two CTAs an SM (``ctas`` = 2: one
exchange buffer of ``radix.cluster_pitch`` rows, the middle passes in
place), at every K1 length, whichever kernel its table entry names.
Tolerance: 1e-5 * max|expected| (conftest._assert_close).  The kernel
itself is held to the plain versions on the card by tests/test_torch_cuda.py.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpufft_tpu.core import fused as jfused
from webgpufft_tpu.core import fused_cols as jcols
from webgpufft_tpu.spec import TuningSpec
from webgpufft_tpu_torch.core import fused, fused_cols, radix
from webgpufft_tpu_torch.utils.mathref import normalize_scale

BIG_VMEM = TuningSpec(vmem_limit_bytes=256 << 20)
LENGTHS = sorted(radix.CLUSTER_LINES)
HEIGHTS = sorted({g.h for g in fused_cols.CLUSTER_COLS})
# forward, inverse, and the adjoint launch of the forward tables
MODES = [("forward", False), ("inverse", False), ("forward", True)]


def _tables(consts):
    return {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in consts.items()}


def _numpy_ref(z, direction, adjoint, scale, axis):
    """scale * F z (F^H z for the adjoint, conj(F conj z)) along ``axis``."""
    if adjoint:
        z = np.conj(z)
    n = z.shape[axis]
    y = np.fft.fft(z, axis=axis) if direction == "forward" else np.fft.ifft(z, axis=axis) * n
    y = y * scale
    return np.conj(y) if adjoint else y


@pytest.mark.parametrize("direction,adjoint", MODES)
@pytest.mark.parametrize("n", LENGTHS)
def test_k1_cluster_schedule_matches_numpy(n, direction, adjoint, rng, assert_close):
    """K1 at every length of its cluster table: the schedule the kernel runs
    (``fused.fused_lines_chain_reference``, which takes the table's chain,
    class split and ``cw``) on three lines against ``numpy.fft``, unitary
    scale."""
    line = radix.CLUSTER_LINES[n]
    assert radix.lines_design(n) == "cluster" and radix.lines_chain(n) == line.chain
    scale = 1.0 / math.sqrt(n)
    x = rng.standard_normal((3, n, 2)).astype(np.float32)
    got = fused.fused_lines_chain_reference(
        torch.from_numpy(x), _tables(fused.lines_consts(n, direction, scale, "p")), adjoint)
    want = _numpy_ref(x[..., 0] + 1j * x[..., 1], direction, adjoint, scale, 1)
    assert_close(got.numpy(), np.stack([want.real, want.imag], -1).astype(np.float32),
                 label=f"K1 cluster n={n} {line} {direction} adjoint={adjoint}")


@pytest.mark.parametrize("direction,adjoint", MODES)
@pytest.mark.parametrize("h", HEIGHTS)
def test_k2_cluster_schedule_matches_numpy(h, direction, adjoint, rng, assert_close):
    """K2 at every height of its cluster table: the schedule the kernel runs
    (``fused_cols.fused_cols_chain_reference``: the chain and the class
    split of the view's entry, the ``cw`` of ``cols_consts``) down three
    columns of two pre indices against ``numpy.fft``."""
    assert fused_cols.cols_rule(2, h, 3).design == "cluster"
    scale = 1.0 / h if direction == "inverse" else 1.0
    x = rng.standard_normal((2, h, 6)).astype(np.float32)
    got = fused_cols.fused_cols_chain_reference(
        torch.from_numpy(x), _tables(fused_cols.cols_consts(h, direction, scale, "p")), adjoint)
    z = x[..., 0::2] + 1j * x[..., 1::2]
    want = _numpy_ref(z, direction, adjoint, scale, 1)
    flat = np.stack([want.real, want.imag], -1).reshape(2, h, 6).astype(np.float32)
    assert_close(got.numpy(), flat, label=f"K2 cluster h={h} {direction} adjoint={adjoint}")


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_k1_cluster_schedule_matches_jax_at_16000(direction, adjoint, rng, assert_close):
    """16 s at 1 ms, trace-major: the cluster schedule at N = 16000 against
    the JAX package's K1 (``build_fused_lines``, interpret mode) on the same
    numpy input, unitary scale; the adjoint as conj(F conj x)."""
    n, lines = 16000, 3
    assert radix.lines_design(n) == "cluster"
    scale = normalize_scale("unitary", direction, n)
    x = rng.standard_normal((lines, n, 2)).astype(np.float32)
    consts = {}
    fn = jfused.build_fused_lines(n, lines, direction, TuningSpec(), consts, scale, prefix="p")
    run = lambda v: np.asarray(fn(jnp.asarray(v), {k: jnp.asarray(c) for k, c in consts.items()}))
    flip = np.array([1, -1], np.float32)
    want = run(x * flip) * flip if adjoint else run(x)
    got = fused.fused_lines_chain_reference(
        torch.from_numpy(x), _tables(fused.lines_consts(n, direction, scale, "p")), adjoint)
    assert_close(got.numpy(), want, label=f"K1 cluster 16000 {direction} adjoint={adjoint}")


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_k2_cluster_schedule_matches_jax_at_16000(direction, adjoint, rng, assert_close):
    """16 s at 1 ms, time-major: the cluster schedule at H = 16000 against the
    JAX package's K2 (``build_fused_cols``, interpret mode) on the same
    numpy input; the adjoint as conj(F conj x)."""
    h, pre, lanes = 16000, 2, 8
    assert fused_cols.cols_rule(pre, h, lanes // 2).design == "cluster"
    scale = 1.0 / h if direction == "inverse" else 1.0
    x = rng.standard_normal((pre, h, lanes)).astype(np.float32)
    consts = {}
    fn = jcols.build_fused_cols(pre, h, lanes, direction, scale, consts, "p", BIG_VMEM)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    if adjoint:
        conj = x.copy()
        conj[..., 1::2] *= -1
        want = np.asarray(fn(jnp.asarray(conj), jc)).copy()
        want[..., 1::2] *= -1
    else:
        want = np.asarray(fn(jnp.asarray(x), jc))
    got = fused_cols.fused_cols_chain_reference(
        torch.from_numpy(x), _tables(fused_cols.cols_consts(h, direction, scale, "p")), adjoint)
    assert_close(got.numpy(), want, label=f"K2 cluster 16000 {direction} adjoint={adjoint}")


@pytest.mark.parametrize("n,clusters", [(n, c) for n in LENGTHS for c in radix.CLUSTER_SIZES
                                        if radix.CLUSTER_LINES[n].chain[0] >= 2 * c])
def test_cluster_schedule_is_the_pass_schedule(n, clusters):
    """Split over any cluster its first radix holds (two classes a CTA at
    least), the schedule gives the chain's own Stockham result bit for bit
    (``radix_chain_reference``): the class split moves no arithmetic, it
    only says which CTA does it."""
    chain = radix.CLUSTER_LINES[n].chain
    tables = _tables(radix.chain_consts(n, "forward", 1.0, "p", chain))
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((1, n, 2)).astype(np.float32))
    assert torch.equal(radix.cluster_chain_reference(x, chain, clusters, tables),
                       radix.radix_chain_reference(x, chain, tables))


def _c_table(name):
    """The X-macro table ``name`` of csrc/cluster.cuh, parsed here apart
    from ``radix.read_table``: every X(...) between the #define and the
    first line that does not continue it."""
    lines = iter(radix.CLUSTER_HEADER.read_text().splitlines())
    for line in lines:
        if line.startswith(f"#define {name}(X)"):
            break
    body = []
    for line in lines:
        body.append(line)
        if not line.rstrip().endswith("\\"):
            break
    return [tuple(radix.ALL_COLUMNS if a.strip() == "kAllColumns" else int(a)
                  for a in args.split(","))
            for args in re.findall(r"X\(([^)]*)\)", " ".join(body))]


def test_cluster_tables_are_the_c_header():
    """One copy of each table: ``WGFFT_CLUSTER_LINES`` and
    ``WGFFT_CLUSTER_COLS`` of csrc/cluster.cuh, which the C rules compile,
    are what ``radix.CLUSTER_LINES`` and ``fused_cols.CLUSTER_COLS`` hold.
    Every entry is a shape the kernel takes (``radix.cluster_plan``, the C
    ``make_plan``); K2's entries of a height share one chain (its ``cw``)
    and cover every column count; the lengths start at 11583."""
    lines = _c_table("WGFFT_CLUSTER_LINES")
    assert {e[0]: radix.ClusterLine(e[1], e[2], e[3], e[4:]) for e in lines} == \
        radix.CLUSTER_LINES
    assert len(lines) == len(radix.CLUSTER_LINES) and min(radix.CLUSTER_LINES) >= 11583
    for n, line in radix.CLUSTER_LINES.items():
        assert line.ctas in radix.CLUSTER_CTAS, n
        assert radix.cluster_plan(n, line.chain, line.points, 1, line.clusters, line.ctas), n
        assert n not in radix.GENERAL_LINES and radix.lines_in_place(n)
    cols = _c_table("WGFFT_CLUSTER_COLS")
    assert tuple(fused_cols.ClusterCols(*e[:6], e[6:]) for e in cols) == fused_cols.CLUSTER_COLS
    for h in HEIGHTS:
        entries = sorted((g for g in fused_cols.CLUSTER_COLS if g.h == h), key=lambda g: g.least)
        assert len({g.chain for g in entries}) == 1 and fused_cols.cols_chain(h) == entries[0].chain
        assert entries[0].least == 1 and entries[-1].most == radix.ALL_COLUMNS
        assert all(a.most + 1 == b.least for a, b in zip(entries, entries[1:]))
        assert h >= 11583 and h not in {g.h for g in fused_cols.GENERAL_COLS + fused_cols.FIXED_COLS}
        for g in entries:
            assert radix.cluster_plan(h, g.chain, g.points, g.tile, g.clusters), g


@pytest.mark.parametrize("h", HEIGHTS)
def test_k2_rule_gives_the_cluster_entry(h):
    """K2's rule at a height of the cluster table: the entry whose range
    holds the view's columns in all, C CTAs a tile, the grid the units
    times C, the threads of ``radix.cluster_plan``."""
    for pre, cols in ((2, 33), (1, 4200), (8, 64)):
        g = next(g for g in fused_cols.CLUSTER_COLS
                 if g.h == h and g.least <= pre * cols <= g.most)
        launch = fused_cols.cols_rule(pre, h, cols)
        units = pre * -(-cols // g.tile)
        threads = radix.cluster_plan(h, g.chain, g.points, g.tile, g.clusters)[0]
        assert launch == fused_cols.ColsLaunch("cluster", g.tile, g.clusters, units,
                                               units * g.clusters, threads)


def test_cluster_plan_refuses_what_the_kernel_does_not_run():
    """``radix.cluster_plan`` (the C ``make_plan``) refuses a first radix
    under twice the cluster, a cluster size or class without a kernel, a
    chain that does not multiply to h, a tile that is no power of two and a
    CTA over 227 KB; it sizes a CTA of 16000 = 32 * 25 * 20 over 2 CTAs at
    8000 points (16 classes of 500) in two buffers, a point of padding in
    every 16 after the first pass (and 4000 points, one in every 8, over 4
    CTAs); the widest pass sets the threads (400 butterflies of radix 20 at
    one a thread)."""
    assert radix.cluster_plan(16000, (32, 25, 20), 32, 1, 2) == (400, 2 * (8000 + 499) * 8)
    assert radix.cluster_plan(16000, (32, 25, 20), 32, 1, 4) == (200, 2 * (4000 + 499) * 8)
    assert radix.cluster_plan(14641, (11, 11, 11, 11), 24, 1, 8) is None   # 11 < 16
    assert radix.cluster_plan(16000, (32, 25, 20), 32, 1, 16) is None
    assert radix.cluster_plan(16000, (32, 25, 20), 16, 1, 2) is None
    assert radix.cluster_plan(16000, (32, 25, 21), 32, 1, 2) is None
    assert radix.cluster_plan(16000, (32, 25, 20), 32, 3, 2) is None
    assert radix.cluster_plan(16000, (32, 25, 20), 32, 8, 2) is None       # 2 * 8000 * 8 * 8


@pytest.mark.parametrize("direction,adjoint", MODES)
@pytest.mark.parametrize("n", LENGTHS)
def test_k1_one_buffer_schedule_matches_numpy(n, direction, adjoint, rng, assert_close):
    """The kernel built for two CTAs an SM at every length of K1's cluster
    table, on the entry's chain and cluster size: the first pass lands each
    CTA's classes in its one buffer (NaN elsewhere), each middle pass reads
    all of its points before it writes its outputs over them, the last reads
    the buffer (``radix.cluster_chain_reference(..., ctas=2)``); on three
    lines against ``numpy.fft``, unitary scale, forward, inverse and
    adjoint."""
    line = radix.CLUSTER_LINES[n]
    scale = 1.0 / math.sqrt(n)
    x = rng.standard_normal((3, n, 2)).astype(np.float32)
    got = radix.cluster_chain_reference(
        torch.from_numpy(x), line.chain, line.clusters,
        _tables(fused.lines_consts(n, direction, scale, "p")), adjoint, ctas=2)
    want = _numpy_ref(x[..., 0] + 1j * x[..., 1], direction, adjoint, scale, 1)
    assert not torch.isnan(got).any()
    assert_close(got.numpy(), np.stack([want.real, want.imag], -1).astype(np.float32),
                 label=f"K1 one-buffer n={n} {line} {direction} adjoint={adjoint}")


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_k1_one_buffer_schedule_matches_jax_at_16000(direction, adjoint, rng, assert_close):
    """16 s at 1 ms, trace-major, in the kernel of one exchange buffer: the
    schedule at N = 16000 (32 * 25 * 20 over 2 CTAs, the radix-25 pass in
    place) against the JAX package's K1 (``build_fused_lines``, interpret
    mode) on the same numpy input, unitary scale; the adjoint as
    conj(F conj x)."""
    n, lines = 16000, 3
    scale = normalize_scale("unitary", direction, n)
    x = rng.standard_normal((lines, n, 2)).astype(np.float32)
    consts = {}
    fn = jfused.build_fused_lines(n, lines, direction, TuningSpec(), consts, scale, prefix="p")
    run = lambda v: np.asarray(fn(jnp.asarray(v), {k: jnp.asarray(c) for k, c in consts.items()}))
    flip = np.array([1, -1], np.float32)
    want = run(x * flip) * flip if adjoint else run(x)
    chain = radix.lines_chain(n)
    got = radix.cluster_chain_reference(
        torch.from_numpy(x), chain, 2, _tables(fused.lines_consts(n, direction, scale, "p")),
        adjoint, ctas=2)
    assert_close(got.numpy(), want, label=f"K1 one-buffer 16000 {direction} adjoint={adjoint}")


@pytest.mark.parametrize("n,clusters", [(n, c) for n in LENGTHS for c in radix.CLUSTER_SIZES
                                        if radix.CLUSTER_LINES[n].chain[0] >= 2 * c])
def test_one_buffer_schedule_is_the_pass_schedule(n, clusters):
    """Through one buffer, the middle passes in place, the schedule gives
    the chain's own Stockham result bit for bit, as the two buffers do: the
    buffer moves no arithmetic."""
    chain = radix.CLUSTER_LINES[n].chain
    tables = _tables(radix.chain_consts(n, "forward", 1.0, "p", chain))
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((1, n, 2)).astype(np.float32))
    assert torch.equal(radix.cluster_chain_reference(x, chain, clusters, tables, ctas=2),
                       radix.radix_chain_reference(x, chain, tables))


# registers a thread of each class (ptxas at the classes' __launch_bounds__:
# the kernel of two CTAs an SM has half the threads at the same registers)
CLASS_REGISTERS = {24: 128, 32: 128, 64: 184}


@pytest.mark.parametrize("n", LENGTHS)
def test_one_buffer_plan_holds_two_ctas_an_sm(n):
    """``radix.cluster_plan`` (the C ``make_plan``) of every two-CTA variant
    the sweep tries at a length (``probes.variants.cluster_candidates``):
    one exchange buffer of ``radix.cluster_pitch`` rows, under half of the
    228 KB an SM has, and threads times the class's registers within half
    of the SM's 65,536; the table's entry is such a shape where it names two
    CTAs an SM."""
    from webgpufft_tpu_torch.probes import variants
    cands = variants.cluster_candidates(n, (1,), (2,))
    line = radix.CLUSTER_LINES[n]
    if line.ctas == 2:
        assert any((c, e, clusters) == (line.chain, line.points, line.clusters)
                   for _, c, e, _, clusters, _ in cands)
    for name, chain, points, tile, clusters, ctas in cands:
        assert ctas == 2 and tile == 1
        threads, smem = radix.cluster_plan(n, chain, points, 1, clusters, 2)
        assert smem == radix.cluster_pitch(n, chain, clusters) * 8, name
        assert 2 * smem <= 228 << 10, name
        assert threads * CLASS_REGISTERS[points] <= 32768, name
        assert threads <= radix.CLUSTER_CTAS[2][points] == radix.CLUSTER_CLASSES[points] // 2


def test_one_buffer_plan_at_16000():
    """16000 = 32 * 25 * 20 over 2 CTAs in the 64-point class: 160 threads
    (400 butterflies of radix 20 at three a thread, 320 of radix 25 at two),
    one buffer of 8000 points and a point of padding in every 16 (67,992 B:
    two CTAs fit an SM); the 32-point class needs 400 threads, over the
    256 its kernel of two CTAs an SM has; the kernel of one CTA an SM takes
    two buffers."""
    assert radix.cluster_plan(16000, (32, 25, 20), 64, 1, 2, 2) == (160, (8000 + 499) * 8)
    assert radix.cluster_plan(16000, (32, 25, 20), 32, 1, 2, 2) is None
    assert radix.cluster_plan(16000, (32, 25, 20), 64, 1, 2, 1) == (160, 2 * (8000 + 499) * 8)
    assert radix.cluster_plan(16000, (32, 25, 20), 64, 1, 2, 3) is None
    assert radix.cluster_pitch(16000, (32, 25, 20), 2) == 8000 + 499
    with pytest.raises(ValueError):
        radix.cluster_chain_reference(torch.zeros(1, 16000, 2), (32, 25, 20), 2,
                                      _tables(fused.lines_consts(16000, "forward", 1.0, "p")),
                                      ctas=3)
