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
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from webgpufft_tpu_torch.core import fused, fused_cols, radix
from webgpufft_tpu_torch.utils import factors
from webgpufft_tpu_torch.utils.mathref import normalize_scale

# lengths of the general design's table: the four of 128 points or less
# it takes, the facade's 1080, 1200 and 1920, 5-smooth 2000, three- and
# four-pass odd ones (3^7, 7^4) and a long one
GENERAL_SAMPLE = [96, 108, 120, 128, 1080, 1200, 1920, 2000, 2187, 2401, 12000]
# squares, non-squares, every radix, both shared-memory extremes, and the
# warp design's lengths
LENGTHS = [1024, 2048, 360, 1000, 2310, 1352, 4096, 16384, 16, 6, 121, 32, 8192, 256, 512]
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


def _packed_layouts(n):
    """(lanes a line, 16-byte copies) of every layout the packed design can
    give length n: one lane a line, and where the chain has two passes or
    more 2, 4 and 8 lanes a line (csrc/lines_packed.cuh)."""
    lanes = (1,) if len(radix.radix_chain(n)) == 1 else (1, 2, 4, 8)
    return [(lane, wide) for lane in lanes for wide in (True, False)]


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("normalize", ["none", "backward", "unitary"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [32, 256, 512, 1024, 2048, 4096, 8192, 16384]
                         + sorted(radix.MIXED_LINES) + sorted(radix.PACKED_LINES)
                         + [n for n in GENERAL_SAMPLE if n in radix.GENERAL_LINES])
def test_lines_model_of_each_design_matches_plain_and_numpy(n, direction, normalize, adjoint,
                                                            rng, assert_close):
    """K1's pass schedule in the chain its rule gives the length (the
    power-of-two design's own at 256, 8192 and 16384, the direct design's
    chain at 32, 512, 1024, 2048 and 4096, the mixed-radix design's
    composite radices at every length of ``MIXED_LINES``, the general
    design's at the lengths of ``GENERAL_SAMPLE``), forward, inverse
    and adjoint, against the plain version and numpy in float64.  At the
    lengths of ``PACKED_LINES`` the model is the packed design's block-staged
    one (``radix.packed_lines_reference``: line u, point p of a warp's block
    landed at u * P + p, the last block ragged, the padding and the dead
    lines NaN) in every layout the design can take (``_packed_layouts``),
    on 37 lines, which leaves the last block of every layout ragged."""
    scale = normalize_scale(normalize, direction, n)
    packed = n in radix.PACKED_LINES
    lines = 37 if packed else 2
    x = rng.standard_normal((lines, n, 2)).astype(np.float32)
    tables = _tables(fused.lines_consts(n, direction, scale, "p"))
    z = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    if adjoint:   # the conjugate transpose: conj(F conj z)
        want = np.conj(_numpy_fft(np.conj(z), direction, scale, 1))
    else:
        want = _numpy_fft(z, direction, scale, 1)
    plain = fused.fused_lines_reference(torch.from_numpy(x), tables, adjoint).numpy()
    if packed:
        chain = radix.lines_chain(n)
        models = {layout: radix.packed_lines_reference(torch.from_numpy(x), chain, tables,
                                                       adjoint, *layout)
                  for layout in _packed_layouts(n)}
    else:
        models = {"chain": fused.fused_lines_chain_reference(torch.from_numpy(x), tables,
                                                              adjoint)}
    for layout, got in models.items():
        assert got.shape == (lines, n, 2) and got.dtype == torch.float32
        assert torch.isfinite(got).all(), layout   # no padding or dead line reached y
        assert_close(got.numpy(), plain,
                     label=f"K1 model {layout} vs plain n={n} adjoint={adjoint}")
        assert_close(got.numpy(), np.stack([want.real, want.imag], -1),
                     label=f"K1 model {layout} vs numpy n={n} {direction} {normalize} "
                           f"adjoint={adjoint}")


_CASES = [(d, nz, a) for d in ("forward", "inverse") for nz in ("none", "backward", "unitary")
          for a in (False, True)]


@pytest.mark.parametrize("n", sorted(radix.GENERAL_LINES))
def test_general_design_model_at_every_length_of_its_table(n, rng, assert_close):
    """The general design's chain at every length of its table, in the CPU
    model of the kernels' pass schedule (``radix_chain_reference`` on
    ``lines_chain(n)`` and its ``cw`` table) on two lines, against the plain
    version and numpy in float64; the lengths take the twelve cases of
    direction, norm and adjoint in turn (``GENERAL_SAMPLE`` takes all
    twelve in the test above)."""
    direction, normalize, adjoint = _CASES[sorted(radix.GENERAL_LINES).index(n) % len(_CASES)]
    scale = normalize_scale(normalize, direction, n)
    x = rng.standard_normal((2, n, 2)).astype(np.float32)
    tables = _tables(fused.lines_consts(n, direction, scale, "p"))
    got = radix.radix_chain_reference(torch.from_numpy(x), radix.lines_chain(n), tables, adjoint)
    z = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    if adjoint:
        want = np.conj(_numpy_fft(np.conj(z), direction, scale, 1))
    else:
        want = _numpy_fft(z, direction, scale, 1)
    assert_close(got.numpy(), fused.fused_lines_reference(torch.from_numpy(x), tables,
                                                          adjoint).numpy(),
                 label=f"K1 general model vs plain n={n}")
    assert_close(got.numpy(), np.stack([want.real, want.imag], -1),
                 label=f"K1 general model vs numpy n={n} {direction} {normalize} "
                       f"adjoint={adjoint}")


@pytest.mark.parametrize("n", sorted(radix.PACKED_LINES))
def test_packed_layout_keeps_copies_whole_and_lines_apart(n):
    """The packed design's stage layout (``radix.packed_pitch``, the
    ``Shape::P`` of csrc/lines_packed.cuh) in every layout the design can
    give n: odd n at pitch n (no radix is even, the block contiguous, so a
    16-byte copy may straddle two lines); even n at a pitch that holds the
    line's exchanges, 2 mod 4 with one lane a line and lanes mod 2 lanes
    otherwise, so that no 16-byte copy (points 2c, 2c + 1) splits a line
    and every one lands 16-byte aligned; the points of a block land on
    distinct places inside their own line's stretch."""
    chain = radix.lines_chain(n)
    for lanes, _ in _packed_layouts(n):
        pitch = radix.packed_pitch(n, chain, lanes)
        block = 32 // lanes
        assert pitch >= n
        if n % 2:
            assert pitch == n
        else:
            modulus, want = (4, 2) if lanes == 1 else (2 * lanes, lanes)
            assert pitch % modulus == want and pitch < n + n // 2 + modulus
        q = np.arange(block * n)
        at = (q // n) * pitch + q % n
        assert len(set(at.tolist())) == block * n
        assert np.all(at // pitch == q // n)             # inside its own line's stretch
        if n % 2 == 0:
            pair = q[::2]
            assert np.all(at[pair + 1] == at[pair] + 1) and np.all(at[pair] % 2 == 0)


@pytest.mark.parametrize("n", [n for n in ELIGIBLE if fused.choose_split(n)])
def test_k1_rule_for_every_eligible_length(n):
    """K1's rule: the powers of two 256 and 2^10 .. 2^14 run the
    power-of-two design on three passes, 1024, 2048 and 4096 on
    ``radix_chain``'s own chain (their ``cw`` unchanged), 8192 and 16384 on a
    chain that starts with a radix-32 pass where ``radix_chain`` takes four,
    256 on 8 * 8 * 4 where ``radix_chain`` takes 16 * 16; 32 and 512 run the
    warp design on ``radix_chain``'s own chain; the lengths of
    ``MIXED_LINES``, none a power of two, run the mixed-radix design on two
    to four passes of radices up to 32, each a radix the kernels or the
    composite butterflies have, in no more passes than ``radix_chain``; the
    lengths of ``PACKED_LINES``, all of 128 points or less, run the packed
    design on ``radix_chain`` (its ``cw`` unchanged) and may run in place at
    every chain; the lengths of ``GENERAL_LINES`` run the general design on
    two to four passes of ``GENERAL_RADICES`` (next test); the lengths of
    ``CLUSTER_LINES``, all from 11583, run the cluster design on two to four
    passes of ``GENERAL_RADICES``, in place, the first radix at least twice
    the cluster size (tests/test_torch_cluster.py); every other length runs
    the direct design on ``radix_chain``, in place only at two passes or
    more.  No length is in two tables.  K2 keeps ``radix_chain``."""
    chain = radix.lines_chain(n)
    assert set(radix.POW2_LINES) == {256, 1024, 2048, 4096, 8192, 16384}
    assert set(radix.WARP_LINES) == {512}
    tables = (radix.POW2_LINES, radix.WARP_LINES, radix.MIXED_LINES, radix.PACKED_LINES,
              radix.GENERAL_LINES, radix.CLUSTER_LINES)
    assert sum(n in t for t in tables) <= 1
    assert math.prod(chain) == n
    assert radix.lines_in_place(n) == (n in radix.PACKED_LINES or len(chain) > 1)
    if n in radix.POW2_LINES:
        assert radix.lines_design(n) == "pow2" and chain == radix.POW2_LINES[n]
        assert len(chain) == 3 and math.prod(chain) == n
        if n == 256:
            assert chain == (8, 8, 4) and radix.radix_chain(n) == (16, 16)
        elif n < 8192:
            assert chain == radix.radix_chain(n)
        else:
            assert len(radix.radix_chain(n)) == 4 and chain[0] == 32
            assert all(r in (16, 32) for r in chain)
    elif n in radix.WARP_LINES:
        assert radix.lines_design(n) == "warp" and chain == radix.WARP_LINES[n]
        assert chain == radix.radix_chain(n)
    elif n in radix.MIXED_LINES:
        assert radix.lines_design(n) == "mixed" and chain == radix.MIXED_LINES[n]
        assert n & (n - 1) and 2 <= len(chain) <= 4 and max(chain) <= 32
        assert all(r in radix.KERNEL_RADICES + radix.MIXED_RADICES + (32,) for r in chain)
        assert len(chain) <= len(radix.radix_chain(n))
    elif n in radix.PACKED_LINES:
        assert radix.lines_design(n) == "packed" and chain == radix.PACKED_LINES[n]
        assert n <= 128 and chain == radix.radix_chain(n) and radix.lines_in_place(n)
    elif n in radix.GENERAL_LINES:
        assert radix.lines_design(n) == "general" and chain == radix.GENERAL_LINES[n].chain
        assert radix.lines_in_place(n)
    elif n in radix.CLUSTER_LINES:
        line = radix.CLUSTER_LINES[n]
        assert radix.lines_design(n) == "cluster" and chain == line.chain and n >= 11583
        assert 2 <= len(chain) <= 4 and all(r in radix.GENERAL_RADICES for r in chain)
        assert chain[0] >= 2 * line.clusters and radix.lines_in_place(n)
    else:
        assert radix.lines_design(n) == "direct" and chain == radix.radix_chain(n)


def _fewest_passes(n):
    """The fewest passes of ``radix.GENERAL_RADICES`` whose product is n."""
    reach = {1: 0}
    for passes in range(1, 5):
        reach = {p * r: passes for p in reach for r in radix.GENERAL_RADICES
                 if n % (p * r) == 0} | reach
        if n in reach:
            return reach[n]
    return None


@pytest.mark.parametrize("n", sorted(radix.GENERAL_LINES))
def test_general_design_chain_for_every_length_of_its_table(n):
    """Every entry of the general design's table: a chain of two to four
    radices of ``GENERAL_RADICES`` (up to 32, primes 2 .. 13) whose product
    is n, in the fewest passes those radices allow (fewer than
    ``radix_chain``'s wherever that takes more than two); a class of
    points a thread (``GENERAL_CLASSES``: 16, 20, 24, 32, 64) whose radices
    (2 .. 16, 4 .. 20, 4 .. 24, 5 .. 32, 16 .. 32) hold its chain, and lines a CTA whose threads fit
    the class (``general_threads``, the C ``make_plan``'s count); its shared
    memory (two buffers, one for two passes, of ``lines`` lines at the
    longest padded exchange: ``general_shared``) within a CTA's 227 KB.
    The table takes lengths from 96 points on, each eligible for K1 and in
    no other design's table."""
    points, lines, chain = radix.GENERAL_LINES[n]
    assert fused.choose_split(n) and n >= 96
    assert 2 <= len(chain) <= 4 and math.prod(chain) == n
    assert all(r in radix.GENERAL_RADICES for r in chain)
    assert len(chain) == _fewest_passes(n)
    assert len(chain) <= len(radix.radix_chain(n))
    least, most = radix.GENERAL_CLASSES[points]
    assert least <= min(chain) and max(chain) <= points and lines >= 1
    threads = radix.general_threads(n, chain, points, lines)
    assert threads is not None and threads <= most
    pitch, ns = n, 1
    for r in chain[:-1]:
        if r % 2 == 0:
            pitch = max(pitch, n + (n - 1) // (ns * r))
        ns *= r
    buffers = 2 if len(chain) > 2 else 1
    assert radix.general_shared(n, chain, lines) == buffers * lines * pitch * 8 <= 227 * 1024
    assert not any(n in t for t in (radix.POW2_LINES, radix.WARP_LINES, radix.MIXED_LINES,
                                    radix.PACKED_LINES))


def _c_rule(name):
    """{n: chain} of the table ``name`` of csrc/lines.cuh; for
    ``kPackedLines`` {n: (lanes, stages, chain)} of ``WGFFT_PACKED_LINES``,
    the list it is made from; for ``kGeneralLines`` {n: (points, lines,
    chain)} of ``WGFFT_GENERAL_LINES``."""
    text = (Path(fused.__file__).parent.parent / "csrc" / "lines.cuh").read_text()
    if name == "kGeneralLines":
        body = re.search(r"#define WGFFT_GENERAL_LINES\(X\)((?:.*\\\n)*.*)", text).group(1)
        return {int(n): (int(points), int(lines), tuple(int(r) for r in chain.split(",")))
                for n, points, lines, chain in re.findall(
                    r"X\((\d+), (\d+), (\d+), ([\d, ]+)\)", body)}
    if name == "kPackedLines":
        body = re.search(r"#define WGFFT_PACKED_LINES\(X\)((?:.*\\\n)*.*)", text).group(1)
        return {int(n): (int(lanes), int(stages), tuple(int(r) for r in chain.split(",")))
                for n, lanes, stages, chain in re.findall(r"X\((\d+), (\d+), (\d+), ([\d, ]+)\)",
                                                          body)}
    body = re.search(r"constexpr LinesRule " + name + r"\[\] = \{(.*?)\};", text, re.S).group(1)
    return {int(n): tuple(int(r) for r in radices.split(","))
            for n, count, radices in re.findall(r"\{(\d+), (\d+), \{([\d, ]+)\}\}", body)}


@pytest.mark.parametrize("name,table", [("kPow2Lines", radix.POW2_LINES),
                                        ("kWarpLines", radix.WARP_LINES),
                                        ("kMixedLines", radix.MIXED_LINES),
                                        ("kPackedLines", radix.PACKED_LINES),
                                        ("kGeneralLines", radix.GENERAL_LINES)])
def test_k1_tables_match_the_c_sources(name, table):
    """Each table of K1's rule in csrc/lines.cuh equals its copy in
    core/radix.py, length by length and chain by chain.  The packed
    design's table is one list, ``WGFFT_PACKED_LINES``, from which both
    ``kPackedLines`` and the design's launch switch are made; each entry's
    shape is one the kernel template takes (a power of two of lanes a line
    up to 8, several only where the chain has two passes or more; one or
    two stages).  The general design's table is one list too,
    ``WGFFT_GENERAL_LINES``, each entry N, points a thread, lines a CTA and
    chain, equal to ``GENERAL_LINES``.  (On the card the entry point's report
    holds the rule itself to ``radix.lines_design``.)"""
    rule = _c_rule(name)
    if name == "kGeneralLines":
        assert rule == {n: tuple(line) for n, line in table.items()}
        return
    if name == "kPackedLines":
        assert len(rule) == len(table)
        for n, (lanes, stages, chain) in rule.items():
            assert lanes in (1, 2, 4, 8) and (lanes == 1 or len(chain) > 1), n
            assert stages in (1, 2), n
        rule = {n: chain for n, (_, _, chain) in rule.items()}
    assert rule == dict(table)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", sorted(radix.POW2_LINES) + sorted(radix.WARP_LINES)
                         + sorted(radix.MIXED_LINES) + sorted(radix.PACKED_LINES)
                         + [n for n in GENERAL_SAMPLE if n in radix.GENERAL_LINES])
def test_moved_lengths_table_is_float64_roots_in_pass_order(n, direction):
    """The ``cw`` table K1 reads at a length of the power-of-two, the warp,
    the mixed-radix, the packed or the general design: laid out for
    ``lines_chain(n)`` (entry ns - 1 + (r - 1) * ns + k is W^(r * k * n / (ns * R))), each root
    within 1 ulp of f32 of float64; the direct design's table where the
    chains agree (32, 512, 1024, 2048, 4096 and every length of the packed
    design), another table where they do not (256, 8192, 16384, every
    length of the mixed-radix design and every one of the general design
    whose chain is not ``radix_chain``'s)."""
    chain = radix.lines_chain(n)
    tw = fused.lines_consts(n, direction, 1.0, "p")["p/cw"]
    assert tw.shape == (n, 2) and tw.dtype == np.float32
    sign = -1.0 if direction == "forward" else 1.0
    index = np.zeros(n, dtype=np.int64)
    ns = 1
    for r_p in chain:
        r, k = np.meshgrid(np.arange(1, r_p), np.arange(ns), indexing="ij")
        index[ns - 1:ns * r_p - 1] = (r * k * (n // (ns * r_p))).reshape(-1)
        ns *= r_p
    ang = sign * 2.0 * np.pi * index / n
    want = np.stack([np.cos(ang), np.sin(ang)], -1)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(tw.astype(np.float64) - want) <= ulp)
    assert np.array_equal(tw[n - 1], [1.0, 0.0])
    direct = radix.chain_twiddles(n, direction, radix.radix_chain(n))
    assert np.array_equal(tw, direct) == (chain == radix.radix_chain(n))


@pytest.mark.parametrize("s", [-1.0, 1.0])
@pytest.mark.parametrize("r", radix.MIXED_RADICES)
def test_composite_butterfly_is_the_dft(r, s, rng):
    """The model of the mixed-radix design's composite butterflies
    (``Dft<R>`` of ``csrc/lines_mixed.cuh``: R = A * B, B DFTs of A points,
    rotations by float32 constants, A DFTs of B points) against the R-point
    DFT with sign s in float64."""
    z = rng.standard_normal((3, r)) + 1j * rng.standard_normal((3, r))
    v = [torch.from_numpy(np.stack([z[:, k].real, z[:, k].imag], -1).astype(np.float32))
         for k in range(r)]
    got = torch.stack(radix._butterfly(v, s), dim=1).numpy()
    assert radix._BUTTERFLIES[r] is radix._butterfly_composite
    want = z @ np.exp(s * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    err = np.abs(got[..., 0] + 1j * got[..., 1] - want).max()
    assert err <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("s", [-1.0, 1.0])
def test_butterfly32_is_the_32_point_dft(s, rng):
    """The model of ``Butterfly<32>`` (2 x 16, rotations by float32
    constants) against the 32-point DFT with sign s in float64."""
    z = rng.standard_normal((3, 32)) + 1j * rng.standard_normal((3, 32))
    v = [torch.from_numpy(np.stack([z[:, r].real, z[:, r].imag], -1).astype(np.float32))
         for r in range(32)]
    got = torch.stack(radix._butterfly32(v, s), dim=1).numpy()
    w = np.exp(s * 2j * np.pi * np.outer(np.arange(32), np.arange(32)) / 32)
    want = z @ w
    err = np.abs(got[..., 0] + 1j * got[..., 1] - want).max()
    assert err <= 1e-5 * np.abs(want).max()


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
