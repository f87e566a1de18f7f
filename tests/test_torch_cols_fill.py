"""K2's rule and its fixed design, on the CPU.

K2 (``csrc/fused_cols.cu``) launches what its rule picks for a (pre, H,
cols) view (``csrc/cols.cuh``, ``cols_rule``; ``fused_cols.cols_rule`` is
the same rule in Python): the direct design, the ring, or an entry of the
fixed design (``csrc/cols_fixed.cuh``: a kernel per height, tile and
cluster size, the chain fixed at compile time), which can split a tile of
tc columns over a thread-block cluster of C CTAs: CTA c holds rows c, c + C,
..., runs every pass but the last on them in its own shared memory, and the
last pass reads point r of each butterfly from CTA r mod C through
distributed shared memory.  None of that changes the function, so the plain
version stays the reference.  Here:

- the rule takes, at every view of the sweep on the H100, the variant the
  sweep measured fastest (or one within 2 % of it), and gives each view
  that left the card half idle a full wave of CTAs on 132 SMs, or a
  cluster, with tiles of 4 columns or more, save the two views where the
  sweep measured fewer CTAs faster;
- ``fixed_cols_model``, a numpy model of the fixed design's index maps
  (which CTA of a cluster owns which rows, the padded shared layout, the
  passes that fuse consecutive entries of radix_chain into one butterfly
  and their twiddles from the unchanged table, the exchange step across
  the cluster, the ragged share of the last pass and the ragged last
  tile), against ``numpy.fft`` and against the JAX package's kernel (the
  Pallas call in interpret mode, as its own tests run it), forward and
  adjoint, at H in {256, 360, 2310, 2048} over 33 and 65 columns and pre 1
  to 3, and every kernel of the design (the rule's entries and the probes'
  variants) against ``numpy.fft``; the Python tables against the C
  sources;
- K2's wrapper and the fixed design's probe on CPU tensors (the plain
  version).

Tolerance: 1e-5 * max|expected|.  tests/test_torch_cuda.py holds the
kernels to the plain version on the card and the C rule to this one.
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpufft_tpu.core import fused_cols as jcols
from webgpufft_tpu.spec import TuningSpec
from webgpufft_tpu_torch.core import fused_cols, radix
from webgpufft_tpu_torch.probes import variants

BIG_VMEM = TuningSpec(vmem_limit_bytes=256 << 20)
SMS = 132
# (pre, H, cols) -> (design, tile, cluster) that K2's rule takes at the
# views of the sweep on the H100 (chip_probes/k2_fill_variants.py, PERF.md
# section 6): the fastest variant measured there, or one within 2 % of
# it where one entry serves a height's range of views ((16, 256, 1024)
# fixed 16 0.0270 ms, the rule's 32 0.0274; (32, 128, 512) 16 0.0101, the
# rule's 32 0.0103; (64, 512, 512) 16 0.0977, the rule's 8 0.0998), and the
# direct design where no variant beat it by more than that ((8, 9, 256):
# left on its own tile)
SWEEP_CHOICE = {(3, 2310, 33): ("fixed", 1, 1), (8, 16384, 32): ("fixed", 4, 8),
                (4, 1352, 65): ("fixed", 4, 4), (1, 1024, 1024): ("fixed", 8, 1),
                (5, 2048, 33): ("fixed", 8, 4), (64, 360, 256): ("fixed", 16, 1),
                (64, 1024, 33): ("fixed", 8, 1), (2, 2048, 33): ("fixed", 4, 4),
                (2, 4096, 33): ("fixed", 4, 8), (2, 8192, 33): ("fixed", 4, 8),
                (2, 16384, 33): ("fixed", 8, 8), (8, 16384, 64): ("fixed", 4, 8),
                (16, 4096, 32): ("fixed", 4, 8), (8, 1024, 1024): ("fixed", 8, 1),
                (8, 2048, 512): ("fixed", 8, 4), (64, 512, 512): ("fixed", 8, 1),
                (16, 256, 1024): ("fixed", 32, 1), (32, 128, 512): ("fixed", 32, 1),
                (256, 256, 256): ("fixed", 32, 1), (1, 256, 65536): ("fixed", 32, 1),
                (384, 256, 256): ("fixed", 32, 1), (768, 256, 256): ("fixed", 32, 1),
                (3, 256, 256): ("fixed", 8, 1), (384, 128, 256): ("fixed", 32, 1),
                (64, 64, 64): ("fixed", 16, 1), (8, 512, 512): ("fixed", 8, 1),
                (3, 128, 65536): ("fixed", 32, 1), (6, 128, 65536): ("fixed", 32, 1),
                (256, 16, 256): ("direct", 32, 1), (8, 3, 256): ("direct", 32, 1),
                (8, 9, 256): ("direct", 16, 1)}
# the views that lost to cuFFT; of them the sweep ran two fastest below a
# full wave without a cluster: (1, 1024, 1024) on 128 CTAs of 8 columns
# (0.0085 ms; 4-column tiles on 256 CTAs 0.0092, a cluster of 2 0.0095) and
# (3, 2310, 33) on 99 CTAs of one column (0.0110 ms; 4-column tiles split
# over a cluster of 2, 0.0123)
LOSERS = [(3, 2310, 33), (8, 16384, 32), (4, 1352, 65), (1, 1024, 1024), (5, 2048, 33),
          (64, 360, 256), (64, 1024, 33)]
BELOW_A_WAVE = {(1, 1024, 1024), (3, 2310, 33)}
def _tables(consts):
    return {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in consts.items()}


def _complex(x):
    return x[..., 0::2] + 1j * x[..., 1::2]


def _interleaved(z):
    out = np.empty(z.shape[:-1] + (2 * z.shape[-1],), np.float32)
    out[..., 0::2], out[..., 1::2] = z.real, z.imag
    return out


def _padded(i):
    return i + (i >> 4)


def _stage_points(points):
    return (points + points // 16 + 15) // 16 * 16


def _dft(v, s):
    """DFT_R over axis 0 of v (R, ...), sign s."""
    r = v.shape[0]
    w = np.exp(s * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    return np.tensordot(w, v, axes=(1, 0))


def _twiddle(tw, group, ns, k):
    """W_{ns R}^{r k} for r in [1, R) of a pass of the radices ``group``
    (consecutive entries of radix_chain) from the chain's table: the product
    over the entries of their own table entries, at the digits of r."""
    big = math.prod(group)
    out = []
    for r in range(1, big):
        w = np.ones(k.shape, complex)
        rem, base, lvl = r, big, ns
        for g in group:
            base //= g
            d, rem = divmod(rem, base)
            if d and ns > 1:
                w = w * tw[lvl - 1 + (d - 1) * lvl + k]
            lvl *= g
        out.append(w)
    return np.stack(out)


def fixed_cols_model(x, tables, passes, tile, cluster=1, adjoint=False):
    """K2's fixed design on (pre, H, 2 * cols) float32 ``x``, CTA by CTA with
    the kernel's index maps (``csrc/cols_fixed.cuh``): tile t of a pre
    index; CTA ``rank`` of its cluster loads rows rank + C * pos of the
    tile's columns (zeros past the view's edge), runs ``passes`` (groups of
    consecutive entries of ``radix_chain(H)``, each one butterfly) on its
    H / C rows in its padded shared layout, and, for C > 1, its share of the
    last pass (radix_chain's last entry) reading every CTA's shared memory
    and storing rows j + r * M.  Returns a new array."""
    pre, h, lanes = x.shape
    cols = lanes // 2
    chain = radix.radix_chain(h)
    c_ = cluster
    flat = [r for g in passes for r in g]
    assert flat == list(chain[:len(flat)]) and h % c_ == 0
    last = chain[-1] if c_ > 1 else 0
    assert (c_ == 1 and len(flat) == len(chain)) or (last % c_ == 0 and
                                                     len(flat) == len(chain) - 1)
    tw = tables["cw"].numpy()
    tw = tw[:, 0] + 1j * tw[:, 1]
    scale, s = float(tables["cp"][0]), float(tables["cp"][1])
    z = _complex(x.astype(np.float64))
    if adjoint:
        z = z.conj()
    out = np.zeros_like(z)
    nloc = h // c_
    tiles = -(-cols // tile)
    for p in range(pre):
        for t in range(tiles):
            col0 = t * tile
            left = min(cols - col0, tile)
            smem = []
            for rank in range(c_):
                sm = np.full(_stage_points(nloc * tile), np.nan, complex)
                ns = 1
                for i, g in enumerate(passes):
                    r_ = math.prod(g)
                    mm = nloc // r_
                    b = np.arange(mm * tile)
                    u, j = b % tile, b // tile
                    k = j % ns
                    pos = j[None, :] + np.arange(r_)[:, None] * mm
                    if i == 0:
                        rows = rank + c_ * pos
                        v = np.where((u < left)[None, :],
                                     z[p, rows, np.minimum(col0 + u, cols - 1)[None, :]], 0)
                    else:
                        v = sm[_padded(pos * tile + u[None, :])]
                        v = np.concatenate([v[:1], v[1:] * _twiddle(tw, g, ns, k)])
                    v = _dft(v, s)
                    j0 = (j - k) * r_ + k
                    dst = j0[None, :] + np.arange(r_)[:, None] * ns
                    if c_ == 1 and i == len(passes) - 1:
                        live = u < left
                        out[p, dst[:, live], (col0 + u[live])[None, :]] = v[:, live] * scale
                    else:
                        sm[_padded(dst * tile + u[None, :])] = v
                    ns *= r_
                smem.append(sm)
            if c_ == 1:
                continue
            m = h // last
            share = -(-m // c_)
            for rank in range(c_):
                b = np.arange(share * tile)
                u, j = b % tile, rank * share + b // tile
                keep = j < m
                u, j = u[keep], j[keep]
                r = np.arange(last)[:, None]
                v = np.stack([smem[rr % c_][_padded(((rr // c_) * m + j) * tile + u)]
                              for rr in range(last)])
                w = tw[(m - 1) + (r[1:] - 1) * m + j[None, :]]
                v = np.concatenate([v[:1], v[1:] * w])
                v = _dft(v, s) * scale
                live = u < left
                rows = j[None, :] + r * m
                out[p, rows[:, live], (col0 + u[live])[None, :]] = v[:, live]
    if adjoint:
        out = out.conj()
    return _interleaved(out)


def _jax_cols(x, direction, scale, adjoint):
    """The JAX package's K2 (Pallas, interpret mode on the CPU)."""
    pre, h, lanes = x.shape
    consts = {}
    fn = jcols.build_fused_cols(pre, h, lanes, direction, scale, consts, "p", BIG_VMEM)
    jx = _interleaved(_complex(x).conj()) if adjoint else x
    want = np.asarray(fn(jnp.asarray(jx), {k: jnp.asarray(v) for k, v in consts.items()}))
    return _interleaved(_complex(want).conj()) if adjoint else want


def _numpy_cols(x, direction, scale, adjoint):
    z = _complex(x.astype(np.float64))
    if adjoint:
        z = z.conj()
    y = (np.fft.fft(z, axis=1) if direction == "forward"
         else np.fft.ifft(z, axis=1) * z.shape[1]) * scale
    return _interleaved(y.conj() if adjoint else y)


# ---- the rule -------------------------------------------------------------------

@pytest.mark.parametrize("view", sorted(SWEEP_CHOICE))
def test_rule_takes_the_sweeps_fastest_variant(view):
    launch = fused_cols.cols_rule(*view, SMS)
    assert (launch.design, launch.tile, launch.cluster) == SWEEP_CHOICE[view]


@pytest.mark.parametrize("pre,h,cols", LOSERS)
def test_rule_fills_the_card_at_the_views_that_left_it_idle(pre, h, cols):
    """A full wave of CTAs on 132 SMs, or a cluster, in tiles of 4 columns
    or more, save the two views where the sweep measured fewer CTAs faster;
    there more tiles than the ring design's launch (27 and 128 of them)."""
    launch = fused_cols.cols_rule(pre, h, cols, SMS)
    assert launch.units == pre * -(-cols // launch.tile)
    assert launch.grid == launch.units * launch.cluster
    if (pre, h, cols) in BELOW_A_WAVE:
        assert launch.cluster == 1 and launch.grid < SMS
        return
    assert launch.tile >= 4, launch
    assert launch.grid >= SMS or launch.cluster > 1, launch


@pytest.mark.parametrize("pre,h,cols", [(1, 1024, 1024), (8, 16384, 32), (2, 16384, 33),
                                        (64, 360, 256), (1, 2, 1), (3, 14641, 33),
                                        (8, 16384, 64), (1 << 20, 1024, 33)])
def test_rule_is_a_launch_that_exists(pre, h, cols):
    launch = fused_cols.cols_rule(pre, h, cols, SMS)
    chain = radix.radix_chain(h)
    if launch.design == "general":
        entry = next(g for g in fused_cols.GENERAL_COLS if g.h == h and g.least <= pre * cols
                     <= g.most)
        assert (launch.tile, launch.cluster, launch.threads) == (
            entry.tile, 1, fused_cols.general_cols_threads(h, entry.chain, entry.points,
                                                           entry.tile))
        assert launch.grid == launch.units == pre * -(-cols // entry.tile)
        return
    if launch.design == "cluster":
        entry = next(g for g in fused_cols.CLUSTER_COLS if g.h == h and g.least <= pre * cols
                     <= g.most)
        assert (launch.tile, launch.cluster, launch.threads) == (
            entry.tile, entry.clusters,
            radix.cluster_plan(h, entry.chain, entry.points, entry.tile, entry.clusters)[0])
        assert launch.grid == launch.units * entry.clusters == \
            pre * -(-cols // entry.tile) * entry.clusters
        return
    if launch.design == "fixed":
        entry = next(f for f in fused_cols.FIXED_COLS if f.h == h and f.least <= pre * cols
                     <= f.most)
        assert (launch.tile, launch.cluster, launch.threads) == (entry.tile, entry.cluster,
                                                                 entry.threads)
        assert entry.chain == chain and launch.grid == launch.units * launch.cluster
        assert fused_cols._stage_points(h // entry.cluster * entry.tile) * 8 <= \
            fused_cols.SHARED_BYTES
        return
    plan = fused_cols._plan(chain, h, pre, cols, launch.design, launch.tile)
    assert plan is not None and plan._replace(grid=launch.grid) == launch
    assert launch.grid == (min(launch.units, SMS) if launch.design == "ring" else launch.units)


def test_rule_refuses_what_no_design_runs():
    for pre, h, cols, sms in [(0, 1024, 8, SMS), (2, 1024, 0, SMS), (2, 1024, 8, 0)]:
        with pytest.raises(ValueError, match="no design runs"):
            fused_cols.cols_rule(pre, h, cols, sms)


def test_fixed_entries_cover_disjoint_ranges_on_radix_chain():
    for f in fused_cols.FIXED_COLS:
        assert f.chain == radix.radix_chain(f.h)
        assert f.cluster == 1 or (f.cross == radix.radix_chain(f.h)[-1] and
                                  f.cross % f.cluster == 0 and f.cluster in (2, 4, 8))
        assert 1 <= f.least <= f.most and f.tile & (f.tile - 1) == 0
        for g in fused_cols.FIXED_COLS:
            if g is not f and g.h == f.h:
                assert g.most < f.least or f.most < g.least


# ---- the general design's table -----------------------------------------------

GENERAL_HEIGHTS = sorted({g.h for g in fused_cols.GENERAL_COLS})


def _fewest_passes(h):
    """The fewest radices of ``radix.GENERAL_RADICES`` (two at least) whose
    product is h, or None past four."""
    level = {h}
    for passes in range(1, 5):
        level = {q // r for q in level for r in radix.GENERAL_RADICES if q % r == 0}
        if passes >= 2 and 1 in level:
            return passes
    return None


@pytest.mark.parametrize("h", GENERAL_HEIGHTS)
def test_general_design_chain_for_every_height_of_its_table(h):
    """Every height of ``GENERAL_COLS``: one chain for all its entries (the
    one ``cols_chain`` gives and ``cw`` is laid out for) that multiplies to
    H in two to four passes, the fewest those radices allow, each radix
    within its entry's class; entries whose column ranges cover every view
    once, each a shape the design runs (``general_cols_threads``), which
    the rule gives the views of its range; no fixed entry at H."""
    entries = [g for g in fused_cols.GENERAL_COLS if g.h == h]
    chain = entries[0].chain
    assert fused_cols.cols_chain(h) == chain and all(g.chain == chain for g in entries)
    assert math.prod(chain) == h and 2 <= len(chain) <= 4 and len(chain) == _fewest_passes(h)
    assert h not in {f.h for f in fused_cols.FIXED_COLS}
    spans = sorted((g.least, g.most) for g in entries)
    assert spans[0][0] == 1 and spans[-1][1] == fused_cols.ALL_COLUMNS
    assert all(a[1] + 1 == b[0] for a, b in zip(spans, spans[1:]))
    for g in entries:
        least, _ = radix.GENERAL_CLASSES[g.points]
        assert all(r in radix.GENERAL_RADICES and least <= r <= g.points for r in chain), g
        threads = fused_cols.general_cols_threads(h, chain, g.points, g.tile)
        assert threads is not None and g.tile & (g.tile - 1) == 0, g
        for total in {g.least, min(g.most, 1 << 20)}:
            launch = fused_cols.cols_rule(1, h, total, SMS)
            assert launch == fused_cols.ColsLaunch("general", g.tile, 1, -(-total // g.tile),
                                                   -(-total // g.tile), threads), (g, total)


def test_general_table_is_the_c_header():
    """K2's general design has one table, ``WGFFT_GENERAL_COLS`` of
    csrc/cols_general.cuh, which the C rule compiles and ``fused_cols``
    reads: ``GENERAL_COLS`` is that text's entries, parsed here again; the
    reader takes any layout of the macro (an empty one, kAllColumns, lines
    continued); the design's limits in C are the Python copy's."""
    text = fused_cols.GENERAL_HEADER.read_text()
    body = text.split("#define WGFFT_GENERAL_COLS(X)", 1)[1].split("\n\n", 1)[0]
    rows = re.findall(r"X\((\d+), (\d+), (\d+|kAllColumns), (\d+), (\d+), ([\d, ]+)\)", body)
    assert len(rows) == len(fused_cols.GENERAL_COLS) == body.count("X(")
    for row, g in zip(rows, fused_cols.GENERAL_COLS):
        most = fused_cols.ALL_COLUMNS if row[2] == "kAllColumns" else int(row[2])
        assert (int(row[0]), int(row[1]), most, int(row[3]), int(row[4])) == g[:5]
        assert tuple(int(r) for r in row[5].split(",")) == g.chain
    assert fused_cols.read_general_cols("#define WGFFT_GENERAL_COLS(X)\n\nstruct") == ()
    two = ("#define WGFFT_GENERAL_COLS(X) \\\n  X(1080, 1, 128, 16, 2, 12, 10, 9) \\\n"
           "  X(1080, 129, kAllColumns, 24, 8, 12, 10, 9)\n")
    assert fused_cols.read_general_cols(two) == (
        fused_cols.GeneralCols(1080, 1, 128, 16, 2, (12, 10, 9)),
        fused_cols.GeneralCols(1080, 129, fused_cols.ALL_COLUMNS, 24, 8, (12, 10, 9)))
    assert re.search(r"constexpr int kMaxTile = (\d+);", text).group(1) == \
        str(fused_cols.GENERAL_MAX_TILE)
    assert "constexpr int kMaxShared = 227 * 1024;" in text
    assert fused_cols.GENERAL_MAX_SHARED == 227 * 1024


@pytest.mark.parametrize("h", GENERAL_HEIGHTS)
def test_general_design_model_at_every_height_of_its_table(h, rng, assert_close):
    """The kernel's pass schedule on ``cols_chain(h)`` with the ``cw`` of
    ``cols_consts`` (``fused_cols_chain_reference``) at every height of the
    general design, against numpy, forward and adjoint, on 3 columns."""
    x = rng.standard_normal((1, h, 6)).astype(np.float32)
    t = _tables(fused_cols.cols_consts(h, "forward", 1.0, "p"))
    for adjoint in (False, True):
        got = fused_cols.fused_cols_chain_reference(torch.from_numpy(x), t, adjoint).numpy()
        assert_close(got, _numpy_cols(x, "forward", 1.0, adjoint),
                     label=f"general H={h} {fused_cols.cols_chain(h)} adj={adjoint}")


def test_probes_read_radix_chain_tables_at_the_general_heights(rng):
    """The direct design, the ring and the fixed design run ``radix_chain``
    at every height: ``direct_tables`` lays ``cw`` out for it anew where
    ``cols_chain`` moved it (bit for bit the table ``radix.chain_consts``
    gives that chain) and is the tables themselves elsewhere."""
    for h in GENERAL_HEIGHTS[:3] + [256, 1024]:
        for direction in ("forward", "inverse"):
            t = _tables(fused_cols.cols_consts(h, direction, 0.5, "p"))
            d = fused_cols.direct_tables(t, h)
            if fused_cols.cols_chain(h) == radix.radix_chain(h):
                assert d is t
                continue
            want = radix.chain_consts(h, direction, 0.5, "p", radix.radix_chain(h))["p/cw"]
            assert np.array_equal(d["cw"].numpy(), want) and d["cp"] is t["cp"]
            assert not np.array_equal(t["cw"].numpy(), want)


# ---- the fixed design's index maps ---------------------------------------------

# (H, passes, tile, cluster): a cluster split at each height that has one,
# every composite chain of the sweep, and a tile at each column count
MODEL_CASES = [(256, ((16,),), 4, 8), (256, ((16,), (16,)), 16, 1),
               (360, ((8,), (5, 3), (3,)), 16, 1), (360, ((8,), (5,), (3, 3)), 8, 1),
               (2310, ((11,), (7,), (5, 3, 2)), 2, 1), (2310, ((11,), (7,), (5, 3)), 4, 2),
               (2048, ((16,), (16,)), 4, 8), (2048, ((16,), (16,), (8,)), 2, 1)]


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("cols", [33, 65])
@pytest.mark.parametrize("case", range(len(MODEL_CASES)))
def test_fixed_model_matches_jax_and_numpy(case, cols, adjoint, rng, assert_close):
    h, passes, tile, cluster = MODEL_CASES[case]
    pre = 1 + (case + cols) % 3
    direction, scale = ("inverse", 1.0 / h) if adjoint else ("forward", 1.0)
    x = rng.standard_normal((pre, h, 2 * cols)).astype(np.float32)
    t = _tables(fused_cols.cols_consts(h, direction, scale, "p"))
    got = fixed_cols_model(x, t, passes, tile, cluster, adjoint)
    label = f"model H={h} {passes} tile={tile} C={cluster} pre={pre} cols={cols} adj={adjoint}"
    assert_close(got, _numpy_cols(x, direction, scale, adjoint), label=label + " numpy")
    assert_close(got, _jax_cols(x, direction, scale, adjoint), label=label + " jax")


def _fixed_configs():
    out = {f"probe {k}": (v.h, v.passes, v.tile, v.cluster)
           for k, v in variants.FIXED_VARIANTS.items()}
    for i, f in enumerate(fused_cols.FIXED_COLS):
        out[f"rule {i}"] = (f.h, f.passes, f.tile, f.cluster)
    return out


@pytest.mark.parametrize("name", sorted(_fixed_configs()))
def test_every_fixed_kernel_matches_numpy(name, rng, assert_close):
    """Every kernel of the fixed design (the rule's entries and the
    probes' variants) as the model runs it, on a ragged last tile."""
    h, passes, tile, cluster = _fixed_configs()[name]
    cols = tile + 1 if tile > 1 else 3
    x = rng.standard_normal((2, h, 2 * cols)).astype(np.float32)
    t = _tables(fused_cols.cols_consts(h, "forward", 1.0, "p"))
    got = fixed_cols_model(x, t, passes, tile, cluster)
    assert np.isfinite(got).all()
    assert_close(got, _numpy_cols(x, "forward", 1.0, False), label=name)


def test_fixed_tables_match_the_c_sources():
    """The probes' FIXED_VARIANTS, the rule's FIXED_COLS, kFixedCols and the
    two switches of the C sources list the same kernels in the same order."""
    csrc = pathlib.Path(fused_cols.__file__).resolve().parent.parent / "csrc"
    case = re.compile(r"WGFFT_FIXED\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (.*?)\);")

    def switch(path):
        out = []
        for i, h, tc, t, minb, c, rx, ps in case.findall(path.read_text()):
            passes = tuple(tuple(int(r) for r in g.split(","))
                           for g in re.findall(r"Pass<([\d, ]+)>", ps))
            out.append((int(i), int(h), int(tc), int(t), int(minb), int(c), int(rx), passes))
        return out

    probe = switch(csrc / "probes" / "cols_fixed_variants.cu")
    assert [p[0] for p in probe] == list(range(len(variants.FIXED_VARIANTS)))
    for row, v in zip(probe, variants.FIXED_VARIANTS.values()):
        assert row[1:] == (v.h, v.tile, v.threads, v.minb, v.cluster, v.cross, v.passes)
    assert re.search(r"constexpr long long kAllColumns = 1LL << 40;",
                     (csrc / "cols_fixed.cuh").read_text()) and fused_cols.ALL_COLUMNS == 1 << 40
    core = switch(csrc / "cols_fixed.cu")
    assert [p[0] for p in core] == list(range(len(fused_cols.FIXED_COLS)))
    table = re.findall(r"\{(\d+), (\d+), (\d+), (\d+), (\d+), (\w+), (\d+), \{([\d, ]+)\}\}",
                       (csrc / "cols_fixed.cuh").read_text())
    assert len(table) == len(fused_cols.FIXED_COLS)
    for row, entry, f in zip(core, table, fused_cols.FIXED_COLS):
        chain = tuple(int(r) for r in entry[7].split(","))
        assert chain == f.chain == radix.radix_chain(f.h) and int(entry[6]) == len(chain)
        assert (int(entry[0]), int(entry[1]), int(entry[2]), int(entry[3]), int(entry[4])) == \
            (f.h, f.tile, f.cluster, f.threads, f.least)
        assert (f.most == fused_cols.ALL_COLUMNS if entry[5] == "kAllColumns"
                else f.most == int(entry[5]))
        assert (row[1], row[2], row[3], row[5]) == (f.h, f.tile, f.threads, f.cluster)
        flat = tuple(r for g in row[7] for r in g) + ((row[6],) if f.cluster > 1 else ())
        assert flat == f.chain and row[7] == f.passes and row[6] == f.cross


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("cols", [33, 65])
@pytest.mark.parametrize("pre", [1, 3])
def test_360_and_its_direct_chain(pre, cols, adjoint, rng, assert_close):
    """360 = 8 * 5 * 3 * 3: the direct design's chain (radix_chain) as the
    kernels' pass schedule, against numpy and the JAX package."""
    h = 360
    x = rng.standard_normal((pre, h, 2 * cols)).astype(np.float32)
    t = _tables(fused_cols.cols_consts(h, "forward", 1.0, "p"))
    got = fused_cols.fused_cols_chain_reference(torch.from_numpy(x), t, adjoint).numpy()
    assert_close(got, _numpy_cols(x, "forward", 1.0, adjoint), label="360 numpy")
    assert_close(got, _jax_cols(x, "forward", 1.0, adjoint), label="360 jax")


# ---- K2's wrapper and the fixed probe on CPU tensors ---------------------------------

@pytest.mark.parametrize("h,pre,cols", [(1024, 2, 33), (2310, 1, 65), (2048, 3, 33)])
def test_wrapper_and_fixed_probe_run_the_plain_version_on_the_cpu(h, pre, cols, rng,
                                                                    assert_close):
    x = rng.standard_normal((pre, h, 2 * cols)).astype(np.float32)
    t = _tables(fused_cols.cols_consts(h, "forward", 1.0, "p"))
    name = next(k for k, v in variants.FIXED_VARIANTS.items() if v.h == h)
    before = (fused_cols.fused_cols.launches, variants.cols_fixed_variant.launches)
    got = fused_cols.fused_cols(torch.from_numpy(x), t)
    probe = variants.cols_fixed_variant(torch.from_numpy(x), t, name)
    inplace = torch.from_numpy(x.copy())
    variants.cols_fixed_variant(inplace, t, name, inplace=True)
    assert (fused_cols.fused_cols.launches, variants.cols_fixed_variant.launches) == before
    want = _jax_cols(x, "forward", 1.0, False)
    assert_close(got.numpy(), want, label=f"K2 H={h}")
    assert_close(probe.numpy(), want, label=f"K2 fixed probe {name}")
    assert_close(inplace.numpy(), want, label=f"K2 fixed probe in place {name}")
    with pytest.raises(ValueError, match="runs H ="):
        variants.cols_fixed_variant(torch.zeros(1, h + 1, 8), t, name)
