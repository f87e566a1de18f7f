"""The probe kernels' host side on the CPU (``webgpufft_tpu_torch.probes``).

The probes have no counterpart inside the JAX package (theirs are the four
Pallas scripts under ``benches/``), so their plain versions are held against
numpy and against the pass-schedule model ``core/radix.py``:
``lines_stages`` at ``stop = count`` equals ``np.fft.fft`` times the scale and
at ``stop = p`` the model cut at ``p``; ``lines_planes`` equals K1's plain
version on the interleaved form; ``stream_copy`` is the copy.  Then the
argument checks a wrapper makes before it takes a raw pointer, the ctypes
signature of every entry point of both libraries against the C sources, and
an import of every script under ``chip_probes/`` and of ``chip_smoke.py`` and
``chip_profile.py`` (import only: they need a GPU to run), so that a moved
helper or a changed signature shows here.  Tolerance 1e-5 * max|expected|.
"""

import ctypes
import importlib
import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from webgpufft_tpu_torch import _build, probes
from webgpufft_tpu_torch.core import fused, radix
from webgpufft_tpu_torch.probes import planes, stages, stream

REPO = pathlib.Path(__file__).resolve().parent.parent
LENGTHS = [1024, 360, 256, 2048, 16, 6, 2310, 64]


def tables(n, direction="forward", scale=None):
    scale = 1.0 / np.sqrt(n) if scale is None else scale
    return {k.rsplit("/", 1)[1]: torch.from_numpy(v)
            for k, v in fused.lines_consts(n, direction, scale, "p").items()}


def lines(n, count=5, seed=0):
    rng = np.random.default_rng(seed + n)
    return torch.from_numpy(rng.standard_normal((count, n, 2)).astype(np.float32))


def as_complex(x):
    x = x.numpy().astype(np.float64)
    return x[..., 0] + 1j * x[..., 1]


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", LENGTHS)
def test_every_pass_is_the_fft(n, direction, assert_close):
    x, t = lines(n), tables(n, direction)
    y = probes.lines_stages(x, t, len(radix.radix_chain(n)))
    fft = np.fft.fft if direction == "forward" else lambda z, axis: np.fft.ifft(z, axis=axis) * n
    assert_close(as_complex(y), fft(as_complex(x), axis=-1) / np.sqrt(n), label=f"n={n}")
    assert_close(y.numpy(), fused.fused_lines_reference(x, t).numpy(), label=f"n={n} vs K1 plain")


@pytest.mark.parametrize("n", LENGTHS)
def test_a_cut_chain_is_the_model_cut(n, assert_close):
    """stop = p: the passes 1 .. p of the model, unscaled; stop = 0: the
    input.  Each pass is checked against an independent statement of a
    Stockham pass in numpy."""
    x, t = lines(n, count=3), tables(n, scale=0.25)
    chain = radix.radix_chain(n)
    assert torch.equal(probes.lines_stages(x, t, 0), x)
    cur, ns = as_complex(x), 1
    for p, r in enumerate(chain, start=1):
        m = n // r
        j = np.arange(m)
        k = j % ns
        v = np.stack([cur[:, j + q * m] for q in range(r)])              # (r, lines, m)
        v = v * np.exp(-2j * np.pi * np.arange(r)[:, None, None] * k / (ns * r))
        v = np.fft.fft(v, axis=0)
        nxt = np.empty_like(cur)
        for q in range(r):
            nxt[:, (j - k) * r + k + q * ns] = v[q]
        cur, ns = nxt, ns * r
        got = probes.lines_stages(x, t, p)
        want = cur * (0.25 if p == len(chain) else 1.0)
        assert_close(as_complex(got), want, label=f"n={n} stop={p}")
        assert torch.equal(got, radix.radix_chain_reference(x, chain, radix.direct_tables(t, n),
                                                            stop=p))
    assert torch.equal(got, radix.radix_chain_reference(x, chain, radix.direct_tables(t, n)))


def test_stop_outside_the_chain_is_refused():
    x, t = lines(64), tables(64)
    for stop in (-1, 3):
        with pytest.raises(ValueError, match="stop"):
            probes.lines_stages(x, t, stop)
        with pytest.raises(ValueError, match="stop"):
            radix.radix_chain_reference(x, radix.radix_chain(64), t, stop=stop)


@pytest.mark.parametrize("n", LENGTHS)
def test_planes_equal_interleaved(n, assert_close):
    x, t = lines(n), tables(n, "inverse")
    xp = torch.stack(x.unbind(-1), dim=1).contiguous()
    yp = probes.lines_planes(xp, t)
    assert tuple(yp.shape) == (5, 2, n)
    want = fused.fused_lines_reference(x, t)
    assert torch.equal(torch.stack(yp.unbind(1), dim=-1), want)
    assert_close(yp[:, 0].numpy() + 1j * yp[:, 1].numpy(),
                 np.fft.ifft(as_complex(x), axis=-1) * np.sqrt(n), label=f"planes n={n}")


@pytest.mark.parametrize("n", [8192, 16384, 256, 2079, 6144])
def test_stages_and_planes_run_the_direct_chain_where_k1_runs_another(n, assert_close):
    """At a length where K1's rule gives the power-of-two or the
    mixed-radix design a chain of its own (its ``cw`` in that order), P2
    and P3 still run the direct design's chain: they read ``cw`` rebuilt
    for ``radix_chain(n)``
    (``radix.direct_tables``), and every stop of P2 is the model of that
    chain; the whole chain and P3 equal K1's plain version."""
    x, t = lines(n, count=2), tables(n, "inverse")
    chain = radix.radix_chain(n)
    assert radix.lines_chain(n) != chain
    direct = radix.direct_tables(t, n)
    assert not torch.equal(direct["cw"], t["cw"]) and direct["cp"] is t["cp"]
    assert torch.equal(direct["cw"], torch.from_numpy(
        radix.chain_twiddles(n, "inverse", chain)))
    for stop in range(len(chain) + 1):
        assert torch.equal(probes.lines_stages(x, t, stop),
                           radix.radix_chain_reference(x, chain, direct, stop=stop))
    want = fused.fused_lines_reference(x, t)
    assert_close(probes.lines_stages(x, t, len(chain)).numpy(), want.numpy(), label=f"P2 n={n}")
    xp = torch.stack(x.unbind(-1), dim=1).contiguous()
    assert torch.equal(torch.stack(probes.lines_planes(xp, t).unbind(1), dim=-1), want)
    same = tables(2048)
    assert radix.direct_tables(same, 2048) is same


@pytest.mark.parametrize("name", sorted(probes.variants.LINES_VARIANTS))
def test_every_pow2_variant_is_its_chain(name, assert_close):
    """Each variant of K1's power-of-two and warp designs on the CPU: its
    chain's model on its own table, equal to K1's plain version forward,
    adjoint and in place; a length other than the variant's is refused.
    Its shape is one the kernel template takes: a power of two of lanes a
    line (the CTA's threads in the power-of-two design, at most a warp in
    the warp design) that splits every pass's butterflies evenly."""
    from webgpufft_tpu_torch.probes import variants
    n, design, threads, lanes, minb, chain = variants.LINES_VARIANTS[name]
    assert math.prod(chain) == n and minb >= 1 and lanes & (lanes - 1) == 0
    assert all((n // r) % lanes == 0 for r in chain)
    assert (design, lanes) in {("pow2", threads), ("warp", min(lanes, 32))}
    assert design == "pow2" or threads % 32 == 0
    x = lines(n, count=2)
    vt = variants.lines_variant_tables(name, "forward", 0.5)
    t = tables(n, "forward", 0.5)
    for adjoint in (False, True):
        assert_close(variants.lines_variant(x, vt, name, adjoint).numpy(),
                     fused.fused_lines_reference(x, t, adjoint).numpy(),
                     label=f"{name} adjoint={adjoint}")
    work = x.clone()
    assert variants.lines_variant(work, vt, name, inplace=True) is work
    assert torch.equal(work, variants.lines_variant(x, vt, name))
    with pytest.raises(ValueError, match="runs N"):
        variants.lines_variant(lines(128 if n == 64 else 64), vt, name)
    with pytest.raises(ValueError, match="variant must be"):
        variants.lines_variant(x, vt, "no such variant")


@pytest.mark.parametrize("name", sorted(probes.variants.MIXED_VARIANTS))
def test_every_mixed_variant_is_its_chain(name, assert_close):
    """Each variant of K1's mixed-radix design on the CPU: its chain's model
    on its own table, equal to K1's plain version forward, adjoint and in
    place, on a line count that leaves the last CTA ragged; a length other
    than the variant's is refused.  Its shape is one the kernel template
    takes: two passes or more of radices up to 32 that the kernels or the
    composite butterflies have, at least one line and one thread a CTA."""
    from webgpufft_tpu_torch.probes import variants
    n, per_cta, threads, minb, chain = variants.MIXED_VARIANTS[name]
    assert math.prod(chain) == n and minb >= 1 and per_cta >= 1 and threads >= 32
    assert len(chain) >= 2 and max(chain) <= 32
    assert all(r in radix.KERNEL_RADICES + radix.MIXED_RADICES + (32,) for r in chain)
    x = lines(n, count=per_cta + 1)
    vt = variants.lines_variant_tables(name, "forward", 0.5)
    t = tables(n, "forward", 0.5)
    for adjoint in (False, True):
        assert_close(variants.lines_variant(x, vt, name, adjoint).numpy(),
                     fused.fused_lines_reference(x, t, adjoint).numpy(),
                     label=f"{name} adjoint={adjoint}")
    work = x.clone()
    assert variants.lines_variant(work, vt, name, inplace=True) is work
    assert torch.equal(work, variants.lines_variant(x, vt, name))
    with pytest.raises(ValueError, match="runs N"):
        variants.lines_variant(lines(64), vt, name)
    if name.endswith("rule"):
        assert chain == radix.MIXED_LINES[n]


@pytest.mark.parametrize("name", sorted(probes.variants.PACKED_VARIANTS))
def test_every_packed_variant_is_its_chain(name, assert_close):
    """Each variant of K1's packed design on the CPU: the design's
    block-staged model (``radix.packed_lines_reference``) in the variant's
    layout on its own table, equal to K1's plain version forward, adjoint
    and in place, on a line count that leaves the last block ragged; a
    length other than the variant's is refused.  Its shape is one the
    kernel template takes: radix_chain's chain (the rule's ``cw``), a power
    of two of lanes a line up to 8, several only where the chain has two
    passes or more, one or two stages."""
    from webgpufft_tpu_torch.probes import variants
    v = variants.PACKED_VARIANTS[name]
    n, chain = v.n, v.chain
    assert chain == radix.radix_chain(n) and n <= 128 and fused.choose_split(n)
    assert v.lanes in (1, 2, 4, 8) and (v.lanes == 1 or len(chain) > 1)
    assert v.stages in (1, 2)
    x = lines(n, count=32 // v.lanes + 3)
    vt = variants.lines_variant_tables(name, "forward", 0.5)
    t = tables(n, "forward", 0.5)
    assert torch.equal(vt["cw"], t["cw"])
    for adjoint in (False, True):
        assert_close(variants.lines_variant(x, vt, name, adjoint).numpy(),
                     fused.fused_lines_reference(x, t, adjoint).numpy(),
                     label=f"{name} adjoint={adjoint}")
    work = x.clone()
    assert variants.lines_variant(work, vt, name, inplace=True) is work
    assert torch.equal(work, variants.lines_variant(x, vt, name))
    with pytest.raises(ValueError, match="runs N"):
        variants.lines_variant(lines(256), vt, name)


@pytest.mark.parametrize("n,chain,points,per_cta", [
    (96, (12, 8), 16, 21), (96, (8, 12), 32, 5), (1080, (12, 10, 9), 16, 1),
    (1080, (9, 10, 12), 32, 2), (2000, (20, 10, 10), 32, 1), (12000, (25, 24, 20), 64, 1)])
def test_general_variant_is_its_chain(n, chain, points, per_cta, assert_close):
    """The general design on a chain the caller names
    (``variants.general_variant``) on the CPU: its chain's model on its own
    table, equal to K1's plain version forward, adjoint and in place, on a
    line count that leaves the last CTA ragged; a shape the design cannot
    run is refused: a chain that does not multiply to N, one pass, a radix
    wider than the class's points, more threads than the class has."""
    from webgpufft_tpu_torch.probes import variants
    x = lines(n, count=per_cta + 1)
    vt = {k.rsplit("/", 1)[1]: torch.from_numpy(v)
          for k, v in radix.chain_consts(n, "forward", 0.5, "p", chain).items()}
    t = tables(n, "forward", 0.5)
    for adjoint in (False, True):
        assert_close(variants.general_variant(x, vt, chain, points, per_cta, adjoint).numpy(),
                     fused.fused_lines_reference(x, t, adjoint).numpy(),
                     label=f"general {chain} adjoint={adjoint}")
    work = x.clone()
    assert variants.general_variant(work, vt, chain, points, per_cta, inplace=True) is work
    assert torch.equal(work, variants.general_variant(x, vt, chain, points, per_cta))
    wide = max(chain)
    for bad in [(chain + (2,), points, per_cta), ((n,), 64, 1),
                (chain, 16 if wide > 16 else 8, per_cta), (chain, points, 1 << 12)]:
        with pytest.raises(ValueError, match="does not run"):
            variants.general_variant(x, vt, *bad)


@pytest.mark.parametrize("h,chain,points,tile", [(1080, (12, 10, 9), 24, 8),
                                                (32, (8, 4), 16, 32), (9, (3, 3), 16, 64),
                                                (2401, (7, 7, 7, 7), 16, 4)])
def test_general_cols_variant_is_its_chain(h, chain, points, tile, assert_close):
    """K2's general design on a chain the caller names
    (``variants.general_cols_variant``) on the CPU: its chain's model on its
    own table, equal to K2's plain version forward, adjoint and in place,
    over ragged columns; a shape the design cannot run is refused: a chain
    that does not multiply to H, one pass, a radix wider than the class's
    points, a tile that is no power of two or too wide for the threads."""
    from webgpufft_tpu_torch.core import fused_cols
    from webgpufft_tpu_torch.probes import variants
    gen = torch.Generator().manual_seed(h)
    x = torch.randn(2, h, 2 * (tile + 1), generator=gen)
    vt = {k.rsplit("/", 1)[1]: torch.from_numpy(v)
          for k, v in radix.chain_consts(h, "inverse", 0.5, "p", chain).items()}
    t = {k.rsplit("/", 1)[1]: torch.from_numpy(v)
         for k, v in fused_cols.cols_consts(h, "inverse", 0.5, "p").items()}
    before = (variants.general_cols_variant.launches, fused_cols.fused_cols.launches)
    for adjoint in (False, True):
        assert_close(variants.general_cols_variant(x, vt, chain, points, tile, adjoint).numpy(),
                     fused_cols.fused_cols_reference(x, t, adjoint).numpy(),
                     label=f"general cols {chain} adjoint={adjoint}")
    work = x.clone()
    assert variants.general_cols_variant(work, vt, chain, points, tile, inplace=True) is work
    assert torch.equal(work, variants.general_cols_variant(x, vt, chain, points, tile))
    assert (variants.general_cols_variant.launches, fused_cols.fused_cols.launches) == before
    for bad in [(chain + (2,), points, tile), ((h,), 64, tile), (chain, 8, tile),
                (chain, points, 3), (chain, points, 128)]:
        with pytest.raises(ValueError, match="does not run"):
            variants.general_cols_variant(x, vt, *bad)


@pytest.mark.parametrize("n", [n for n in LENGTHS if len(radix.radix_chain(n)) > 1])
def test_in_place_writes_the_input(n):
    x, t = lines(n), tables(n)
    work = x.clone()
    assert probes.lines_inplace(work, t) is work
    assert torch.equal(work, fused.fused_lines_reference(x, t))


@pytest.mark.parametrize("n", [4, 8, 16])   # the one-butterfly lengths K1 has a split for
def test_one_pass_chain_in_place_is_refused(n, monkeypatch):
    """A one-pass chain of the direct design has no barrier between its
    reads and its writes, so K1 refuses it in place; the packed design
    reads a warp's whole block before it writes it, so at a length of its
    table the same chain runs in place (next test).  Here the length is
    taken out of the packed design's table: the direct design's refusal."""
    assert len(radix.radix_chain(n)) == 1
    monkeypatch.delitem(radix.PACKED_LINES, n, raising=False)
    assert radix.lines_design(n) == "direct" and not radix.lines_in_place(n)
    with pytest.raises(ValueError, match="one-pass"):
        probes.lines_inplace(lines(n), tables(n))


@pytest.mark.parametrize("n", [n for n in (4, 8, 16) if n in radix.PACKED_LINES])
def test_one_pass_chain_in_place_runs_in_the_packed_design(n):
    assert radix.lines_design(n) == "packed" and radix.lines_in_place(n)
    x, t = lines(n), tables(n)
    work = x.clone()
    assert probes.lines_inplace(work, t) is work
    assert torch.equal(work, fused.fused_lines_reference(x, t))


@pytest.mark.parametrize("scale", [None, 1.000001, -2.5])
@pytest.mark.parametrize("kw", [{"mode": "direct"}, {"mode": "cp_async", "stages": 2},
                                {"mode": "cp_async", "stages": 4, "stage_bytes": 8192},
                                {"mode": "bulk", "stages": 2, "stage_bytes": 49152},
                                {"mode": "bulk", "stages": 4}])
def test_stream_copy_is_the_copy(kw, scale):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 48)).astype(np.float32))
    y = probes.stream_copy(x, scale, **kw)
    assert y.data_ptr() != x.data_ptr()
    want = x.numpy() if scale is None else x.numpy() * np.float32(scale)
    assert np.array_equal(y.numpy(), want)


@pytest.mark.parametrize("kw,match", [
    ({"mode": "tma"}, "mode"),
    ({"mode": "cp_async", "stages": 3}, "stages"),
    ({"mode": "bulk", "stages": 1}, "stages"),
    ({"mode": "direct", "stage_bytes": 24}, "multiple of 16"),
    ({"mode": "cp_async", "stage_bytes": 0}, "multiple of 16"),
    ({"mode": "cp_async", "stages": 4, "stage_bytes": 65536}, "shared"),     # 256 KB
    ({"mode": "bulk", "stages": 2, "stage_bytes": 116224}, "shared")])       # 227 KB + barriers
def test_stream_copy_refuses_what_the_kernel_cannot_run(kw, match):
    with pytest.raises(ValueError, match=match):
        probes.stream_copy(torch.zeros(64, 64), **kw)


def test_stream_copy_stage_limit_is_227_kb():
    assert stream.MAX_SHARED_BYTES == 227 * 1024
    x = torch.zeros(64, 64)
    probes.stream_copy(x, mode="cp_async", stages=2, stage_bytes=116224)   # exactly 227 KB
    probes.stream_copy(x, mode="bulk", stages=2, stage_bytes=116224 - 64)  # and the barriers
    assert stream.shared_bytes("direct", 2, 16384) == 0


def test_stream_copy_alignment_and_layout_checks():
    flat = torch.zeros(4100)
    with pytest.raises(ValueError, match="16-byte"):
        probes.stream_copy(flat[1:4097])             # 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="multiple of 4"):
        probes.stream_copy(flat[:4098])
    with pytest.raises(ValueError, match="contiguous"):
        probes.stream_copy(torch.zeros(64, 64).t())
    with pytest.raises(ValueError, match="float32"):
        probes.stream_copy(torch.zeros(64, 64, dtype=torch.float64))
    probes.stream_copy(flat[4:4100])                 # 16 bytes off: aligned


@pytest.mark.parametrize("call", [
    lambda: probes.lines_stages(torch.zeros(4, 64, 2).transpose(0, 1), tables(4), 0),
    lambda: probes.lines_stages(torch.zeros(4, 64, 2, dtype=torch.float64), tables(64), 0),
    lambda: probes.lines_planes(torch.zeros(4, 64, 2), tables(64)),
    lambda: probes.lines_planes(torch.zeros(2, 4, 64).transpose(0, 1), tables(64)),
    lambda: probes.lines_inplace(torch.zeros(4, 2, 64), tables(64)),
    lambda: probes.lines_inplace(torch.zeros(8, 64, 2)[::2], tables(64))])
def test_line_probes_check_layout_before_anything_else(call):
    with pytest.raises(ValueError, match="contiguous float32"):
        call()


def test_launch_counters_count_kernel_launches_only():
    """On the CPU a wrapper runs its plain version and counts nothing."""
    before = (probes.stream_copy.launches, probes.lines_stages.launches,
              probes.lines_planes.launches, fused.fused_lines.launches)
    x, t = lines(64), tables(64)
    probes.stream_copy(x)
    probes.lines_stages(x, t, 1)
    probes.lines_planes(torch.stack(x.unbind(-1), dim=1).contiguous(), t)
    probes.lines_inplace(x.clone(), t)
    assert before == (probes.stream_copy.launches, probes.lines_stages.launches,
                      probes.lines_planes.launches, fused.fused_lines.launches)


# ---- the C interface ------------------------------------------------------

C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float,
           "const int*": ctypes.POINTER(ctypes.c_int),
           "int*": ctypes.POINTER(ctypes.c_int),
           "long long*": ctypes.POINTER(ctypes.c_longlong)}
ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def declared_entry_points(which):
    """name -> ctypes argument types, read from the C sources of a library."""
    out = {}
    for src in _build.sources(which):
        for name, args in ENTRY.findall(src.read_text()):
            kinds = [" ".join(a.split()[:-1]) for a in args.replace("\n", " ").split(",")]
            out[name] = tuple(C_TYPES[k] for k in kinds)
    return out


@pytest.mark.parametrize("which", ["core", "probes"])
def test_ctypes_signatures_match_the_c_sources(which):
    declared = declared_entry_points(which)
    assert set(declared) == set(_build._SIGNATURES[which])
    for name, argtypes in declared.items():
        assert tuple(_build._SIGNATURES[which][name]) == argtypes, name
    # the error-string helper lives in each library
    text = "".join(src.read_text() for src in _build.sources(which))
    assert text.count('extern "C" const char* wgfft_error_string') == 1


def test_probe_library_is_a_second_library():
    assert {s.name for s in _build.sources("probes")} == {
        "stream_copy.cu", "lines_stages.cu", "lines_planes.cu", "tile_copy.cu",
        "cols_variants.cu", "cols_fixed_variants.cu", "lines_variants.cu",
        "lines_mixed_variants.cu", "lines_mixed_variants_long.cu", "lines_packed_variants.cu"}
    assert {s.name for s in _build.sources("core")} == {
        "fused_lines.cu", "fused_cols.cu", "cols_fixed.cu", "lines_pow2.cu", "lines_warp.cu",
        "lines_mixed.cu", "lines_packed.cu", "lines_packed_2.cu", "lines_packed_3.cu",
        "lines_packed_4.cu", "lines_general.cu", "lines_general_16.cu", "lines_general_20.cu",
        "lines_general_24.cu", "lines_general_32.cu", "lines_general_64.cu",
        "cols_general.cu", "cols_general_16.cu", "cols_general_20.cu", "cols_general_24.cu",
        "cols_general_32.cu", "cols_general_64.cu", "cluster.cu", "cluster_24.cu",
        "cluster_32.cu", "cluster_64.cu"}
    core, probe = _build.library_path("core"), _build.library_path("probes")
    assert core != probe and core.parent == probe.parent == _build.BUILD_DIR
    assert probe.name.startswith("libwgfft_probes_")


def test_probe_sources_stage_through_shared_memory_with_the_async_copies():
    text = (_build.CSRC / "probes" / "stream_copy.cu").read_text()
    code = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("//"))
    for needle in ("cp.async.cg.shared.global", "cp.async.commit_group", "cp.async.wait_group",
                   "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes",
                   "cp.async.bulk.global.shared::cta.bulk_group", "cp.async.bulk.wait_group.read",
                   "mbarrier.init", "fence.mbarrier_init", "mbarrier.try_wait.parity"):
        assert needle in code, needle
    for src in _build.sources("probes"):
        body = src.read_text()
        assert "cudaMemcpy" not in body and "cufft" not in body.lower(), src.name


def test_ring_stages_land_by_the_async_copies():
    """K2's ring design (``csrc/stage.cuh``) lands tiles by a tensor map
    where the view allows (``csrc/cols.cuh``) and by cp.async otherwise, on
    mbarriers; no source of the plans' library copies or transforms by a
    library call."""
    text = (_build.CSRC / "stage.cuh").read_text()
    code = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("//"))
    for needle in ("cp.async.ca.shared.global", "cp.async.cg.shared.global",
                   "cp.async.mbarrier.arrive.noinc", "mbarrier.arrive.expect_tx",
                   "mbarrier.try_wait.parity", "fence.mbarrier_init", "fence.proxy.async"):
        assert needle in code, needle
    tma = (_build.CSRC / "cols.cuh").read_text()
    assert "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes" in tma
    assert "cuTensorMapEncodeTiled" in tma
    for src in _build.sources("core") + _build.headers():
        body = "\n".join(line for line in src.read_text().splitlines()
                         if not line.lstrip().startswith("//"))
        assert "cudaMemcpy" not in body and "cufft" not in body.lower(), src.name
    assert '#include "stage.cuh"' in (_build.CSRC / "cols.cuh").read_text()


# ---- the scripts ----------------------------------------------------------

SCRIPTS = sorted(p.stem for p in (REPO / "chip_probes").glob("*.py"))


def test_the_probe_scripts_are_all_here():
    assert set(SCRIPTS) >= {"tile_copy", "chain_ab", "stream_copy", "k1_stages", "k1_layouts",
                            "ptxas_report", "k1_k2_ring"}


@pytest.mark.parametrize("module", [f"chip_probes.{s}" for s in SCRIPTS]
                         + ["chip_smoke", "chip_profile"])
def test_chip_script_imports(module):
    """Import only (no GPU): every name a script takes from the package or
    from another script must exist."""
    sys.path.insert(0, str(REPO))
    try:
        mod = importlib.import_module(module)
    finally:
        sys.path.remove(str(REPO))
    assert callable(mod.main)


def test_chip_scripts_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {[f'chip_probes.{s}' for s in SCRIPTS] + ['chip_smoke', 'chip_profile']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None and"
            " (m in ('jax', 'webgpufft_tpu') or m.startswith(('jax.', 'webgpufft_tpu.')))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_chain_ab_passes_the_adjoint_flag():
    """The entry points take ``adjoint`` before the stream; the script's call
    must have as many arguments as the signature declares."""
    sys.path.insert(0, str(REPO))
    try:
        chain_ab = importlib.import_module("chip_probes.chain_ab")
    finally:
        sys.path.remove(str(REPO))
    seen = {}

    class Stream:
        cuda_stream = 7

    def entry(*args):
        seen["args"] = args
        return 0

    x = torch.zeros(8, 64, 2)
    real = torch.cuda.current_stream
    torch.cuda.current_stream = lambda: Stream()
    try:
        chain_ab.run(entry, x, x, (8, 64), (8, 8), x, x)
    finally:
        torch.cuda.current_stream = real
    assert len(seen["args"]) == len(_build._SIGNATURES["core"]["wgfft_fused_lines"])
    assert seen["args"][-2:] == (0, 7)


@pytest.mark.parametrize("count", [2, 3, 4])
def test_split_parts_add_up_to_the_whole_launch(count):
    """``variants.split_parts`` reads the split probe's stops as the load
    (stop 0), each pass (the step to the next stop) and the store (the
    whole launch less stop ``count``), and the parts add up to the whole."""
    from webgpufft_tpu_torch.probes import variants
    stops = {k: 0.01 * (k + 1) ** 2 for k in range(count + 1)}
    stops[variants.STOP_ALL] = 0.5
    parts = variants.split_parts(stops, count)
    assert list(parts) == ["load", *(f"pass {p}" for p in range(count)), "store", "all"]
    assert parts["load"] == stops[0] and parts["all"] == 0.5
    assert parts["store"] == pytest.approx(0.5 - stops[count])
    assert sum(v for k, v in parts.items() if k != "all") == pytest.approx(parts["all"])


def test_split_stop_runs_on_the_card_only():
    """The split probe's ``stop`` (``cluster_variant``, ``general_cols_variant``)
    raises on a CPU tensor, which has no stopped kernel, and for a stop
    outside 0 .. count and ``STOP_ALL``; without it the CPU runs the plain
    version."""
    from webgpufft_tpu_torch.core import fused_cols
    from webgpufft_tpu_torch.probes import variants
    n = 16000
    line = radix.CLUSTER_LINES[n]
    t = {k.rsplit("/", 1)[1]: torch.as_tensor(v)
         for k, v in radix.chain_consts(n, "forward", 1.0, "p", line.chain).items()}
    x = torch.randn(1, n, 2)
    want = variants.cluster_variant(x, t, line.chain, line.points, 1, line.clusters)
    assert want.shape == x.shape
    for stop in (0, len(line.chain), variants.STOP_ALL):
        with pytest.raises(ValueError, match="CUDA tensor only"):
            variants.cluster_variant(x, t, line.chain, line.points, 1, line.clusters, stop=stop)
    with pytest.raises(ValueError, match="stop must be"):
        variants.cluster_variant(x, t, line.chain, line.points, 1, line.clusters,
                                 stop=len(line.chain) + 1)
    g = next(g for g in fused_cols.GENERAL_COLS if g.h == 1080)
    tg = {k.rsplit("/", 1)[1]: torch.as_tensor(v)
          for k, v in radix.chain_consts(1080, "forward", 1.0, "p", g.chain).items()}
    xg = torch.randn(1, 1080, 2 * g.tile)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        variants.general_cols_variant(xg, tg, g.chain, g.points, g.tile, stop=0)
    with pytest.raises(ValueError, match="stop must be"):
        variants.general_cols_variant(xg, tg, g.chain, g.points, g.tile, stop=-1)


def test_split_probe_has_a_kernel_for_every_class_of_the_tables():
    """The split kernels are instantiated in the plans' own class files,
    beside the kernel whose pass bodies they call (``cluster_<E>.cu``,
    ``cols_general_<E>.cu``; no split source compiles those bodies again):
    every class of the cluster design (``radix.CLUSTER_CLASSES``, which the
    cluster tables of K1 and K2 and the kernel of two CTAs an SM use) and of
    the general design's table has its split launch, and the entry points
    (``cluster.cu``, ``cols_general.cu``) dispatch every class."""
    from webgpufft_tpu_torch.core import fused_cols
    names = {s.name for s in _build.sources("core")}
    cluster = set(radix.CLUSTER_CLASSES)
    assert {e.points for e in radix.CLUSTER_LINES.values()} | {
        g.points for g in fused_cols.CLUSTER_COLS} <= cluster
    general = {g.points for g in fused_cols.GENERAL_COLS}
    assert not any(name.startswith("split") for name in
                   {s.name for s in _build.sources("probes")})
    for e in cluster:
        assert f"cluster_{e}.cu" in names
        text = (_build.CSRC / f"cluster_{e}.cu").read_text()
        assert f"cudaError_t split_{e}(" in text and "launch_kernel<" in text
    for e in general:
        assert f"cols_general_{e}.cu" in names
        assert f"cudaError_t split_{e}(" in (_build.CSRC / f"cols_general_{e}.cu").read_text()
    entry = (_build.CSRC / "cluster.cu").read_text().split("wgfft_cluster_split", 1)[1]
    assert all(f"split_{e}(g, stop)" in entry for e in cluster)
    entry = (_build.CSRC / "cols_general.cu").read_text().split("wgfft_general_cols_split", 1)[1]
    assert all(f"split_{e}(g, stop)" in entry for e in general)
