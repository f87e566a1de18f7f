"""GPU-only tests of the PyTorch port: the CUDA kernels against their plain
torch versions, and every plan type and the staging pipeline on the card
against ``torch.fft`` or float64 torch.

This file imports torch only (no JAX), so it runs where the JAX package is
absent.  On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Elsewhere every test skips (see torch_port_support.cuda_device).
Tolerance: 1e-5 * max|expected|.
"""

import math

import pytest
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch import probes
from webgpufft_tpu_torch.core import fused, fused_cols, radix
from torch_port_support import (assert_close, cuda_device,  # noqa: F401 (fixture)
                                torch_fft_stepper3)

pytestmark = pytest.mark.cuda
# up to this length K1's mixed-radix kernels hold two CTAs an SM or more
MIXED_TWO_CTAS = 9216


def _dev_tables(consts, device):
    return {k.rsplit("/", 1)[1]: torch.as_tensor(v, device=device)
            for k, v in consts.items()}


@pytest.mark.parametrize("n,lines,direction", [
    (1024, 512, "forward"), (2048, 64, "inverse"), (360, 64, "forward"),
    (1000, 33, "inverse"), (2310, 16, "forward"), (16384, 3, "inverse"), (4, 9, "forward"),
    # the radix chain's corners: every odd radix, 13 * 13 * 8, all-16 and
    # all-3 chains, one- and two-butterfly lines, a ragged last CTA, chains
    # that need the 1024-thread kernel, and the small digits 8 * 8 and 8 * 16
    # at the line counts of a rank > 1 plan
    (4096, 5, "inverse"), (1352, 11, "forward"), (16, 1001, "forward"), (6, 77, "inverse"),
    (121, 50, "forward"), (14641, 2, "forward"), (15360, 2, "inverse"), (6561, 3, "forward"),
    (8192, 3, "inverse"), (256, 1537, "forward"), (64, 8192, "forward"), (128, 8192, "inverse"),
    # what the dct, fftconv and overlap-save paths give K1, and the one-butterfly
    # last axes of small rank > 1 plans
    (512, 4096, "forward"), (1024, 8192, "inverse"), (8192, 131, "forward"),
    (256, 8, "inverse"), (8, 16, "forward"), (15, 8, "inverse"), (12, 6, "forward")])
def test_fused_lines_kernel_matches_plain(n, lines, direction, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 1
    assert_close(y.cpu(), fused.fused_lines_reference(x, t).cpu(), label=f"K1 n={n}")


@pytest.mark.parametrize("pre,h,lanes", [
    (4, 256, 512), (1, 256, 8192), (3, 360, 130), (2, 7, 128), (2, 16, 6),
    (2, 16384, 4), (2, 2048, 66),
    # tall tiles at the shared-memory limit, ragged column counts (33, 65),
    # every odd radix, one-butterfly heights, and the small-digit views
    # 8 * 16 and 8 * 8 inside rank > 1 geometry
    (8, 16384, 64), (3, 2310, 66), (2, 1352, 130), (5, 121, 256), (3, 14641, 2),
    (2, 13, 70), (3, 16, 512), (2, 4096, 66), (384, 128, 512), (64, 64, 128),
    # the views of the dct and fftconv paths, axis 0 of a 256^3 r2c plan, and
    # the short heights a small axis 0 gives now that no digit rule holds
    (8, 512, 1024), (1, 1024, 2048), (3, 128, 131072), (8, 3, 512), (8, 9, 512),
    (4, 6, 202), (2, 4, 128)])
def test_fused_cols_kernel_matches_plain(pre, h, lanes, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    t = _dev_tables(fused_cols.cols_consts(h, "inverse", 1.0 / h, "p"), cuda_device)
    x = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    before = fused_cols.fused_cols.launches
    y = fused_cols.fused_cols(x, t)
    torch.cuda.synchronize()
    assert fused_cols.fused_cols.launches == before + 1
    assert_close(y.cpu(), fused_cols.fused_cols_reference(x, t).cpu(),
                 label=f"K2 ({pre}, {h}, {lanes})")


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


LINE_COUNTS = {"one": lambda g: 1, "sms-1": lambda g: g - 1, "sms+1": lambda g: g + 1,
               "2sms+7": lambda g: 2 * g + 7}


@pytest.mark.parametrize("count", sorted(LINE_COUNTS))
@pytest.mark.parametrize("n", [2048, 2079, 4096, 8192, 16384])
def test_long_lines_forward_adjoint_in_place(n, count, cuda_device):
    """K1 from N = 2048 on (2079 = 3^3 * 7 * 11 is odd: its odd lines are not
    16-byte aligned; from 6144 on one CTA fills an SM), at line counts
    around the SM count: one line, an SM count but one, an SM count and
    one, two and a ragged seven."""
    lines = LINE_COUNTS[count](_sms())
    gen = torch.Generator(device=cuda_device).manual_seed(n + lines)
    t = _dev_tables(fused.lines_consts(n, "forward", 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    ya = fused.fused_lines(x, t, adjoint=True)
    z = probes.lines_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 3
    want = fused.fused_lines_reference(x, t).cpu()
    assert_close(y.cpu(), want, label=f"K1 n={n} lines={lines}")
    assert_close(ya.cpu(), fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"K1 n={n} lines={lines} adjoint")
    assert_close(z.cpu(), want, label=f"K1 n={n} lines={lines} in place")


@pytest.mark.parametrize("lines", [1, 131, 1032])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [2048, 4096, 8192, 16384])
def test_pow2_design_at_each_length_of_the_rule(n, direction, lines, cuda_device):
    """K1's rule sends 2^11 .. 2^14 to the power-of-two design: forward,
    adjoint and in place against the plain version at line counts that are
    no multiple of anything (a CTA takes one line), each launch counted;
    two CTAs an SM at 8192; and the entry point refuses any chain but the
    rule's at these lengths (no fallback to the direct design)."""
    from webgpufft_tpu_torch import _build
    from webgpufft_tpu_torch.core import radix
    assert radix.lines_design(n) == "pow2"
    gen = torch.Generator(device=cuda_device).manual_seed(n + lines)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    ya = fused.fused_lines(x, t, adjoint=True)
    z = probes.lines_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 3
    want = fused.fused_lines_reference(x, t).cpu()
    assert_close(y.cpu(), want, label=f"K1 pow2 n={n} lines={lines}")
    assert_close(ya.cpu(), fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"K1 pow2 n={n} lines={lines} adjoint")
    assert torch.equal(z, y)
    assert fused.launch_report(n, lines).resident >= (2 if n == 8192 else 1)
    for other in {radix.radix_chain(n), (2,) * (n.bit_length() - 1)} - {radix.lines_chain(n)}:
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), y.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), lines, n,
            *_build.chain_arg(other), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 1, other   # cudaErrorInvalidValue


@pytest.mark.parametrize("lines", [1, 7, 131, 1536, 4096])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", [32, 256, 512, 1024])
def test_short_design_at_each_length_of_the_rule(n, direction, lines, cuda_device):
    """K1's rule sends the short powers of two the paths launch to a
    compile-time design (the warp design at 512, the power-of-two design's
    one line a CTA at 256 and 1024, the packed design at 32, which the warp
    design ran until the packed design beat it): forward, adjoint and in
    place against the plain version at line counts that leave a warp's last
    group ragged and that run one round or several, each launch counted;
    the launch fills the card (CTAs an SM >= 1, a grid of more than 24 CTAs
    at 32 x 1536, the warp and packed designs never more than one wave);
    and the entry point refuses any chain but the rule's (no fallback to
    the direct design)."""
    from webgpufft_tpu_torch import _build
    from webgpufft_tpu_torch.core import radix
    design = {32: "packed", 512: "warp"}.get(n, "pow2")
    assert radix.lines_design(n) == design
    gen = torch.Generator(device=cuda_device).manual_seed(n + lines)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    ya = fused.fused_lines(x, t, adjoint=True)
    z = probes.lines_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 3
    want = fused.fused_lines_reference(x, t).cpu()
    assert_close(y.cpu(), want, label=f"K1 {design} n={n} lines={lines}")
    assert_close(ya.cpu(), fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"K1 {design} n={n} lines={lines} adjoint")
    assert torch.equal(z, y)
    launch = fused.launch_report(n, lines)
    print(f"K1 {design} n={n} lines={lines}: {launch}, {launch.waves:.3f} waves")
    assert launch.design == design and launch.resident >= 1
    assert launch.sms == torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if design in ("warp", "packed"):
        assert 1 <= launch.grid <= min(launch.work, launch.resident * launch.sms)
    else:
        assert launch.grid == launch.work == lines
    if (n, lines) == (32, 1536):
        assert launch.grid > 24
    for other in {radix.radix_chain(n), (2,) * (n.bit_length() - 1)} - {radix.lines_chain(n)}:
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), y.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), lines, n,
            *_build.chain_arg(other), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 1, other   # cudaErrorInvalidValue


@pytest.mark.parametrize("lines", [1, 7, 131])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", sorted(radix.MIXED_LINES))
def test_mixed_design_at_each_length_of_the_rule(n, direction, lines, cuda_device):
    """K1's rule sends the lengths of ``radix.MIXED_LINES`` to the
    mixed-radix design: forward, adjoint and in place (every chain of the
    rule has two passes or more) against the plain version at line counts
    that leave the last CTA ragged where a CTA takes several lines, each
    launch counted; the launch report names the design, a grid of whole
    CTAs and at least one CTA an SM (two from 2048 points on, where the
    line's shared memory leaves room for them); and the entry point refuses
    the direct design's chain and the rule's chain reversed (no fallback)."""
    from webgpufft_tpu_torch import _build
    assert radix.lines_design(n) == "mixed"
    gen = torch.Generator(device=cuda_device).manual_seed(n + lines)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    ya = fused.fused_lines(x, t, adjoint=True)
    z = probes.lines_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 3
    want = fused.fused_lines_reference(x, t).cpu()
    assert_close(y.cpu(), want, label=f"K1 mixed n={n} lines={lines}")
    assert_close(ya.cpu(), fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"K1 mixed n={n} lines={lines} adjoint")
    assert torch.equal(z, y)
    launch = fused.launch_report(n, lines)
    print(f"K1 mixed n={n} lines={lines}: {launch}, {launch.waves:.3f} waves")
    assert launch.design == "mixed" and launch.grid == launch.work <= lines
    assert launch.resident >= (2 if 2048 <= n <= MIXED_TWO_CTAS else 1)
    chain = radix.lines_chain(n)
    for other in {radix.radix_chain(n), chain[::-1]} - {chain}:
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), y.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), lines, n,
            *_build.chain_arg(other), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 1, other   # cudaErrorInvalidValue


def test_every_mixed_variant_matches_plain(cuda_device):
    """Each variant of the mixed-radix design (``probes.lines_variant``)
    against K1's plain version, forward, adjoint and in place, at a line
    count that leaves the last CTA ragged where a CTA takes several lines."""
    from webgpufft_tpu_torch.probes import variants
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    for name, variant in variants.MIXED_VARIANTS.items():
        n = variant.n
        t = _dev_tables(fused.lines_consts(n, "inverse", 1.0 / n, "p"), cuda_device)
        vt = variants.lines_variant_tables(name, "inverse", 1.0 / n, cuda_device)
        x = torch.randn(7, n, 2, device=cuda_device, generator=gen)
        assert variants.lines_variant_resident(name) >= 1
        for adj in (False, True):
            assert_close(variants.lines_variant(x, vt, name, adj).cpu(),
                         fused.fused_lines_reference(x, t, adj).cpu(),
                         label=f"{name} adjoint={adj}")
        assert_close(variants.lines_variant(x.clone(), vt, name, inplace=True).cpu(),
                     fused.fused_lines_reference(x, t).cpu(), label=f"{name} in place")


def test_every_pow2_variant_matches_plain(cuda_device):
    """Each variant of the power-of-two and warp designs
    (``probes.lines_variant``) against K1's plain version, forward, adjoint
    and in place, at a line count that leaves a warp's last group ragged."""
    from webgpufft_tpu_torch.probes import variants
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    for name, variant in variants.LINES_VARIANTS.items():
        n = variant.n
        t = _dev_tables(fused.lines_consts(n, "inverse", 1.0 / n, "p"), cuda_device)
        vt = variants.lines_variant_tables(name, "inverse", 1.0 / n, cuda_device)
        x = torch.randn(7, n, 2, device=cuda_device, generator=gen)
        assert variants.lines_variant_resident(name) >= 1
        for adj in (False, True):
            assert_close(variants.lines_variant(x, vt, name, adj).cpu(),
                         fused.fused_lines_reference(x, t, adj).cpu(),
                         label=f"{name} adjoint={adj}")
        assert_close(variants.lines_variant(x.clone(), vt, name, inplace=True).cpu(),
                     fused.fused_lines_reference(x, t).cpu(), label=f"{name} in place")


@pytest.mark.parametrize("lines", [1, 7, 257, 100003])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", sorted(radix.PACKED_LINES))
def test_packed_design_at_each_length_of_the_rule(n, direction, lines, cuda_device):
    """K1's rule sends the lengths of ``radix.PACKED_LINES`` to the packed
    design: forward, adjoint and in place (at every chain, one pass
    included) against the plain version at line counts that leave a warp's
    last block ragged (1, 7, 257) and that run the grid's rounds
    (100,003), each launch counted; the launch report names the design, a
    grid of at most one wave and no more CTAs than its work; and the entry
    point refuses any chain but the rule's (no fallback)."""
    from webgpufft_tpu_torch import _build
    assert radix.lines_design(n) == "packed" and radix.lines_in_place(n)
    gen = torch.Generator(device=cuda_device).manual_seed(n + lines)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    ya = fused.fused_lines(x, t, adjoint=True)
    z = probes.lines_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 3
    want = fused.fused_lines_reference(x, t).cpu()
    assert_close(y.cpu(), want, label=f"K1 packed n={n} lines={lines}")
    assert_close(ya.cpu(), fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"K1 packed n={n} lines={lines} adjoint")
    assert torch.equal(z, y)
    launch = fused.launch_report(n, lines)
    assert launch.design == "packed" and launch.resident >= 1
    assert 1 <= launch.grid <= min(launch.work, launch.resident * launch.sms)
    chain = radix.lines_chain(n)
    for other in {chain[::-1], (n,), (2, n // 2)} - {chain}:
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), y.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), lines, n,
            *_build.chain_arg(other), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 1, other   # cudaErrorInvalidValue


@pytest.mark.parametrize("n,lines", [(16, 100003), (77, 7), (64, 257), (6, 77), (126, 33),
                                     (9, 1)])
def test_packed_design_on_an_8_byte_aligned_view(n, lines, cuda_device):
    """The packed design on an input that starts 8 bytes past a 16-byte
    boundary (an offset view into a larger buffer): its 8-byte copies, the
    same kernel, forward, adjoint and in place (input and output both
    offset), against the plain version on the same values; at odd N with an
    odd line count the aligned path's last point is copied alone."""
    assert radix.lines_design(n) == "packed"
    gen = torch.Generator(device=cuda_device).manual_seed(n * lines)
    t = _dev_tables(fused.lines_consts(n, "inverse", 1.0 / n, "p"), cuda_device)
    base = torch.randn(lines * n + 1, 2, device=cuda_device, generator=gen)
    x = base[1:].view(lines, n, 2)
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    want = fused.fused_lines_reference(x, t).cpu()
    assert_close(fused.fused_lines(x, t).cpu(), want, label=f"K1 packed n={n} offset view")
    assert_close(fused.fused_lines(x, t, adjoint=True).cpu(),
                 fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"K1 packed n={n} offset view adjoint")
    work = base.clone()
    assert_close(probes.lines_inplace(work[1:].view(lines, n, 2), t).cpu(), want,
                 label=f"K1 packed n={n} offset view in place")
    assert torch.equal(work[0], base[0])   # the point before the view untouched
    aligned = x.contiguous().clone()
    assert aligned.data_ptr() % 16 == 0
    assert_close(fused.fused_lines(aligned, t).cpu(), want, label=f"K1 packed n={n} aligned")


@pytest.mark.parametrize("n", sorted(radix.GENERAL_LINES))
def test_general_design_at_each_length_of_the_rule(n, cuda_device):
    """K1's rule sends the lengths of ``radix.GENERAL_LINES`` to the
    general design: forward (inverse at odd table positions), adjoint, in
    place and on an input 8 bytes past a 16-byte boundary (an offset view,
    in place there too) against the plain version, on a line count that
    leaves the last CTA ragged, each launch counted; the launch report names
    the design and a grid of one CTA a ``lines`` lines; and the entry point
    refuses ``radix_chain``'s chain and the rule's reversed where they
    differ from the rule's (no fallback)."""
    from webgpufft_tpu_torch import _build
    points, per_cta, chain = radix.GENERAL_LINES[n]
    assert radix.lines_design(n) == "general" and radix.lines_in_place(n)
    direction = ("forward", "inverse")[sorted(radix.GENERAL_LINES).index(n) % 2]
    lines = per_cta + 2 if per_cta > 1 else 3
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    base = torch.randn(lines * n + 1, 2, device=cuda_device, generator=gen)
    x = base[:-1].view(lines, n, 2)
    off = base[1:].view(lines, n, 2)
    assert off.data_ptr() % 16 == 8
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    ya = fused.fused_lines(x, t, adjoint=True)
    z = probes.lines_inplace(x.clone(), t)
    yo = fused.fused_lines(off, t)
    work = base.clone()
    zo = probes.lines_inplace(work[1:].view(lines, n, 2), t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 5
    label = f"K1 general n={n} {chain} {points} points {per_cta} lines a CTA, {lines} lines"
    assert_close(y.cpu(), fused.fused_lines_reference(x, t).cpu(), label=label)
    assert_close(ya.cpu(), fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"{label} adjoint")
    assert torch.equal(z, y)
    want = fused.fused_lines_reference(off, t).cpu()
    assert_close(yo.cpu(), want, label=f"{label} offset view")
    assert_close(zo.cpu(), want, label=f"{label} offset view in place")
    assert torch.equal(work[0], base[0])   # the point before the view untouched
    launch = fused.launch_report(n, lines)
    assert launch.design == "general" and launch.resident >= 1
    assert launch.grid == launch.work == -(-lines // per_cta)
    for other in {radix.radix_chain(n), chain[::-1]} - {chain}:
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), y.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), lines, n,
            *_build.chain_arg(other), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 1, other   # cudaErrorInvalidValue


@pytest.mark.parametrize("n", sorted(radix.CLUSTER_LINES))
def test_cluster_design_at_each_length_of_the_rule(n, cuda_device):
    """K1's rule sends the lengths of ``radix.CLUSTER_LINES`` (11583 on) to
    the cluster design: forward, inverse unitary, adjoint, in place and on
    an input 8 bytes past a 16-byte boundary (in place there too) against
    the plain version, each launch counted; the launch report names the
    design and a grid of C CTAs a line; at least one cluster of its kernel
    is resident; and the entry point refuses ``radix_chain``'s chain and
    the rule's reversed (no fallback)."""
    from webgpufft_tpu_torch import _build
    from webgpufft_tpu_torch.probes import variants
    line = radix.CLUSTER_LINES[n]
    assert radix.lines_design(n) == "cluster" and radix.lines_in_place(n)
    lines = 3
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, "forward", 1.0, "p"), cuda_device)
    inv = _dev_tables(fused.lines_consts(n, "inverse", 1.0 / math.sqrt(n), "p"), cuda_device)
    base = torch.randn(lines * n + 1, 2, device=cuda_device, generator=gen)
    x = base[:-1].view(lines, n, 2)
    off = base[1:].view(lines, n, 2)
    assert off.data_ptr() % 16 == 8
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    yi = fused.fused_lines(x, inv)
    ya = fused.fused_lines(x, t, adjoint=True)
    z = probes.lines_inplace(x.clone(), t)
    yo = fused.fused_lines(off, t)
    work = base.clone()
    zo = probes.lines_inplace(work[1:].view(lines, n, 2), t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 6
    label = f"K1 cluster n={n} {line}"
    assert_close(y.cpu(), fused.fused_lines_reference(x, t).cpu(), label=label)
    assert_close(yi.cpu(), fused.fused_lines_reference(x, inv).cpu(), label=f"{label} inverse")
    assert_close(ya.cpu(), fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"{label} adjoint")
    assert torch.equal(z, y)
    want = fused.fused_lines_reference(off, t).cpu()
    assert_close(yo.cpu(), want, label=f"{label} offset view")
    assert_close(zo.cpu(), want, label=f"{label} offset view in place")
    assert torch.equal(work[0], base[0])   # the point before the view untouched
    launch = fused.launch_report(n, lines)
    assert launch.design == "cluster" and launch.resident >= line.ctas
    assert launch.grid == launch.work == lines * line.clusters
    report = variants.cluster_report(lines, n, 1, line.chain, line.points, 1, line.clusters,
                                     line.ctas)
    assert report.clusters >= 1 and report.grid == lines * line.clusters
    assert report.resident == launch.resident
    for other in {radix.radix_chain(n), line.chain[::-1]} - {line.chain}:
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), y.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), lines, n,
            *_build.chain_arg(other), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 1, other   # cudaErrorInvalidValue


@pytest.mark.parametrize("n", sorted(radix.CLUSTER_LINES))
def test_one_buffer_cluster_kernel_at_each_length(n, cuda_device):
    """The cluster design's kernel built for two CTAs an SM (one exchange
    buffer, the middle passes in place) at every K1 cluster length, in every
    variant the sweep tries (``probes.variants.cluster_candidates(n, (1,),
    (2,))``): forward, inverse unitary and the adjoint launch against the
    plain version on the variant's chain, in place too; its report holds two
    CTAs an SM at least and one buffer of ``radix.cluster_plan``'s size."""
    from webgpufft_tpu_torch.probes import variants
    lines = 3
    gen = torch.Generator(device=cuda_device).manual_seed(n + 24)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    cands = variants.cluster_candidates(n, (1,), (2,))
    assert cands
    for name, chain, points, _, clusters, ctas in cands:
        t = _dev_tables(radix.chain_consts(n, "forward", 1.0, "p", chain), cuda_device)
        inv = _dev_tables(radix.chain_consts(n, "inverse", 1.0 / math.sqrt(n), "p", chain),
                          cuda_device)
        run = lambda tt, adj=False, inplace=False: variants.cluster_variant(
            x.clone() if inplace else x, tt, chain, points, 1, clusters, adj, inplace,
            ctas=ctas)
        label = f"K1 one-buffer n={n} {name}"
        assert_close(run(t).cpu(), radix.radix_chain_reference(x, chain, t).cpu(), label=label)
        assert_close(run(inv).cpu(), radix.radix_chain_reference(x, chain, inv).cpu(),
                     label=f"{label} inverse")
        assert_close(run(t, True).cpu(), radix.radix_chain_reference(x, chain, t, True).cpu(),
                     label=f"{label} adjoint")
        assert torch.equal(run(t, inplace=True), run(t)), label
        report = variants.cluster_report(lines, n, 1, chain, points, 1, clusters, ctas)
        threads, smem = radix.cluster_plan(n, chain, points, 1, clusters, ctas)
        assert report.resident >= 2 and (report.threads, report.shared) == (threads, smem), label


def test_one_image_band_holds_two_ctas_an_sm(cuda_device):
    """K2's general band of few-tile views at the halo fftconv's one image
    (1, 1078, 2156): the C rule (``fused_cols.launch_shape``, held to its
    Python copy) gives the band's tile, and the card holds two of its CTAs
    an SM at least (one of the 67 MB entry's, which (8, 1078, 2156) runs);
    the launch matches the plain version, forward and adjoint."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    band = next(g for g in fused_cols.GENERAL_COLS if g.h == 1078 and g.least <= 1078 <= g.most)
    one, held = fused_cols.launch_shape(1, 1078, 1078)
    eight, held8 = fused_cols.launch_shape(8, 1078, 1078)
    assert (one.design, one.tile) == ("general", band.tile) and eight.tile != band.tile
    assert held >= 2 * sms and held > held8
    t = _dev_tables(fused_cols.cols_consts(1078, "forward", 1.0, "p"), cuda_device)
    x = torch.randn(1, 1078, 2156, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(1078))
    for adj in (False, True):
        assert_close(fused_cols.fused_cols(x, t, adjoint=adj).cpu(),
                     fused_cols.fused_cols_reference(x, t, adj).cpu(),
                     label=f"K2 (1, 1078, 2156) band adjoint={adj}")


def test_k1_rule_is_one_table_in_c_and_python(cuda_device):
    """The design K1's C entry point gives every length it takes
    (``fused.launch_report``, read from ``wgfft_fused_lines_resident``)
    is ``radix.lines_design``'s: the five tables of lines.cuh (kPow2Lines,
    kWarpLines, kMixedLines, kPackedLines, kGeneralLines) and the cluster
    design's of cluster.cuh (kClusterLines) equal core/radix.py's."""
    lengths = [n for n in range(2, radix.MAX_LENGTH + 1) if fused.choose_split(n)]
    wrong = [(n, fused.launch_report(n, 1000).design, radix.lines_design(n)) for n in lengths
             if fused.launch_report(n, 1000).design != radix.lines_design(n)]
    assert not wrong
    assert {n for n in lengths if radix.lines_design(n) == "packed"} == set(radix.PACKED_LINES)
    assert {n for n in lengths if radix.lines_design(n) == "general"} == set(radix.GENERAL_LINES)
    assert {n for n in lengths if radix.lines_design(n) == "cluster"} == set(radix.CLUSTER_LINES)


def test_every_packed_variant_matches_plain(cuda_device):
    """Each variant of the packed design (``probes.lines_variant``) against
    K1's plain version, forward, adjoint and in place, at a line count that
    leaves a warp's last block ragged, and on an input 8 bytes past a
    16-byte boundary (the same kernel's 8-byte copies)."""
    from webgpufft_tpu_torch.probes import variants
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    for name, v in variants.PACKED_VARIANTS.items():
        n = v.n
        t = _dev_tables(fused.lines_consts(n, "inverse", 1.0 / n, "p"), cuda_device)
        vt = variants.lines_variant_tables(name, "inverse", 1.0 / n, cuda_device)
        lines = 32 // v.lanes * 3 + 5
        base = torch.randn(lines * n + 1, 2, device=cuda_device, generator=gen)
        assert variants.lines_variant_resident(name) >= 1
        for x in (base[:-1].view(lines, n, 2), base[1:].view(lines, n, 2)):
            for adj in (False, True):
                assert_close(variants.lines_variant(x, vt, name, adj).cpu(),
                             fused.fused_lines_reference(x, t, adj).cpu(),
                             label=f"{name} adjoint={adj} at {x.data_ptr() % 16}")
            assert_close(variants.lines_variant(x.clone(), vt, name, inplace=True).cpu(),
                         fused.fused_lines_reference(x, t).cpu(), label=f"{name} in place")


@pytest.mark.parametrize("view", ["odd columns", "narrow", "one pre"])
@pytest.mark.parametrize("h", [512, 1024, 2048])
def test_tall_tiles_forward_adjoint_in_place(h, view, cuda_device):
    """K2 at heights whose tiles reach 8192 points, in the design its rule
    takes: 33 columns (a 264-byte row pitch, not 16-byte aligned: the
    8-byte copies, and a ragged last tile) over two grids and a ragged seven
    of tiles, 5 columns (a tile narrower than 16), and one pre index."""
    cols = {"odd columns": 33, "narrow": 5, "one pre": 1024}[view]
    tile = fused_cols.cols_rule(1 << 16, h, cols, _sms()).tile
    pre = 1 if view == "one pre" else -(-(2 * _sms() + 7) // -(-cols // tile))
    launch = fused_cols.launch_shape(pre, h, cols)[0]
    gen = torch.Generator(device=cuda_device).manual_seed(h + cols)
    t = _dev_tables(fused_cols.cols_consts(h, "inverse", 1.0 / h, "p"), cuda_device)
    x = torch.randn(pre, h, 2 * cols, device=cuda_device, generator=gen)
    before = fused_cols.fused_cols.launches
    y = fused_cols.fused_cols(x, t)
    ya = fused_cols.fused_cols(x, t, adjoint=True)
    z = probes.cols_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused_cols.fused_cols.launches == before + 3
    want = fused_cols.fused_cols_reference(x, t).cpu()
    label = f"K2 ({pre}, {h}, {2 * cols}) {launch}"
    assert_close(y.cpu(), want, label=label)
    assert_close(ya.cpu(), fused_cols.fused_cols_reference(x, t, adjoint=True).cpu(),
                 label=f"{label} adjoint")
    assert_close(z.cpu(), want, label=f"{label} in place")


def test_ring_launches_after_a_smaller_stage_of_the_same_kernel(cuda_device):
    """H = 768 and 640 (16 * 16 * 3, 16 * 8 * 5) run the same ring kernel
    with stages of 12,288 and 10,240 points: the launch after the smaller
    one still has the shared memory its larger stages need.  (K2's rule
    gives both heights the general design since it has one, so the ring
    runs by name, ``probes.variants.cols_variant``, through the same launch
    code of csrc/cols.cuh.)"""
    from webgpufft_tpu_torch.probes import variants
    for h in (768, 640, 768):
        gen = torch.Generator(device=cuda_device).manual_seed(h)
        t = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0, "p"), cuda_device)
        x = torch.randn(3, h, 66, device=cuda_device, generator=gen)
        assert fused_cols.cols_rule(3, h, 33).design == "general", h
        assert_close(variants.cols_variant(x, t, "ring").cpu(),
                     fused_cols.fused_cols_reference(x, t).cpu(), label=f"K2 ring H={h}")


@pytest.mark.parametrize("design", ["direct", "ring", "ring-async"])
@pytest.mark.parametrize("pre,h,lanes", [(8, 1024, 2048), (3, 2048, 64), (5, 512, 1024)])
def test_every_cols_design_matches_plain(pre, h, lanes, design, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    t = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0, "p"), cuda_device)
    x = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    for adjoint in (False, True):
        y = probes.cols_variant(x, t, design, adjoint=adjoint)
        assert_close(y.cpu(), fused_cols.fused_cols_reference(x, t, adjoint).cpu(),
                     label=f"K2 {design} ({pre}, {h}, {lanes}) adjoint={adjoint}")


# ---- K2's rule and its fixed design ------------------------------------------------

# (pre, H, 2 * cols, direction): the views of chip_smoke.py's phase_k2 that
# left the card idle, the domain phase's tall 33-column views and the
# facade's f-k gather
FILL_VIEWS = [(3, 2310, 66, "inverse"), (8, 16384, 64, "inverse"), (4, 1352, 130, "forward"),
              (1, 1024, 2048, "forward"), (5, 2048, 66, "forward"), (64, 360, 512, "forward"),
              (64, 1024, 66, "inverse"), (2, 2048, 66, "forward"), (2, 4096, 66, "forward"),
              (2, 8192, 66, "forward"), (2, 16384, 66, "forward"), (8, 16384, 128, "forward")]


def _cols_plan_in_c(pre, h, cols, sms):
    """The C rule's launch (wgfft_fused_cols_plan at ``sms`` SMs)."""
    import ctypes
    from webgpufft_tpu_torch import _build
    out = (ctypes.c_longlong * 7)()
    rc = _build.library().wgfft_fused_cols_plan(
        pre, h, cols, *_build.chain_arg(fused_cols.cols_chain(h)), sms, out)
    if rc == 1:
        return None
    assert rc == 0, rc
    return fused_cols.ColsLaunch(fused_cols.DESIGNS[out[0]], *out[1:6])


def _python_rule(pre, h, cols, sms):
    try:
        return fused_cols.cols_rule(pre, h, cols, sms)
    except ValueError:
        return None


@pytest.mark.parametrize("sms", [132, 114, 0])
def test_k2_rule_in_c_equals_its_python_copy(sms, cuda_device):
    """Every height K2 takes over a grid of column and pre counts: the C
    rule gives what fused_cols.cols_rule gives (0: the card's own SMs)."""
    sms = sms or _sms()
    heights = [h for h in range(2, radix.MAX_LENGTH + 1) if fused_cols.choose_split(h)]
    for h in heights:
        for cols in (1, 5, 33, 64, 65, 256, 1024):
            for pre in (1, 3, 8, 64):
                assert _cols_plan_in_c(pre, h, cols, sms) == _python_rule(pre, h, cols, sms), \
                    (pre, h, cols, sms)


def test_k2_entry_refuses_views_outside_its_rule(cuda_device):
    from webgpufft_tpu_torch import _build
    lib = _build.library()
    # a height of the fixed design whose chain read backwards is another chain
    h = next(f.h for f in fused_cols.FIXED_COLS if f.chain != f.chain[::-1])
    t = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0, "p"), cuda_device)
    x = torch.zeros(1, h, 8, device=cuda_device)
    before = fused_cols.fused_cols.launches
    stream = torch.cuda.current_stream().cuda_stream
    for pre, cols, chain in [(0, 4, radix.radix_chain(h)), (1, 0, radix.radix_chain(h)),
                             (1, 4, radix.radix_chain(h)[::-1])]:
        rc = lib.wgfft_fused_cols(x.data_ptr(), x.data_ptr(), t["cw"].data_ptr(),
                                  t["cp"].data_ptr(), pre, h, cols, *_build.chain_arg(chain),
                                  0, stream)
        assert rc == 1, (pre, cols, chain)   # cudaErrorInvalidValue, nothing launched
    assert fused_cols.fused_cols.launches == before
    with pytest.raises(ValueError, match="no design runs"):
        fused_cols.launch_shape(0, h, 4)


def _general_views(h):
    """(pre, cols) views of each entry of K2's general design at height h:
    (2, 33) (66 columns in all, ragged against every tile) where an entry
    holds it, and 1 x (129 or the tile + 1, whichever is more) where a
    later entry holds 129 columns; an entry of few-tile views (a band that
    ends below kAllColumns) at its one-image view (1, h) too, and an entry
    that starts above 129 at its first column count."""
    entries = [g for g in fused_cols.GENERAL_COLS if g.h == h]
    views = []
    for g in entries:
        if g.least <= 66 <= g.most:
            views.append((2, 33, g))
        if g.least <= max(129, g.tile + 1) <= g.most and g.most > 66:
            views.append((1, max(129, g.tile + 1), g))
        if g.least > 129:
            views.append((1, g.least, g))
        if g.least > 66 and g.most < radix.ALL_COLUMNS and g.least <= h <= g.most:
            views.append((1, h, g))
    return views


@pytest.mark.parametrize("h", sorted({g.h for g in fused_cols.GENERAL_COLS}))
def test_general_cols_design_at_each_height_of_the_rule(h, cuda_device):
    """K2's rule sends the heights of ``fused_cols.GENERAL_COLS`` to the
    general design: at a view of each entry's range, over ragged columns,
    forward, inverse unitary, the adjoint launch, in place, and on an input
    8 bytes past a 16-byte boundary (in place there too) against the plain
    version, each launch counted; ``launch_shape`` names the entry's tile
    and threads; and the entry point refuses ``radix_chain``'s chain and
    the reversed chain where they differ from ``cols_chain``'s."""
    from webgpufft_tpu_torch import _build
    chain = fused_cols.cols_chain(h)
    fwd = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0, "p"), cuda_device)
    inv = _dev_tables(fused_cols.cols_consts(h, "inverse", 1.0 / math.sqrt(h), "p"), cuda_device)
    for pre, cols, g in _general_views(h):
        launch, resident = fused_cols.launch_shape(pre, h, cols)
        assert (launch.design, launch.tile) == ("general", g.tile) and resident >= 1, launch
        gen = torch.Generator(device=cuda_device).manual_seed(h * cols)
        base = torch.randn(pre * h * cols + 1, 2, device=cuda_device, generator=gen)
        x = base[:-1].view(pre, h, 2 * cols)
        off = base[1:].view(pre, h, 2 * cols)
        assert off.data_ptr() % 16 == 8
        before = fused_cols.fused_cols.launches
        y = fused_cols.fused_cols(x, fwd)
        yi = fused_cols.fused_cols(x, inv)
        ya = fused_cols.fused_cols(x, fwd, adjoint=True)
        z = probes.cols_inplace(x.clone(), fwd)
        yo = fused_cols.fused_cols(off, fwd)
        work = base.clone()
        zo = probes.cols_inplace(work[1:].view(pre, h, 2 * cols), fwd)
        torch.cuda.synchronize()
        assert fused_cols.fused_cols.launches == before + 6
        label = f"K2 general ({pre}, {h}, {2 * cols}) {chain} {g.points} points tile {g.tile}"
        assert_close(y.cpu(), fused_cols.fused_cols_reference(x, fwd).cpu(), label=label)
        assert_close(yi.cpu(), fused_cols.fused_cols_reference(x, inv).cpu(),
                     label=f"{label} inverse")
        assert_close(ya.cpu(), fused_cols.fused_cols_reference(x, fwd, adjoint=True).cpu(),
                     label=f"{label} adjoint")
        assert torch.equal(z, y)
        want = fused_cols.fused_cols_reference(off, fwd).cpu()
        assert_close(yo.cpu(), want, label=f"{label} offset view")
        assert_close(zo.cpu(), want, label=f"{label} offset view in place")
        assert torch.equal(work[0], base[0])   # the point before the view untouched
        for other in {radix.radix_chain(h), chain[::-1]} - {chain}:
            rc = _build.library().wgfft_fused_cols(
                x.data_ptr(), y.data_ptr(), fwd["cw"].data_ptr(), fwd["cp"].data_ptr(), pre, h,
                cols, *_build.chain_arg(other), 0, torch.cuda.current_stream().cuda_stream)
            assert rc == 1, other   # cudaErrorInvalidValue


def _cluster_views(h):
    """(pre, cols, entry) views of each entry of K2's cluster design at
    height h: (2, 33) where an entry holds 66 columns in all, and 1 x (129
    or the tile + 1) where a later entry holds them."""
    views = []
    for g in (g for g in fused_cols.CLUSTER_COLS if g.h == h):
        if g.least <= 66 <= g.most:
            views.append((2, 33, g))
        if g.least <= max(129, g.tile + 1) <= g.most and g.most > 66:
            views.append((1, max(129, g.tile + 1), g))
    return views


@pytest.mark.parametrize("h", sorted({g.h for g in fused_cols.CLUSTER_COLS}))
def test_cluster_cols_design_at_each_height_of_the_rule(h, cuda_device):
    """K2's rule sends the heights of ``fused_cols.CLUSTER_COLS`` (11583 on)
    to the cluster design: at a view of each entry's range, over ragged
    columns, forward, inverse unitary, the adjoint launch, in place, and on
    an input 8 bytes past a 16-byte boundary (in place there too) against
    the plain version, each launch counted; ``launch_shape`` names the
    entry's tile and cluster, and at least one cluster is resident; and the
    entry point refuses ``radix_chain``'s chain and the reversed chain."""
    from webgpufft_tpu_torch import _build
    chain = fused_cols.cols_chain(h)
    fwd = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0, "p"), cuda_device)
    inv = _dev_tables(fused_cols.cols_consts(h, "inverse", 1.0 / math.sqrt(h), "p"), cuda_device)
    for pre, cols, g in _cluster_views(h):
        launch, resident = fused_cols.launch_shape(pre, h, cols)
        assert (launch.design, launch.tile, launch.cluster) == ("cluster", g.tile, g.clusters)
        assert resident >= 1, launch
        gen = torch.Generator(device=cuda_device).manual_seed(h * cols)
        base = torch.randn(pre * h * cols + 1, 2, device=cuda_device, generator=gen)
        x = base[:-1].view(pre, h, 2 * cols)
        off = base[1:].view(pre, h, 2 * cols)
        assert off.data_ptr() % 16 == 8
        before = fused_cols.fused_cols.launches
        y = fused_cols.fused_cols(x, fwd)
        yi = fused_cols.fused_cols(x, inv)
        ya = fused_cols.fused_cols(x, fwd, adjoint=True)
        z = probes.cols_inplace(x.clone(), fwd)
        yo = fused_cols.fused_cols(off, fwd)
        work = base.clone()
        zo = probes.cols_inplace(work[1:].view(pre, h, 2 * cols), fwd)
        torch.cuda.synchronize()
        assert fused_cols.fused_cols.launches == before + 6
        label = (f"K2 cluster ({pre}, {h}, {2 * cols}) {chain} {g.points} points tile {g.tile} "
                 f"cluster {g.clusters}")
        assert_close(y.cpu(), fused_cols.fused_cols_reference(x, fwd).cpu(), label=label)
        assert_close(yi.cpu(), fused_cols.fused_cols_reference(x, inv).cpu(),
                     label=f"{label} inverse")
        assert_close(ya.cpu(), fused_cols.fused_cols_reference(x, fwd, adjoint=True).cpu(),
                     label=f"{label} adjoint")
        assert torch.equal(z, y)
        want = fused_cols.fused_cols_reference(off, fwd).cpu()
        assert_close(yo.cpu(), want, label=f"{label} offset view")
        assert_close(zo.cpu(), want, label=f"{label} offset view in place")
        assert torch.equal(work[0], base[0])   # the point before the view untouched
        for other in {radix.radix_chain(h), chain[::-1]} - {chain}:
            rc = _build.library().wgfft_fused_cols(
                x.data_ptr(), y.data_ptr(), fwd["cw"].data_ptr(), fwd["cp"].data_ptr(), pre, h,
                cols, *_build.chain_arg(other), 0, torch.cuda.current_stream().cuda_stream)
            assert rc == 1, other   # cudaErrorInvalidValue


def test_cluster_launch_refused_raises(cuda_device):
    """No fallback: a shape the cluster design does not run (a cluster of 16,
    a first radix under twice the cluster, a kernel of two CTAs an SM with
    too many threads or at 24 points, three CTAs an SM) comes back from the
    C entry point as cudaErrorInvalidValue with nothing launched, and the
    wrapper raises."""
    from webgpufft_tpu_torch import _build
    from webgpufft_tpu_torch.probes import variants
    n = 16000
    t = _dev_tables(radix.chain_consts(n, "forward", 1.0, "p", (32, 25, 20)), cuda_device)
    x = torch.zeros(1, n, 2, device=cuda_device)
    for chain, points, clusters, ctas in (
            ((32, 25, 20), 32, 16, 1), ((32, 25, 20), 32, 3, 1), ((10, 20, 16, 5), 32, 8, 1),
            ((32, 25, 20), 32, 2, 2), ((16, 20, 10, 5), 24, 4, 2), ((32, 25, 20), 64, 2, 3)):
        rc = _build.library().wgfft_cluster(
            x.data_ptr(), x.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), 1, n, 1,
            *_build.chain_arg(chain), points, 1, clusters, ctas, 0, None,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 1, (chain, points, clusters, ctas)
        with pytest.raises(ValueError, match="does not run"):
            variants.cluster_variant(x, t, chain, points, 1, clusters, ctas=ctas)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _build.check(1, "cluster_variant")


@pytest.mark.parametrize("pre,h,lanes,direction", FILL_VIEWS)
def test_fill_views_forward_adjoint_in_place(pre, h, lanes, direction, cuda_device):
    """K2 in the design its rule gives each view, against the plain version:
    forward, the adjoint launch, in place, and the adjoint dot test
    <F x, u> = <x, F^H u>."""
    launch, resident = fused_cols.launch_shape(pre, h, lanes // 2)
    assert resident >= 1
    gen = torch.Generator(device=cuda_device).manual_seed(pre * h + lanes)
    t = _dev_tables(fused_cols.cols_consts(h, direction, 1.0, "p"), cuda_device)
    x = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    u = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    label = f"K2 ({pre}, {h}, {lanes}) {launch}"
    before = fused_cols.fused_cols.launches
    fx = fused_cols.fused_cols(x, t)
    fu = fused_cols.fused_cols(u, t, adjoint=True)
    z = probes.cols_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused_cols.fused_cols.launches == before + 3
    assert_close(fx.cpu(), fused_cols.fused_cols_reference(x, t).cpu(), label=label)
    assert_close(fu.cpu(), fused_cols.fused_cols_reference(u, t, adjoint=True).cpu(),
                 label=f"{label} adjoint")
    assert_close(z.cpu(), fx.cpu(), label=f"{label} in place")
    lhs = (fx.double() * u.double()).sum().item()
    rhs = (x.double() * fu.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), (fx.double() ** 2).sum().sqrt().item())


@pytest.mark.parametrize("entry", range(len(fused_cols.FIXED_COLS)))
def test_every_fixed_entry_of_the_rule_matches_plain(entry, cuda_device):
    """Each entry of the rule's fixed design at the smallest and the largest
    column count of its range (up to 4096 columns in all), a ragged tile."""
    f = fused_cols.FIXED_COLS[entry]
    for total, up in ((f.least, True), (min(f.most, 4096), False)):
        cols = min(total, 33)
        pre = -(-total // cols) if up else total // cols
        launch = fused_cols.launch_shape(pre, f.h, cols)[0]
        assert (launch.design, launch.tile, launch.cluster) == ("fixed", f.tile, f.cluster), f
        gen = torch.Generator(device=cuda_device).manual_seed(entry + total)
        t = _dev_tables(fused_cols.cols_consts(f.h, "forward", 1.0, "p"), cuda_device)
        x = torch.randn(pre, f.h, 2 * cols, device=cuda_device, generator=gen)
        for adjoint in (False, True):
            assert_close(fused_cols.fused_cols(x, t, adjoint=adjoint).cpu(),
                         fused_cols.fused_cols_reference(x, t, adjoint).cpu(),
                         label=f"{f} ({pre}, {cols}) adjoint={adjoint}")


def test_every_fixed_variant_matches_plain(cuda_device):
    from webgpufft_tpu_torch.probes import variants
    for name, v in variants.FIXED_VARIANTS.items():
        gen = torch.Generator(device=cuda_device).manual_seed(v.h)
        t = _dev_tables(fused_cols.cols_consts(v.h, "inverse", 1.0 / v.h, "p"), cuda_device)
        x = torch.randn(2, v.h, 2 * (v.tile + 1), device=cuda_device, generator=gen)
        for adjoint in (False, True):
            assert_close(variants.cols_fixed_variant(x, t, name, adjoint).cpu(),
                         fused_cols.fused_cols_reference(x, t, adjoint).cpu(),
                         label=f"{name} adjoint={adjoint}")
        assert_close(variants.cols_fixed_variant(x.clone(), t, name, inplace=True).cpu(),
                     fused_cols.fused_cols_reference(x, t).cpu(), label=f"{name} in place")


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    lt = _dev_tables(fused.lines_consts(256, "forward", 1.0, "p"), cuda_device)
    ct = _dev_tables(fused_cols.cols_consts(256, "forward", 1.0, "p"), cuda_device)
    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    bad_lines = [
        torch.zeros(8, 2, 256, device=cuda_device).transpose(1, 2),  # not contiguous
        torch.zeros(8, 256, 2, device=cuda_device, dtype=torch.float64),
        torch.zeros(8, 128, 2, device=cuda_device),                   # wrong N
    ]
    for x in bad_lines:
        with pytest.raises(ValueError):
            fused.fused_lines(x, lt)
    with pytest.raises(ValueError, match="table"):
        fused.fused_lines(torch.zeros(8, 256, 2, device=cuda_device),
                          {**lt, "cw": lt["cw"].cpu()})
    with pytest.raises(ValueError, match="table"):
        fused_cols.fused_cols(torch.zeros(2, 256, 8, device=cuda_device),
                              {**ct, "cp": ct["cp"][:1]})
    with pytest.raises(ValueError):
        fused_cols.fused_cols(torch.zeros(2, 256, 7, device=cuda_device), ct)  # odd L
    assert (fused.fused_lines.launches, fused_cols.fused_cols.launches) == before


@pytest.mark.parametrize("shape,batch,mode", [
    ([1024], 16, "pallas-fused"), ([256, 256], 2, "pallas-fused"),
    ([16, 256, 256], 1, "pallas-fused"), ([12, 18], 3, "pallas-mixed"),
    ([4, 4, 4], 2, "pallas-mixed"), ([6, 101], 2, "pallas-mixed"), ([7, 9], 1, "xla")])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_plan_on_gpu_matches_cpu_plan_and_torch_fft(shape, batch, mode, direction,
                                                   cuda_device):
    opts = {"type": "c2c", "shape": shape, "batch": batch, "direction": direction,
            "normalize": "unitary"}
    plan = T.create_plan(opts, device=cuda_device, cache=T.PlanCache())
    assert plan.route.mode == mode, plan.route.reasons
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(batch, *shape, 2, device=cuda_device, generator=gen)
    y = plan(x)
    assert y.device == x.device and y.dtype == torch.float32
    dims = tuple(range(1, 1 + len(shape)))
    z = torch.view_as_complex(x)
    want = (torch.fft.fftn(z, dim=dims, norm="ortho") if direction == "forward"
            else torch.fft.ifftn(z, dim=dims, norm="ortho"))
    assert_close(y.cpu(), torch.view_as_real(want).cpu(), label=f"{shape} vs torch.fft")
    cpu_plan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert_close(y.cpu(), cpu_plan(x.cpu()), label=f"{shape} cuda vs cpu")


def test_plan_rejects_input_on_another_device(cuda_device):
    plan = T.create_plan({"type": "c2c", "shape": [64], "batch": 8},
                         device=cuda_device, cache=T.PlanCache())
    with pytest.raises(T.PlanError, match="plan is on"):
        plan(torch.zeros(8, 64, 2))


def _rfft_dims(rank):
    """torch.fft.rfftn halves the last dim it is given: list logical axis 0
    (array dim 1) last to pack it as the plans do."""
    return tuple(range(2, 1 + rank)) + (1,)


@pytest.mark.parametrize("shape,kernels", [
    ([64, 64, 64], True),       # digits 8 x 8 and 4 x 8 (the half axis 0): all on K1/K2
    ([64, 256, 256], True),     # body and Nyquist axis 1 on K2, axis 2 on K1
    ([9, 256, 256], True),      # odd n0: the widened plan
    ([6, 256], True),           # half axis 0 of 3: a one-butterfly K2
    ([34, 6], False),           # half axis 0 of 17 and 2 Nyquist lines: K1 only
])
def test_real_plans_on_gpu_match_torch_fft(shape, kernels, cuda_device):
    batch, dims = 3, _rfft_dims(len(shape))
    fwd = T.create_plan({"type": "r2c", "shape": shape, "batch": batch},
                        device=cuda_device, cache=T.PlanCache())
    inv = T.create_plan({"type": "c2r", "shape": shape, "batch": batch,
                         "direction": "inverse", "normalize": "backward"},
                        device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(batch, *shape, device=cuda_device, generator=gen)
    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    y = fwd(x)
    back = inv(y)
    torch.cuda.synchronize()
    launched = (fused.fused_lines.launches - before[0], fused_cols.fused_cols.launches - before[1])
    assert (min(launched) > 0) == kernels, (launched, fwd.route.reasons)
    want = torch.fft.rfftn(x, dim=dims)
    assert_close(y.cpu(), torch.view_as_real(want).cpu(), label=f"r2c {shape}")
    assert_close(back.cpu(), x.cpu(), label=f"c2r(r2c) {shape}")
    assert_close(inv(torch.view_as_real(want).contiguous()).cpu(),
                 torch.fft.irfftn(want, s=shape[1:] + shape[:1], dim=dims).cpu(),
                 label=f"c2r {shape}")


@pytest.mark.parametrize("shape,batch,tuning,kind", [
    ([4093], 4, {}, "rader"), ([101, 256], 2, {}, "rader"),
    ([4099], 4, {}, "bluestein"), ([323], 8, {}, "bluestein"),
    ([65536], 2, {}, "four-step"), ([8192], 2, {"fourStepMinN": 4096}, "four-step"),
    ([4096, 4], 1, {"fourStepMinN": 4096}, "four-step")])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_axis_kinds_on_gpu_match_torch_fft(shape, batch, tuning, kind, direction,
                                           cuda_device):
    plan = T.create_plan({"type": "c2c", "shape": shape, "batch": batch,
                          "direction": direction, "normalize": "backward",
                          "tuning": tuning}, device=cuda_device, cache=T.PlanCache())
    assert kind in plan.route.axis_kinds or any("xla-four-step" in r for r in plan.route.reasons)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(batch, *shape, 2, device=cuda_device, generator=gen)
    y = plan(x)
    dims = tuple(range(1, 1 + len(shape)))
    z = torch.view_as_complex(x)
    want = torch.fft.fftn(z, dim=dims) if direction == "forward" else torch.fft.ifftn(z, dim=dims)
    assert_close(y.cpu(), torch.view_as_real(want).cpu(), label=f"{kind} {shape}")


def test_ns3d_step_on_gpu_matches_torch_fft_step(cuda_device):
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    n, nu, dt = 64, 2e-2, 1e-2
    step, to_s, to_p = ns.make_stepper3(n, nu, dt, device=cuda_device)
    fstep, _, _ = torch_fft_stepper3(n, nu, dt, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    u_hat = to_s(0.1 * torch.randn(3, n, n, n, device=cuda_device, generator=gen))
    assert_close(step(u_hat).cpu(), fstep(u_hat).cpu(), label="NS-3D step 64^3")
    tg = ns.taylor_green_embedded(n, 0.0, nu, device=cuda_device)
    got = ns.run3(tg, n, nu, dt, 4, device=cuda_device)
    assert_close(got.cpu(), ns.taylor_green_embedded(n, 4 * dt, nu, device=cuda_device).cpu(),
                 label="Taylor-Green 64^3")


# ---------------------------------------------------------------------------
# DCT/DST, fftconv, conv2d and the staging pipeline on the card
# ---------------------------------------------------------------------------

def _launched(fn):
    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, (fused.fused_lines.launches - before[0],
                 fused_cols.fused_cols.launches - before[1])


def _trig_oracle(x, shape, kind, direction):
    """Dense trig matrices in float64 on the card."""
    from webgpufft_tpu_torch.utils import mathref
    y = x.double()
    for d, n in enumerate(shape):
        mdir = "forward" if kind[-1] in "14" else direction
        m = torch.as_tensor(mathref.trig_matrix(kind, n, mdir), device=x.device)
        y = torch.movedim(torch.movedim(y, 1 + d, -1) @ m.T, -1, 1 + d)
    return y


@pytest.mark.parametrize("kind", ["dct1", "dct2", "dct3", "dct4", "dst1", "dst2", "dst3", "dst4"])
@pytest.mark.parametrize("shape,batch,want", [
    ((512, 512), 2, (1, 1)),        # K2 on (2, m, 2 * 512), K1 on 1024 lines of m
    ((16, 512, 64), 1, (0, 1)),     # a mid axis on K2, matmul axes around it
    ((8, 8), 64, (0, 0)),           # the matmul route
])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_dct_on_gpu_matches_float64(kind, shape, batch, want, direction, cuda_device):
    plan = T.create_plan({"type": kind, "shape": list(shape), "batch": batch,
                          "direction": direction}, device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(batch, *shape, device=cuda_device, generator=gen)
    y, made = _launched(lambda: plan(x))
    if kind in ("dct1", "dst1") and 512 in shape:
        # work lengths 1022 = 2 * 7 * 73 and 1026 = 2 * 3^3 * 19: Bluestein
        assert made == (0, 0), (made, plan.route.reasons)
    else:
        assert made == want, (made, plan.route.reasons)
    assert_close(y.cpu(), _trig_oracle(x, shape, kind, direction).cpu(),
                 label=f"{kind}{shape} {direction}")


def _torch_fft_conv(x, k, shape, kshape, boundary, mode="convolution"):
    from webgpufft_tpu_torch.utils import mathref
    fft_shape, out_shape, out_off = mathref.fftconv_out_shape(shape, kshape, boundary)
    dims = tuple(range(1, x.ndim))
    kf = torch.fft.fftn(k.to(torch.complex128), s=fft_shape)
    if mode == "correlation":
        kf = kf.conj()
    y = torch.fft.ifftn(torch.fft.fftn(x.to(torch.complex128), s=fft_shape, dim=dims) * kf,
                        dim=dims)
    return y[(slice(None),) + tuple(slice(o, o + n) for o, n in zip(out_off, out_shape))]


@pytest.mark.parametrize("shape,kshape,batch,boundary,mode,want", [
    ([1000, 1000], [25, 25], 2, "linear-same", "convolution", (3, 3)),
    ([1000, 1000], [25, 25], 2, "linear-full", "correlation", (3, 3)),
    ([60, 250], [5, 7], 8, "linear-full", "convolution", (3, 3)),      # fft shape (64, 256)
    ([256], [9], 8, "circular", "convolution", (2, 0)),                 # the lone kernel: einsum
    ([12, 10], [3, 3], 2, "linear-valid", "convolution", (3, 0)),       # 20 lanes: no K2
])
def test_fftconv_on_gpu_matches_torch_fft(shape, kshape, batch, boundary, mode, want,
                                          cuda_device):
    plan = T.create_plan({"type": "fftconv", "shape": shape, "batch": batch,
                          "fftConv": {"kernelShape": kshape, "boundary": boundary,
                                      "mode": mode}}, device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(batch, *shape, 2, device=cuda_device, generator=gen)
    k = torch.randn(*kshape, 2, device=cuda_device, generator=gen)
    y, made = _launched(lambda: plan(x, kernel=k))
    assert made == want, (made, plan.route.reasons)
    ref = _torch_fft_conv(torch.view_as_complex(x), torch.view_as_complex(k), shape, kshape,
                          boundary, mode)
    assert_close(y.cpu(), torch.view_as_real(ref).cpu(), label=f"fftconv {shape} {boundary}")


def test_fftconv_multi_kernel_lanes_on_gpu(cuda_device):
    """Channel-lane gather and scatter with index tensors on the card, and
    ``out=`` merged in place."""
    preset = T.create_fftconv_batch_major_channel_lane_preset({
        "shape": [256], "batch": 4, "kernelCount": 2,
        "input": {"channels": 3, "channelIndex": 1},
        "output": {"channels": 4, "channelIndex": 1, "kernelStepChannels": 2}})
    plan = T.create_plan({"type": "fftconv", **preset}, device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    lanes = torch.randn(4, 3, 256, 2, device=cuda_device, generator=gen)
    k = torch.randn(2, 256, 2, device=cuda_device, generator=gen)
    out = torch.full((4 * 4 * 256, 2), 7.5, device=cuda_device)
    y = plan(lanes.reshape(-1, 2), kernel=k, out=out)
    assert y is out
    got = out.reshape(4, 4, 256, 2)
    for kk in range(2):
        ref = _torch_fft_conv(torch.view_as_complex(lanes[:, 1]), torch.view_as_complex(k[kk]),
                              [256], [256], "circular")
        assert_close(got[:, 1 + 2 * kk].cpu(), torch.view_as_real(ref).cpu(), label=f"lane {kk}")
    assert bool((got[:, 0] == 7.5).all() and (got[:, 2] == 7.5).all())


@pytest.mark.parametrize("n,taps,batch,boundary,block", [
    (1 << 16, 129, 2, "circular", None),          # block 8192 = 64 * 128 on K1
    (1 << 16, 129, 1, "linear-same", None),
    (5000, 33, 3, "linear-full", 360),            # a non-power-of-two block
    (777, 9, 2, "linear-valid", 60),
])
def test_overlap_save_on_gpu_matches_torch_fft(n, taps, batch, boundary, block, cuda_device):
    tuning = {"overlapSave": "on", **({"overlapBlock": block} if block else {})}
    plan = T.create_plan({"type": "fftconv", "shape": [n], "batch": batch,
                          "fftConv": {"kernelShape": [taps], "boundary": boundary,
                                      "tuning": tuning}}, device=cuda_device,
                         cache=T.PlanCache())
    assert plan.route.mode == "overlap-save"
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(batch, n, 2, device=cuda_device, generator=gen)
    k = torch.randn(taps, 2, device=cuda_device, generator=gen)
    y, made = _launched(lambda: plan(x, kernel=k))
    assert made == (2, 0), (made, plan.route.reasons)
    ref = _torch_fft_conv(torch.view_as_complex(x), torch.view_as_complex(k), [n], [taps],
                          boundary)
    assert_close(y.cpu(), torch.view_as_real(ref).cpu(), label=f"overlap-save {n} {boundary}")


@pytest.mark.parametrize("ktype,data", [("real", "real"), ("real", "complex"),
                                        ("complex", "complex")])
def test_conv2d_on_gpu_runs_without_tf32(ktype, data, cuda_device):
    """With cuDNN's TF32 flag ON for the process, on data whose low mantissa
    bits TF32 drops (1 + m * 2^-12), the plan still meets 1e-5: it scopes the
    flag off around its own convolution, and restores it."""
    k, shape, batch = 3, [256, 320], 4
    plan = T.create_plan({"type": "conv2d", "shape": shape, "batch": batch,
                          "conv": {"kernelSize": k, "padding": "same", "kernelType": ktype}},
                         device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    tail = (2,) if data == "complex" else ()
    x = 1.0 + torch.randint(0, 4096, (batch, *plan.in_shape, *tail), device=cuda_device,
                            generator=gen).float() / 4096.0
    w = torch.randn(k, k, *((2,) if ktype == "complex" else ()), device=cuda_device,
                    generator=gen)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y = plan(x, kernel=w)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = was
    xc = torch.view_as_complex(x).to(torch.complex128) if data == "complex" else x.double()
    wc = torch.view_as_complex(w).to(torch.complex128) if ktype == "complex" else w.double()
    xp = torch.nn.functional.pad(xc, (1, 1, 1, 1))
    ref = sum(xp[:, i:i + shape[0], j:j + shape[1]] * wc[i, j]
              for i in range(k) for j in range(k))
    ref = torch.view_as_real(ref) if data == "complex" else ref
    assert_close(y.cpu(), ref.cpu(), label=f"conv2d {data}/{ktype}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conv2d_kernel_gradient_is_deterministic(seed, cuda_device):
    """The conv2d plan's kernel gradient, a sum over every output point,
    runs cuDNN's deterministic algorithm: the same bits in every call, and
    within 1e-5 of max|float64 gradient| at the size of chip_smoke.py's
    autodiff case (8 x 1024 x 1024 around 1.5, zero-mean weights), with the
    TF32 flag on for the process."""
    import torch.nn.functional as F
    plan = T.create_plan({"type": "conv2d", "shape": [1024, 1024], "batch": 8,
                          "conv": {"kernelSize": 3, "padding": "same", "kernelType": "real"}},
                         device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    x = 1.0 + torch.randint(0, 4096, (8, *plan.in_shape), device=cuda_device,
                            generator=gen).float() / 4096.0
    k = torch.randn(3, 3, device=cuda_device, generator=gen).requires_grad_()
    w = torch.randn(8, 1024, 1024, device=cuda_device, generator=gen)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        grads = [torch.autograd.grad((w * plan(x, kernel=k)).sum(), k)[0] for _ in range(3)]
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert all(torch.equal(g, grads[0]) for g in grads)
    kd = k.detach().double().requires_grad_()
    want, = torch.autograd.grad(
        (w.double() * F.conv2d(x.double()[:, None], kd[None, None], padding=1)[:, 0]).sum(), kd)
    assert_close(grads[0].cpu(), want.cpu(), label=f"conv2d kernel gradient seed {seed}")


def test_staging_on_gpu_out_and_in_place_alias(cuda_device):
    """Strided gather and scatter with index tensors on the card; ``out=``
    and inPlace write the caller's tensors; offsets are Python ints."""
    n, batch = 1024, 64
    opts = {"type": "c2c", "shape": [n], "batch": batch, "normalize": "unitary"}
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(batch, n, 2, device=cuda_device, generator=gen)
    ref = torch.view_as_real(torch.fft.fft(torch.view_as_complex(x), norm="ortho"))

    plan = T.create_plan({**opts, "layout": {"inputStrides": [2], "outputStrides": [3]}},
                         device=cuda_device, cache=T.PlanCache())
    span_in, span_out = 2 * (n - 1) + 1, 3 * (n - 1) + 1
    flat = torch.zeros(span_in * batch + 5, 2, device=cuda_device)
    flat[5:].reshape(batch, span_in, 2)[:, ::2] = x
    out = torch.full((span_out * batch + 7, 2), 7.5, device=cuda_device)
    (y, made) = _launched(lambda: plan(flat, out=out, input_offset_elements=5,
                                       output_offset_elements=7))
    assert y is out and made == (1, 0)
    got = out[7:].reshape(batch, span_out, 2)
    assert_close(got[:, ::3].cpu(), ref.cpu(), label="strided in/out with offsets")
    assert bool((got[:, 1::3] == 7.5).all() and (out[:7] == 7.5).all())

    plan = T.create_plan({**opts, "ioView": {"output": {"shape": [n + 8], "offset": [-4]}}},
                         device=cuda_device, cache=T.PlanCache())
    out = torch.full((batch, n + 8, 2), 7.5, device=cuda_device)
    assert plan(x, out=out) is out
    assert_close(out[:, 4:n + 4].cpu(), ref.cpu(), label="keep-outside merge")
    assert bool((out[:, :4] == 7.5).all() and (out[:, n + 4:] == 7.5).all())

    plan = T.create_plan({**opts, "inPlace": True}, device=cuda_device, cache=T.PlanCache())
    xin = x.clone()
    assert plan(xin) is xin
    assert_close(xin.cpu(), ref.cpu(), label="inPlace")


def test_bf16_storage_on_gpu(cuda_device):
    n, batch = 1024, 64
    plan = T.create_plan({"type": "c2c", "shape": [n], "batch": batch,
                          "precision": "bf16-storage"}, device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = (0.5 * torch.randn(batch, n, 2, device=cuda_device, generator=gen)).to(torch.bfloat16)
    y, made = _launched(lambda: plan(x))
    assert y.dtype == torch.bfloat16 and made == (0, 0)
    ref = torch.view_as_real(torch.fft.fft(torch.view_as_complex(x.float())))
    assert_close(y.float().cpu(), ref.cpu(), atol_scale=3e-2, label="bf16-storage c2c")


def test_ns3d_bf16_storage_step_on_gpu(cuda_device):
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    n, nu, dt = 64, 2e-2, 1e-2
    step, to_s, _ = ns.make_stepper3(n, nu, dt, device=cuda_device)
    step_b, _, _ = ns.make_stepper3(n, nu, dt, device=cuda_device, precision="bf16-storage")
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    u_hat = to_s(0.1 * torch.randn(3, n, n, n, device=cuda_device, generator=gen))
    assert_close(step_b(u_hat).cpu(), step(u_hat).cpu(), atol_scale=1e-3,
                 label="bf16-storage step 64^3")


# ---------------------------------------------------------------------------
# autodiff: the kernels' adjoint launch and gradients through the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,lines,direction", [
    (1024, 512, "forward"), (2048, 64, "inverse"), (360, 64, "forward"),
    (2310, 16, "forward"), (8192, 3, "inverse"), (16384, 3, "forward"), (16, 1001, "inverse"),
    (6, 77, "forward"), (1352, 11, "inverse"), (256, 1537, "forward")])
def test_fused_lines_adjoint_launch(n, lines, direction, cuda_device):
    """The adjoint launch against the plain adjoint, and the backward of the
    Function (one more launch) against autograd through the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    u = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    assert_close(fused.fused_lines(u, t, adjoint=True).cpu(),
                 fused.fused_lines_reference(u, t, adjoint=True).cpu(), label="adjoint")
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad((fused.fused_lines_reference(xr, t) * u).sum(), xr)
    xk = x.clone().requires_grad_()
    before = fused.fused_lines.launches
    got, = torch.autograd.grad((fused.fused_lines(xk, t) * u).sum(), xk)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 2      # forward + backward
    assert_close(got.cpu(), want.cpu(), label="backward")


@pytest.mark.parametrize("pre,h,lanes", [
    (4, 256, 512), (3, 360, 130), (2, 7, 128), (2, 16384, 4), (3, 2310, 66), (2, 13, 70),
    (1, 1024, 2048), (3, 128, 8192), (8, 3, 512), (2, 1352, 130)])
def test_fused_cols_adjoint_launch(pre, h, lanes, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    t = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0 / math.sqrt(h), "p"), cuda_device)
    x = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    u = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    assert_close(fused_cols.fused_cols(u, t, adjoint=True).cpu(),
                 fused_cols.fused_cols_reference(u, t, adjoint=True).cpu(), label="adjoint")
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad((fused_cols.fused_cols_reference(xr, t) * u).sum(), xr)
    xk = x.clone().requires_grad_()
    before = fused_cols.fused_cols.launches
    got, = torch.autograd.grad((fused_cols.fused_cols(xk, t) * u).sum(), xk)
    torch.cuda.synchronize()
    assert fused_cols.fused_cols.launches == before + 2
    assert_close(got.cpu(), want.cpu(), label="backward")


def test_function_rules_launch_the_kernel_on_gpu(cuda_device):
    """jvp, vmap and double backward through the Function on CUDA tensors:
    every rule launches the kernel, and an untracked call makes no node."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    t = _dev_tables(fused.lines_consts(256, "forward", 1.0, "p"), cuda_device)
    x = torch.randn(16, 256, 2, device=cuda_device, generator=gen)
    u = torch.randn(16, 256, 2, device=cuda_device, generator=gen)
    assert fused.fused_lines(x, t).grad_fn is None
    before = fused.fused_lines.launches
    _, tang = torch.func.jvp(lambda a: fused.fused_lines(a, t), (x,), (u,))
    assert fused.fused_lines.launches == before + 2      # primal + tangent
    assert_close(tang.cpu(), fused.fused_lines_reference(u, t).cpu(), label="jvp")
    before = fused.fused_lines.launches
    y = torch.func.vmap(lambda a: fused.fused_lines(a, t))(torch.stack([x, u]))
    assert fused.fused_lines.launches == before + 1      # the batch folds into lines
    assert_close(y[1].cpu(), fused.fused_lines_reference(u, t).cpu(), label="vmap")

    def second(fn):
        a = x.clone().requires_grad_()
        g, = torch.autograd.grad(fn(a, t).pow(2).sum(), a, create_graph=True)
        return torch.autograd.grad(g.pow(3).sum(), a)[0]

    assert_close(second(fused.fused_lines).cpu(), second(fused.fused_lines_reference).cpu(),
                 label="double backward")


@pytest.mark.parametrize("opts,kshape", [
    ({"type": "c2c", "shape": [1024], "batch": 64, "normalize": "unitary"}, None),
    ({"type": "c2c", "shape": [16, 8, 256], "batch": 2, "direction": "inverse"}, None),
    ({"type": "c2c", "shape": [4093], "batch": 4}, None),
    ({"type": "r2c", "shape": [32, 16, 64], "batch": 3}, None),
    ({"type": "c2r", "shape": [32, 16, 64], "batch": 3, "direction": "inverse",
      "normalize": "backward"}, None),
    ({"type": "dct2", "shape": [64, 512], "batch": 4, "normalize": "unitary"}, None),
    ({"type": "dst3", "shape": [512], "batch": 16}, None),
    ({"type": "fftconv", "shape": [60, 250], "batch": 8,
      "fftConv": {"kernelShape": [5, 7], "boundary": "linear-same"}}, (5, 7, 2)),
    ({"type": "fftconv", "shape": [1 << 15], "batch": 2,
      "fftConv": {"kernelShape": [33], "boundary": "circular"}}, (33, 2)),
    ({"type": "conv2d", "shape": [64, 64], "batch": 2,
      "conv": {"kernelSize": 3, "kernelType": "complex"}}, (3, 3, 2)),
], ids=["c2c1d", "c2c3d", "rader", "r2c", "c2r", "dct2", "dst3", "fftconv2d", "overlap-save",
        "conv2d"])
def test_plan_gradients_on_gpu_match_cpu_plan(opts, kshape, cuda_device):
    """The gradient through the plan on the card (kernel passes: adjoint
    launches) equals the gradient through the same plan on the CPU (plain
    versions), for the input and the kernel payload."""
    gplan = T.create_plan(opts, device=cuda_device, cache=T.PlanCache())
    cplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    gen = torch.Generator().manual_seed(11)
    shape = gplan.input_shape or (opts["batch"], *gplan.in_shape, 2)
    x = torch.randn(tuple(shape), generator=gen)
    k = torch.randn(kshape, generator=gen) if kshape else None
    grads = []
    for plan, dev in ((gplan, cuda_device), (cplan, "cpu")):
        args = [x.to(dev).requires_grad_()]
        kw = {}
        if k is not None:
            args.append(k.to(dev).requires_grad_())
            kw["kernel"] = args[1]
        y = plan(args[0], **kw)
        w = torch.randn(tuple(y.shape), generator=torch.Generator().manual_seed(12)).to(dev)
        grads.append([g.cpu() for g in torch.autograd.grad((w * y).sum(), args)])
    for got, want in zip(*grads):
        assert_close(got, want, label=f"{opts['type']} gradient")


def test_measured_planner_and_snapshot_on_gpu(cuda_device):
    from webgpufft_tpu_torch.runtime import measure
    cache = T.PlanCache()
    opts = {"type": "c2c", "shape": [1024], "batch": 512, "tuning": {"rigor": "measure"}}
    plan = T.create_plan(opts, device=cuda_device, cache=cache)
    (key, rec), = cache.measured.items()
    assert key.startswith(f"cuda/{torch.cuda.get_device_name(0)}|")
    assert any(r.startswith("measured-winner:") for r in plan.route.reasons)
    assert {"as-requested", "impl=xla"} <= set(rec["trials_ms"])
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(T.export_plan_cache_snapshot(cache), cache=fresh, build=False)
    timer, measure._call_time = measure._call_time, None
    try:
        again = T.create_plan(opts, device=cuda_device, cache=fresh)
    finally:
        measure._call_time = timer
    assert f"measured-cached:{rec['winner']}" in again.route.reasons


def test_golden_corpus_selftest_export_and_trace_on_gpu(cuda_device, tmp_path):
    import os
    from webgpufft_tpu_torch import selftest
    from webgpufft_tpu_torch.runtime import golden, profile, trace
    corpus = os.path.join(os.path.dirname(__file__), "golden_corpus.json")
    for art in golden.load_artifacts(corpus):
        res = golden.compare_golden(art, atol_scale=1e-4, device=cuda_device)
        assert res["ok"], res
    assert selftest.run(device=cuda_device)
    plan = T.create_plan({"type": "c2c", "shape": [1024], "batch": 64}, device=cuda_device)
    x = torch.randn(64, 1024, 2, device=cuda_device)
    loaded = T.load_exported_plan(T.export_plan(plan), device=cuda_device)
    assert torch.equal(loaded(x), plan(x))
    with trace.trace(str(tmp_path)) as prof:
        plan(x)
    text = open(prof.trace_path).read()
    assert "wgfft:c2c" in text and fused.kernel_name(1024) in text
    stats = trace.plan_stats(plan, x)
    assert stats["fused_lines_launches"] == 1 and stats["device_kernels"] >= 1
    assert profile.device_hbm_gbps(cuda_device) > 0
    ms = profile.time_queued(plan, x, runs=3, device=cuda_device)
    assert len(ms) == 3 and all(0 < t < 50 for t in ms)
    r = profile.bench_transform(lambda v: plan(v), x, 1024, 64, iters=5)
    assert r.avg_ms > 0 and r.eff_gbps > 0


# ---- the probe kernels (webgpufft_tpu_torch.probes) -----------------------

@pytest.mark.parametrize("scale", [None, 1.000001])
@pytest.mark.parametrize("shape", [(4096, 2048), (1000, 36), (1, 4)])
@pytest.mark.parametrize("kw", [
    {"mode": "direct"}, {"mode": "direct", "stage_bytes": 4096},
    {"mode": "cp_async", "stages": 2}, {"mode": "cp_async", "stages": 4, "stage_bytes": 8192},
    {"mode": "cp_async", "stages": 4, "stage_bytes": 49152},
    {"mode": "bulk", "stages": 2}, {"mode": "bulk", "stages": 4, "stage_bytes": 8192},
    {"mode": "bulk", "stages": 2, "stage_bytes": 116160}])
def test_stream_copy_kernel_is_bit_equal(kw, shape, scale, cuda_device):
    """Every mode, ragged last tiles (1000 * 36 * 4 bytes is no multiple of a
    stage) and an array smaller than one tile."""
    from webgpufft_tpu_torch import probes
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0])
    x = torch.randn(*shape, device=cuda_device, generator=gen)
    before = probes.stream_copy.launches
    y = probes.stream_copy(x, scale, **kw)
    torch.cuda.synchronize()
    assert probes.stream_copy.launches == before + 1
    assert torch.equal(y, probes.stream_copy_reference(x, scale))


@pytest.mark.parametrize("n,lines", [(1024, 512), (2048, 64), (360, 65), (2310, 16), (16384, 3),
                                     (16, 1001), (6, 77), (256, 1537), (64, 8192), (1352, 11),
                                     (8192, 131), (4096, 5)])
def test_lines_stages_kernel_matches_plain_at_every_stop(n, lines, cuda_device):
    from webgpufft_tpu_torch import probes
    from webgpufft_tpu_torch.core import radix
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, "forward", 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    count = len(radix.radix_chain(n))
    for stop in range(count + 1):
        before = probes.lines_stages.launches
        y = probes.lines_stages(x, t, stop)
        torch.cuda.synchronize()
        assert probes.lines_stages.launches == before + 1
        assert_close(y.cpu(), probes.lines_stages_reference(x, t, stop).cpu(),
                     label=f"P2 n={n} stop={stop}")
    assert torch.equal(probes.lines_stages(x, t, 0), x)
    assert_close(y.cpu(), fused.fused_lines(x, t).cpu(), label=f"P2 n={n} vs K1")


@pytest.mark.parametrize("n,lines,direction", [
    (1024, 512, "forward"), (2048, 64, "inverse"), (360, 65, "forward"), (2310, 16, "inverse"),
    (16384, 3, "forward"), (16, 1001, "inverse"), (6, 77, "forward"), (256, 1537, "forward"),
    (1352, 11, "inverse"), (8192, 131, "forward")])
def test_lines_planes_and_in_place_match_k1(n, lines, direction, cuda_device):
    from webgpufft_tpu_torch import _build, probes
    from webgpufft_tpu_torch.core import radix
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    xp = torch.stack(x.unbind(-1), dim=1).contiguous()
    k1 = fused.fused_lines(x, t)
    before = probes.lines_planes.launches
    yp = probes.lines_planes(xp, t)
    torch.cuda.synchronize()
    assert probes.lines_planes.launches == before + 1
    assert_close(yp.cpu(), probes.lines_planes_reference(xp, t).cpu(), label=f"P3 n={n}")
    assert_close(torch.stack(yp.unbind(1), dim=-1).cpu(), k1.cpu(), label=f"P3 n={n} vs K1")
    chain = radix.radix_chain(n)
    if radix.lines_in_place(n):   # two passes or more, or the packed design
        work = x.clone()
        before = fused.fused_lines.launches
        assert probes.lines_inplace(work, t) is work
        assert fused.fused_lines.launches == before + 1
        assert torch.equal(work, k1)
    else:
        with pytest.raises(ValueError, match="one-pass"):
            probes.lines_inplace(x.clone(), t)
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), x.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), lines, n,
            *_build.chain_arg(chain), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 1   # cudaErrorInvalidValue


def test_probe_wrappers_raise_on_the_card_for_what_the_kernels_refuse(cuda_device):
    from webgpufft_tpu_torch import probes
    t = _dev_tables(fused.lines_consts(64, "forward", 1.0, "p"), cuda_device)
    with pytest.raises(ValueError):
        probes.lines_stages(torch.zeros(4, 64, 2, device=cuda_device), t, 3)
    with pytest.raises(ValueError):
        probes.stream_copy(torch.zeros(4100, device=cuda_device)[1:4097])
    with pytest.raises(ValueError, match="table"):
        probes.lines_planes(torch.zeros(4, 2, 128, device=cuda_device), t)


# ---------------------------------------------------------------------------
# the functional facade and its bridges on the card
# ---------------------------------------------------------------------------

def _launches():
    return fused.fused_lines.launches, fused_cols.fused_cols.launches


def test_facade_device_rule_on_the_card(cuda_device):
    """A CUDA tensor runs on its device through the kernels; numpy input goes
    to the default device, which is the card; a CPU tensor stays on the CPU;
    tensors on two devices raise."""
    import numpy as np
    from webgpufft_tpu_torch import fft as wfft
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    z = torch.randn(512, 1024, dtype=torch.complex64, device=cuda_device, generator=gen)
    before = _launches()
    y = wfft.fft(z)
    assert y.device == cuda_device and y.dtype == torch.float32
    assert _launches() == (before[0] + 1, before[1])
    assert_close(y.cpu(), torch.view_as_real(torch.fft.fft(z)).cpu(), label="facade fft")
    zn = z.cpu().numpy()
    before = _launches()
    yn = wfft.fft(zn.astype(np.complex128))              # numpy, float64: card, float32
    assert yn.device == cuda_device and yn.dtype == torch.float32
    assert _launches() == (before[0] + 1, before[1])
    assert_close(yn.cpu(), y.cpu(), label="numpy in")
    before = _launches()
    yc = wfft.fft(z.cpu())
    assert yc.device.type == "cpu" and _launches() == before
    with pytest.raises(T.PlanError, match="different devices"):
        wfft.fftconvolve(torch.zeros(4, 64, device=cuda_device), torch.zeros(1, 5), axes=(1,))
    with wfft.default_device("cpu"):
        assert wfft.fft(zn).device.type == "cpu"
        assert wfft.fft(z).device == cuda_device         # tensors are never moved


@pytest.mark.parametrize("name,kw", [
    ("rfftn", {}), ("dctn", {"norm": "ortho"}), ("hilbert", {}),
    ("resample", {"num": 3000}), ("welch", {"nperseg": 256}),
])
def test_facade_functions_on_the_card_match_the_cpu(name, kw, cuda_device):
    from webgpufft_tpu_torch import fft as wfft
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(16, 4096, device=cuda_device, generator=gen)
    before = _launches()
    got = getattr(wfft, name)(x, **kw)
    assert sum(_launches()) > sum(before), f"{name}: no kernel launched"
    want = getattr(wfft, name)(x.cpu(), **kw)
    got, want = (got[-1], want[-1]) if isinstance(got, tuple) else (got, want)
    assert got.device == cuda_device
    assert_close(got.cpu(), want, label=name)


def test_facade_stft_istft_on_the_card(cuda_device):
    from webgpufft_tpu_torch import fft as wfft
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(4, 1 << 16, device=cuda_device, generator=gen)
    win = torch.as_tensor(wfft.get_window("hann", 512), device=cuda_device)
    _, _, Z = wfft.stft(x, nperseg=512)
    want = torch.stft(x, n_fft=512, hop_length=256, window=win, center=True,
                      pad_mode="constant", return_complex=True) / win.sum()
    assert_close(Z.cpu(), torch.view_as_real(want).cpu(), label="stft vs torch.stft")
    _, back = wfft.istft(Z, nperseg=512)
    assert_close(back[:, :1 << 16].cpu(), x.cpu(), label="istft(stft(x))")


def test_native_torch_namespace_gradients_on_the_card(cuda_device):
    from webgpufft_tpu_torch import torch_fft
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    z = torch.randn(8, 256, 512, dtype=torch.complex64, device=cuda_device, generator=gen)
    za, zb = z.clone().requires_grad_(True), z.clone().requires_grad_(True)
    before = _launches()
    ya, yb = torch_fft.fft2(za), torch.fft.fft2(zb)
    ga, = torch.autograd.grad(torch.view_as_real(ya).pow(2).sum(), za)
    gb, = torch.autograd.grad(torch.view_as_real(yb).pow(2).sum(), zb)
    after = _launches()
    assert after[0] > before[0] and after[1] > before[1]      # forward and adjoint launches
    assert ya.device == cuda_device and ga.device == cuda_device
    assert_close(torch.view_as_real(ya.detach()).cpu(), torch.view_as_real(yb.detach()).cpu(),
                 label="fft2")
    assert_close(torch.view_as_real(ga).cpu(), torch.view_as_real(gb).cpu(), label="grad fft2")


def test_bridges_run_on_the_card_with_numpy_in_and_out(cuda_device):
    import numpy as np
    import scipy.fft
    from webgpufft_tpu_torch import fftpack, pyfftw
    rng = np.random.default_rng(5)
    z = (rng.standard_normal((256, 1024)) + 1j * rng.standard_normal((256, 1024))
         ).astype(np.complex64)
    want = np.fft.fft(z.astype(np.complex128))
    before = _launches()
    with scipy.fft.set_backend(T.scipy_fft_backend()):
        got = scipy.fft.fft(z)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    assert _launches()[0] == before[0] + 1
    assert_close(np.stack([got.real, got.imag], -1), np.stack([want.real, want.imag], -1),
                 label="scipy backend")
    out = np.zeros_like(z)
    got = pyfftw.FFTW(z, out)()
    assert got is out
    assert_close(np.stack([got.real, got.imag], -1), np.stack([want.real, want.imag], -1),
                 label="pyfftw")
    import scipy.fftpack
    pk = fftpack.rfft(z.real.copy())
    assert pk.device == cuda_device
    assert_close(pk.cpu(), scipy.fftpack.rfft(z.real.astype(np.float64)), label="fftpack.rfft")


def test_wrappers_log_what_they_launched_while_a_log_is_set(cuda_device):
    """``fused_lines.seen`` / ``fused_cols.seen``: a caller's dict gets the
    tables of every launch under its shape, and nothing is kept once it is
    unset (``chip_smoke.py`` reads the paths' shapes from it)."""
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.core import fused, fused_cols
    plan = T.create_plan(type="c2c", shape=[64, 256], batch=4, device=cuda_device)
    x = torch.randn(4, 64, 256, 2, device=cuda_device)
    fused.fused_lines.seen, fused_cols.fused_cols.seen = k1, k2 = {}, {}
    try:
        plan(x)
        plan(x)
    finally:
        fused.fused_lines.seen = fused_cols.fused_cols.seen = None
    plan(x)
    assert [key[:3] for key in k1] == [(256, 4 * 64, False)]
    assert [key[:4] for key in k2] == [(4, 64, 512, False)]
    (tables,) = k1.values()
    y = fused.fused_lines(x.reshape(256, 256, 2), tables)
    ref = fused.fused_lines_reference(x.reshape(256, 256, 2), tables)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())



# ---------------------------------------------------------------------------
# the dispatcher ops, the exported pipeline, NUFFT and linalg on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,shape,n", [("fused_lines", (64, 1024, 2), 1024),
                                            ("fused_cols", (4, 256, 512), 256)])
@pytest.mark.parametrize("adjoint", [False, True])
def test_kernel_ops_opcheck_on_the_card(kernel, shape, n, adjoint, cuda_device):
    """``torch.library.opcheck`` of the CUDA implementations (schema, fake
    implementation, autograd, AOT dispatch), then each against its plain
    version on the same input, and the op counting its launch."""
    mod = fused if kernel == "fused_lines" else fused_cols
    consts = (fused.lines_consts(n, "forward", 1.0, "p") if mod is fused
              else fused_cols.cols_consts(n, "forward", 1.0, "p"))
    named = _dev_tables(consts, cuda_device)
    tables = mod.table_list(named)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(*shape, device=cuda_device, generator=gen)
    torch.library.opcheck(getattr(mod, f"{kernel}_op"), (x.clone().requires_grad_(), tables,
                                                         adjoint))
    before = getattr(mod, kernel).launches
    y = getattr(torch.ops.wgfft, kernel)(x, tables, adjoint)
    torch.cuda.synchronize()
    assert getattr(mod, kernel).launches == before + 1
    plain = fused.fused_lines_reference if mod is fused else fused_cols.fused_cols_reference
    assert_close(y.cpu(), plain(x, named, adjoint).cpu())


def test_exported_pipeline_counts_its_launches_on_the_card(cuda_device):
    """A pipeline exported on the card and loaded back launches K1 through
    the op at every call, counted there, and equals the eager call."""
    x = torch.randn(8, 1 << 14, device=cuda_device)

    def pipe_fn(sig):
        _, _, z = T.fft.stft(sig, nperseg=1024, noverlap=512)
        z = z * ((z[..., 0] ** 2 + z[..., 1] ** 2) > 1e-3)[..., None]
        return T.fft.istft(z, nperseg=1024, noverlap=512)[1]

    pipe = T.load_exported_pipeline(T.export_pipeline(pipe_fn, x))
    assert pipe.platforms == ("cuda",)
    before = fused.fused_lines.launches
    got = pipe(x)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches > before
    assert_close(got.cpu(), pipe_fn(x).cpu(), 1e-6)


def test_nufft2d1_on_the_card_matches_the_cpu(cuda_device):
    import numpy as np
    rng = np.random.default_rng(5)
    m, n = 2000, (24, 32)
    x, y = rng.uniform(0, 2 * np.pi, m), rng.uniform(0, 2 * np.pi, m)
    c = rng.standard_normal((3, m, 2)).astype(np.float32)
    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    got = T.nufft.nufft2d1(x, y, torch.from_numpy(c).to(cuda_device), n)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert fused.fused_lines.launches > before[0] and fused_cols.fused_cols.launches > before[1]
    want = T.nufft.nufft2d1(x, y, torch.from_numpy(c), n)
    assert_close(got.cpu(), want)


def test_solve_toeplitz_on_the_card_matches_scipy(cuda_device):
    import numpy as np
    import scipy.linalg as sla
    c = 0.5 ** np.arange(512)
    b = np.random.default_rng(6).standard_normal((512, 4))
    got = T.linalg.solve_toeplitz(c, torch.from_numpy(b).to(cuda_device))
    assert got.device.type == "cuda"
    assert_close(got.cpu(), sla.solve_toeplitz(c, b), 5e-4)


# ---------------------------------------------------------------- DSP toolboxes

def test_toolboxes_take_numpy_to_the_card(cuda_device):
    """numpy in: the filters, the splines and the Fourier filters run on
    the card (the facade's default device); lsim's recurrence too, numpy
    out as from the JAX package."""
    import numpy as np
    import scipy.signal as ss
    x = np.random.default_rng(7).standard_normal((2, 300))
    b, a = ss.butter(3, 0.2)
    im = np.random.default_rng(7).standard_normal((32, 40))
    for y in (T.filtering.lfilter(b, a, x), T.filtering.sosfilt(ss.butter(4, 0.2, output="sos"), x),
              T.filtering.savgol_filter(x, 11, 3), T.splines.cspline2d(im),
              T.ndimage.fourier_gaussian(x, 1.5)):
        assert y.device.type == "cuda" and y.dtype == torch.float32
    _, yl, xl = T.ltisys.lsim(ss.butter(2, 4, analog=True), np.ones(100), np.linspace(0, 2, 100))
    assert isinstance(yl, np.ndarray) and isinstance(xl, np.ndarray)
    _, ye, _ = ss.lsim(ss.butter(2, 4, analog=True), np.ones(100), np.linspace(0, 2, 100))
    assert_close(yl, ye, 2e-4)


@pytest.mark.parametrize("K", [2, 4])
def test_iir_gate_on_the_card_picks_the_route_and_both_agree(K, cuda_device, monkeypatch):
    """Above the CUDA threshold the parallel prefix runs, below it the
    sequential loop; the two give the same result within 1e-5."""
    import numpy as np
    import scipy.signal as ss
    F = T.filtering
    b, a = ss.butter(K, 0.2)
    gate = F.IIR_ASSOC_MIN_N_CUDA
    assert gate is not None
    n = max(2 * gate, 512)
    x = torch.from_numpy(np.random.default_rng(K).standard_normal((8, n)).astype(np.float32))
    x = x.to(cuda_device)
    routes = []
    real_assoc, real_seq = F._iir_assoc, F._iir_seq
    monkeypatch.setattr(F, "_iir_assoc", lambda *v: routes.append("assoc") or real_assoc(*v))
    monkeypatch.setattr(F, "_iir_seq", lambda *v: routes.append("seq") or real_seq(*v))
    y_above = F.lfilter(b, a, x)
    short = F.lfilter(b, a, x[:, :gate - 1]) if gate > 1 else None
    assert routes[0] == "assoc" and (short is None or routes[1] == "seq"), routes
    z0 = torch.zeros(8, K, device=cuda_device)
    bp, ap = b / a[0], a / a[0]
    y_seq, _ = real_seq(bp, ap, x, z0)
    assert_close(y_above.cpu(), y_seq.cpu(), 1e-5)
    assert_close(y_above.cpu(), ss.lfilter(b, a, x.cpu().numpy().astype(np.float64)), 2e-4)


def test_tf32_scope_holds_on_the_card(cuda_device):
    """With TF32 switched on by the caller, the parallel prefix, lsim and
    savgol (its edge rule, and the plan layer's einsum transform of its
    taps) stay at full float32 against scipy (the JAX tests' bars), and the
    caller's setting is back afterwards."""
    import numpy as np
    import scipy.signal as ss
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 4096)).astype(np.float32)
    b, a = ss.butter(4, 0.2)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        xt = torch.from_numpy(x).to(cuda_device)
        y, _ = T.filtering._iir_assoc(b, a, xt, torch.zeros(4, 4, device=cuda_device))
        sg = T.filtering.savgol_filter(xt, 101, 3)
        T_ = np.linspace(0, 5, 2000)
        _, yl, _ = T.ltisys.lsim(ss.butter(3, 4, analog=True), np.sin(T_), T_)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert_close(y.cpu(), ss.lfilter(b, a, x.astype(np.float64)), 1e-5)
    assert_close(sg.cpu(), ss.savgol_filter(x.astype(np.float64), 101, 3), 1e-4)
    _, ye, _ = ss.lsim(ss.butter(3, 4, analog=True), np.sin(T_), T_)
    assert_close(yl, ye, 2e-4)


def test_fir_lfilter_launches_k1(cuda_device):
    """FIR lfilter is the plan layer's convolution: it launches K1, and
    agrees with scipy."""
    import numpy as np
    import scipy.signal as ss
    x = np.random.default_rng(9).standard_normal((8, 1 << 16)).astype(np.float32)
    h = ss.firwin(129, 0.2)
    before = fused.fused_lines.launches
    y = T.filtering.lfilter(h, 1.0, torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert fused.fused_lines.launches > before
    assert_close(y.cpu(), ss.lfilter(h, 1.0, x.astype(np.float64)), 1e-5)


def test_einsum_route_gradient_holds_full_f32_with_tf32_on(cuda_device):
    """The einsum route's backward products run in full float32 as its
    forward does: with the caller's TF32 flag on, the gradient of an
    einsum-route plan equals (to 1e-5) the gradient with it off, on data
    whose low mantissa bits TF32 would drop."""
    import numpy as np
    rng = np.random.default_rng(11)
    plan = T.create_plan({"type": "c2c", "shape": [1000], "batch": 64,
                          "tuning": {"impl": "xla"}}, device=cuda_device,
                         cache=T.PlanCache())
    x0 = torch.from_numpy((1.0 + rng.standard_normal((64, 1000, 2)) * 1e-3)
                          .astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.standard_normal((64, 1000, 2)).astype(np.float32)).to(cuda_device)

    def grad():
        x = x0.clone().requires_grad_()
        g, = torch.autograd.grad((plan(x) * w).sum(), x)
        return g

    m = torch.backends.cuda.matmul
    saved = m.fp32_precision
    try:
        m.allow_tf32 = False
        g_off = grad()
        m.allow_tf32 = True
        g_on = grad()
        assert m.fp32_precision == "tf32"
    finally:
        if saved == "none":
            m.fp32_precision = "none"
        else:
            m.allow_tf32 = saved == "tf32"
    assert_close(g_on.cpu(), g_off.cpu(), 1e-5)


def test_distributed_export_round_trip_on_the_card(cuda_device):
    """export_distributed_plan -> load_exported_plan -> ep(x, mesh=) in a
    one-rank NCCL world: the served output equals the live plan's, on the
    card, for the four-step c2c and the halo fftconv routes."""
    import datetime
    import torch.distributed as dist
    from webgpufft_tpu_torch.parallel import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=cuda_device, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh({"sp": 1}, device="cuda")
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        for opts, kshape in [({"type": "c2c", "shape": [1 << 16], "batch": 4}, None),
                             ({"type": "fftconv", "shape": [1 << 16], "batch": 4,
                               "fftConv": {"boundary": "linear-same",
                                           "kernelShape": [33]}}, (33, 2))]:
            plan = T.create_distributed_plan(opts, mesh=mesh, seq_axis="sp")
            ep = T.load_exported_plan(T.export_distributed_plan(plan))
            x = torch.randn(4, 1 << 16, 2, device=cuda_device, generator=gen)
            args = [x] if kshape is None else [x, torch.randn(kshape, device=cuda_device,
                                                              generator=gen)]
            y = ep(*args, mesh=mesh)
            assert y.device.type == "cuda" and ep.distributed["nr_devices"] == 1
            live = plan(x, **({} if kshape is None else {"kernel": args[1]}))
            assert torch.equal(y.full_tensor(), live.full_tensor())
    finally:
        dist.destroy_process_group()


def test_training_step_kernel_gradient_on_the_card(cuda_device):
    """One step of the system-identification example: the loss's gradient
    with respect to the kernel through the fftconv plan on the card (K1
    forward, then its adjoint launch) against autograd through the plain
    versions (the same model on the CPU).  n + klen - 1 = 4096 puts the
    convolution on K1 (the example's own 544 runs Bluestein einsums)."""
    from webgpufft_tpu_torch.examples import system_identification as ex
    n, klen, batch = 4064, 33, 8
    x, k_true, eps = ex.make_problem(n, klen, batch, 1e-3)
    y = ex.observations(x, k_true, eps)
    k0 = torch.linspace(-0.1, 0.2, klen)
    grads = []
    for dev in (cuda_device, "cpu"):
        model, _ = ex.make_model(n, klen, batch, device=dev)
        xt = torch.from_numpy(x).to(dev)
        k = k0.to(dev).requires_grad_()
        before = fused.fused_lines.launches
        loss = ((model(k, torch.stack([xt, torch.zeros_like(xt)], -1))
                 - torch.from_numpy(y).to(dev)) ** 2).mean()
        g, = torch.autograd.grad(loss, k)
        if dev != "cpu":
            assert fused.fused_lines.launches - before >= 2     # forward and adjoint
        grads.append(g.cpu())
    assert_close(grads[0], grads[1], label="d loss / d kernel")


# The split probe (the plans' library's wgfft_cluster_split and
# wgfft_general_cols_split): the plans' kernel bodies of the cluster design
# (in the kernel of the entry's CTAs an SM) and of K2's general design,
# stopped after the load or after a pass.  Every cluster entry of K1 and K2,
# and the general entries of the paths' heights and one height of each class.
SPLIT_GENERAL_HEIGHTS = sorted({1078, 1080, 1920, 6561} | {
    next(g.h for g in fused_cols.GENERAL_COLS if g.points == e)
    for e in {g.points for g in fused_cols.GENERAL_COLS}})
SPLIT_CASES = ([("K1", n) for n in sorted(radix.CLUSTER_LINES)]
               + [("cluster", h) for h in sorted({g.h for g in fused_cols.CLUSTER_COLS})]
               + [("general", h) for h in SPLIT_GENERAL_HEIGHTS])


@pytest.mark.parametrize("design,h", SPLIT_CASES)
def test_split_probe_runs_the_plans_kernel(design, h, cuda_device):
    """At each view of the entries of height (length) h: the split probe run
    whole (``variants.STOP_ALL``) is bitwise the plans' variant launch,
    forward and adjoint, and matches the plain version; every stop 0 ..
    count launches in place on the view and leaves it as it was (a stopped
    launch writes shared memory only), on an 8-byte offset view too."""
    from webgpufft_tpu_torch.probes import variants
    extra = {}
    if design == "K1":
        line = radix.CLUSTER_LINES[h]
        views = [(3, 1, line.chain, line.points, (1, line.clusters))]
        extra = {"ctas": line.ctas}
    else:
        pick = _cluster_views if design == "cluster" else _general_views
        views = [(pre, cols, g.chain, g.points,
                  (g.tile, g.clusters) if design == "cluster" else (g.tile,))
                 for pre, cols, g in pick(h)]
    run = variants.general_cols_variant if design == "general" else variants.cluster_variant
    for pre, cols, chain, points, shape in views:
        t = _dev_tables(radix.chain_consts(h, "forward", 1.0, "p", chain), cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(h * cols)
        base = torch.randn(pre * h * cols + 1, 2, device=cuda_device, generator=gen)
        label = f"split {design} ({pre}, {h}, {2 * cols}) {chain} {points} points {shape}"
        for off in (0, 1):
            x = base[off:off + pre * h * cols].view(pre, h, 2 * cols)
            for adj in (False, True):
                whole = run(x, t, chain, points, *shape, adj, stop=variants.STOP_ALL, **extra)
                plans = run(x, t, chain, points, *shape, adj, **extra)
                assert torch.equal(whole, plans), f"{label} adjoint {adj}"
                want = radix.radix_chain_reference(x.reshape(pre, h, cols, 2), chain, t, adj)
                assert_close(whole.cpu(), want.reshape(x.shape).cpu(), label=label)
            for stop in range(len(chain) + 1):
                work = base.clone()
                run(work[off:off + pre * h * cols].view(pre, h, 2 * cols), t, chain, points,
                    *shape, inplace=True, stop=stop, **extra)
                torch.cuda.synchronize()
                assert torch.equal(work, base), f"{label} offset {off} stop {stop}"
