"""Probe: what the interleaved layout and a separate output cost K1.

    python3 chip_probes/k1_layouts.py       (from the repository root)

Times, at the line shapes of the main paths and in one process: K1
(``fused.fused_lines``, interleaved, out of place), K1 in place
(``probes.lines_inplace``), the same transform on re/im-split planes
(``probes.lines_planes``, ``csrc/probes/lines_planes.cu``), the direct copy of
the same bytes (``probes.stream_copy``), ``Tensor.copy_``, ``torch.fft.fft`` and
the bound; the probes are checked against their plain versions first.  The
counterpart of ``benches/r26_pallas_endgame.py``.  Needs a GPU.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from webgpufft_tpu_torch.core import fused  # noqa: E402
from webgpufft_tpu_torch.probes import planes, stream  # noqa: E402
from webgpufft_tpu_torch.runtime import profile  # noqa: E402

CASES = [(1024, 4096), (256, 98304), (4096, 4096), (2048, 4096), (512, 4096)]
TOL = 1e-5


def device_ms(fn):
    return profile.median(profile.time_queued(fn))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_layouts: needs an NVIDIA GPU")
    card = profile.card_line()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n, lines in CASES:
        tables = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
                  for k, v in fused.lines_consts(n, "forward", 1.0 / n ** 0.5, "p").items()}
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        xp = torch.stack(x.unbind(-1), dim=1).contiguous()
        want = fused.fused_lines(x, tables)
        got = planes.lines_planes(xp, tables)
        ref = planes.lines_planes_reference(xp, tables)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max() / ref.abs().max())
        if err > TOL:
            raise AssertionError(f"N={n}: planes rel err {err:.3e}")
        work = x.clone()
        same = torch.equal(planes.lines_inplace(work, tables), want)
        if not same:
            raise AssertionError(f"N={n}: K1 in place differs from K1 out of place")
        del got, ref, want
        y = torch.empty_like(x)
        bound = profile.bound_ms(16 * n * lines, 0.0)[0]
        rows = [("K1 interleaved, out of place", lambda: fused.fused_lines(x, tables)),
                ("K1 in place", lambda: planes.lines_inplace(work, tables)),
                ("planes (lines, 2, N)", lambda: planes.lines_planes(xp, tables)),
                ("direct copy (stream_copy)", lambda: stream.stream_copy(x)),
                ("Tensor.copy_", lambda: y.copy_(x)),
                ("torch.fft.fft", lambda: torch.fft.fft(torch.view_as_complex(x)))]
        print(f"N={n} x {lines} lines: bound {bound:.4f} ms; planes rel err {err:.1e}, "
              f"in place bit-equal [{card}]")
        for label, fn in rows:
            ms = device_ms(fn)
            print(f"    {label}: {ms:.4f} ms (share of the bound {bound / ms:.2f}) [{card}]")


if __name__ == "__main__":
    main()
