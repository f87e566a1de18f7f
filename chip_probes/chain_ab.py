"""Probe: one length, several radix chains, on the card.

    python3 chip_probes/chain_ab.py         (from the repository root)

K1's and K2's C entry points run whatever chain they are handed, so this
times the chain ``radix.radix_chain`` chooses beside alternatives (radix 8
and 4 only, another order) on the shapes of the main paths, each checked
against ``torch.fft`` first.  Needs a GPU.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from webgpufft_tpu_torch import _build  # noqa: E402
from webgpufft_tpu_torch.core import radix  # noqa: E402
from webgpufft_tpu_torch.runtime.profile import card_line, median, time_queued  # noqa: E402

K1_CASES = [(1024, 4096, [(8, 8, 4, 4), (8, 8, 16)]), (256, 98304, [(8, 8, 4)]),
            (2048, 4096, [(8, 8, 8, 4)]), (4096, 4096, [(8, 8, 8, 8)]),
            (16384, 512, [(8, 8, 8, 8, 4)]), (64, 65536, [(16, 4)]), (128, 65536, [(8, 4, 4)]),
            (360, 4096, [(5, 3, 3, 8)])]
K2_CASES = [(256, 256, 512, [(8, 8, 4)]), (768, 256, 512, [(8, 8, 4)]),
            (384, 128, 512, [(8, 4, 4)]), (256, 16, 512, [(4, 4)]), (64, 64, 128, [(16, 4)])]


def device_ms(fn):
    return median(time_queued(fn))


def tables(n, chain):
    return (torch.as_tensor(radix.chain_twiddles(n, "forward", chain), device="cuda"),
            torch.tensor([1.0, -1.0], device="cuda"))


def run(entry, x, y, dims, chain, cw, cp):
    rc = entry(x.data_ptr(), y.data_ptr(), cw.data_ptr(), cp.data_ptr(), *dims,
               *_build.chain_arg(tuple(chain)), 0,  # 0: the transform, not its adjoint
               torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "chain_ab")


def ab(label, entry, x, dims, want, chains):
    y = torch.empty_like(x)
    print(label)
    for chain in chains:
        cw, cp = tables(x.shape[1], chain)
        run(entry, x, y, dims, chain, cw, cp)
        torch.cuda.synchronize()
        err = float((y - want).abs().max() / want.abs().max())
        if err > 1e-5:
            raise AssertionError(f"{label} chain {chain}: rel err {err:.3e}")
        ms = device_ms(lambda: run(entry, x, y, dims, chain, cw, cp))
        print(f"    chain {chain}: {ms:.4f} ms (rel err {err:.1e})")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chain_ab: needs an NVIDIA GPU")
    print(card_line())
    lib = _build.library()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n, lines, others in K1_CASES:
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        z = torch.view_as_complex(x)
        lib_ms = device_ms(lambda: torch.fft.fft(z))
        ab(f"K1 N={n} x {lines} lines: bound {16 * n * lines / 3.35e9:.4f} ms, "
           f"torch.fft.fft {lib_ms:.4f} ms", lib.wgfft_fused_lines, x, (lines, n),
           torch.view_as_real(torch.fft.fft(z)), [radix.radix_chain(n)] + others)
    for pre, h, lanes, others in K2_CASES:
        x = torch.randn(pre, h, lanes, device="cuda", generator=gen)
        z = torch.view_as_complex(x.view(pre, h, lanes // 2, 2))
        lib_ms = device_ms(lambda: torch.fft.fft(z, dim=1))
        ab(f"K2 view ({pre}, {h}, {lanes}): bound {8 * pre * h * lanes / 3.35e9:.4f} ms, "
           f"torch.fft.fft {lib_ms:.4f} ms", lib.wgfft_fused_cols, x, (pre, h, lanes // 2),
           torch.view_as_real(torch.fft.fft(z, dim=1)).reshape(pre, h, lanes),
           [radix.radix_chain(h)] + others)


if __name__ == "__main__":
    main()
