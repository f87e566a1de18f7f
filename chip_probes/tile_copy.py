"""Probe: what K2's access pattern alone costs on the card.

    python3 chip_probes/tile_copy.py        (from the repository root)

Times, on the views the 256^3 plans give K2, a copy in K2's tiles (h rows by
16, 32, 64 or 128 complex columns a CTA; ``csrc/probes/tile_copy.cu``, built
with the other probe kernels at first use) beside ``Tensor.copy_`` and K2
itself.  Needs a GPU.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from webgpufft_tpu_torch import _build  # noqa: E402
from webgpufft_tpu_torch.core import fused_cols  # noqa: E402
from webgpufft_tpu_torch.runtime.profile import card_line, median, time_queued  # noqa: E402


def device_ms(fn):
    return median(time_queued(fn))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tile_copy: needs an NVIDIA GPU")
    print(card_line())
    lib = _build.library("probes")
    stream = torch.cuda.current_stream().cuda_stream
    for pre, h, lanes in [(256, 256, 512), (768, 256, 512), (384, 128, 512), (1, 256, 131072)]:
        x = torch.randn(pre, h, lanes, device="cuda")
        y = torch.empty_like(x)
        tables = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
                  for k, v in fused_cols.cols_consts(h, "forward", 1.0, "p").items()}
        print(f"view ({pre}, {h}, {lanes}): bound {8 * pre * h * lanes / 3.35e9:.4f} ms, "
              f"Tensor.copy_ {device_ms(lambda: y.copy_(x)):.4f} ms, "
              f"K2 {device_ms(lambda: fused_cols.fused_cols(x, tables)):.4f} ms")
        for tile_floats, width, threads in [(32, 2, 256), (64, 2, 512), (128, 4, 512),
                                            (256, 4, 512)]:
            def copy():
                rc = lib.probe_tile_copy(x.data_ptr(), y.data_ptr(), pre, h, lanes, tile_floats,
                                         width, threads, stream)
                _build.check(rc, "probe_tile_copy", "probes")
            y.zero_()
            copy()
            torch.cuda.synchronize()
            if not torch.equal(x, y):
                raise AssertionError("tile copy is not a copy")
            print(f"    tile copy, {tile_floats // 2} columns a CTA, {4 * width} bytes a thread, "
                  f"{threads} threads: {device_ms(copy):.4f} ms")


if __name__ == "__main__":
    main()
