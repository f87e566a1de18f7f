"""Probe: what each pass of K1's radix chain costs on the card.

    python3 chip_probes/k1_stages.py        (from the repository root)

Times ``webgpufft_tpu_torch.probes.lines_stages`` (``csrc/probes/lines_stages.cu``:
K1's chain stopped after ``stop`` passes, same bytes read and written at every
stop) for every stop at the line shapes of the main paths, each checked
against the plain version first, and prints the difference between
neighbouring stops: the cost of that pass.  ``stop = 0`` is the copy through
shared memory every stop contains; ``stop = count`` is K1's transform plus one
more trip through shared memory than K1 makes, so K1 itself, ``Tensor.copy_``
and the bound stand beside.  The counterpart of ``benches/r2_pallas_probe.py``.
Needs a GPU.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from webgpufft_tpu_torch.core import fused, radix  # noqa: E402
from webgpufft_tpu_torch.probes import stages  # noqa: E402
from webgpufft_tpu_torch.runtime import profile  # noqa: E402

CASES = [(1024, 4096), (2048, 4096), (4096, 4096), (256, 98304), (360, 4096), (512, 4096),
         (8192, 131), (16384, 512)]
TOL = 1e-5


def device_ms(fn):
    return profile.median(profile.time_queued(fn))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_stages: needs an NVIDIA GPU")
    card = profile.card_line()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n, lines in CASES:
        chain = radix.radix_chain(n)
        tables = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
                  for k, v in fused.lines_consts(n, "forward", 1.0 / n ** 0.5, "p").items()}
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        y = torch.empty_like(x)
        bound = profile.bound_ms(16 * n * lines, 0.0)[0]
        k1 = device_ms(lambda: fused.fused_lines(x, tables))
        copy_ms = device_ms(lambda: y.copy_(x))
        print(f"N={n} x {lines} lines, chain {chain}: bound {bound:.4f} ms, Tensor.copy_ "
              f"{copy_ms:.4f} ms, K1 {k1:.4f} ms [{card}]")
        before = None
        for stop in range(len(chain) + 1):
            got = stages.lines_stages(x, tables, stop)
            want = stages.lines_stages_reference(x, tables, stop)
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            if err > TOL:
                raise AssertionError(f"N={n} stop={stop}: rel err {err:.3e}")
            del got, want
            ms = device_ms(lambda: stages.lines_stages(x, tables, stop))
            what = ("copy through shared memory" if stop == 0
                    else f"+ pass {stop} (radix {chain[stop - 1]})")
            delta = "" if before is None else f", + {ms - before:.4f} ms over stop {stop - 1}"
            print(f"    stop {stop} {what}: {ms:.4f} ms (share of the bound {bound / ms:.2f}"
                  f"{delta}; rel err {err:.1e}) [{card}]")
            before = ms
        print(f"    stop {len(chain)} over K1 (one more trip through shared memory): "
              f"+ {before - k1:.4f} ms")


if __name__ == "__main__":
    main()
