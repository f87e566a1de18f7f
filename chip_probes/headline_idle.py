"""Probe: what one headline call costs from an idle device, for one checkout.

    python3 chip_probes/headline_idle.py [--repo DIR]   (from the repository root)

Imports ``webgpufft_tpu_torch`` from DIR (default: this repository), so that
two checkouts, e.g. a parent commit unpacked with ``git archive`` and this
one, are timed in one call on one card: parent, change, change, parent.
Prints the headline plan ``create_plan(c2c [1024] x 4096)(x)`` from an idle
device (one event pair around one call, the host's share included) and
queued behind device work, and K1 alone at that shape launched directly,
through ``FusedLines.apply`` and, where the checkout has it, through the
dispatcher op ``torch.ops.wgfft.fused_lines``.  Needs a GPU.
"""

import argparse
import sys
from pathlib import Path

import torch

HEADLINE = {"type": "c2c", "shape": [1024], "batch": 4096,
            "direction": "forward", "normalize": "unitary"}
RUNS = 200


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("headline_idle: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.core import fused
    from webgpufft_tpu_torch.runtime.profile import card_line, median, time_calls, time_queued

    print(f"headline_idle: {Path(T.__file__).parent} [{card_line()}]")
    plan = T.create_plan(HEADLINE, device="cuda")
    x = torch.randn(4096, 1024, 2, device="cuda")
    want = torch.view_as_real(torch.fft.fft(torch.view_as_complex(x), norm="ortho"))
    err = float((plan(x) - want).abs().max() / want.abs().max())
    if err > 1e-5:
        raise AssertionError(f"headline plan: max rel err {err:.3e} vs torch.fft")
    tables = {k.rsplit("/", 1)[1]: v for k, v in plan.consts.items()
              if k.rsplit("/", 1)[1] in fused.TABLE_NAMES}
    rows = [("plan(x)", plan, (x,)), ("K1 direct", fused.fused_lines, (x, tables)),
            ("K1 FusedLines.apply", fused.FusedLines.apply, (x, tables, False))]
    if hasattr(fused, "fused_lines_op"):
        rows.append(("K1 op", fused.fused_lines_op, (x, fused.table_list(tables), False)))
    for label, fn, fargs in rows:
        idle = median(time_calls(fn, *fargs, runs=RUNS))
        queued = median(time_queued(fn, *fargs))
        print(f"headline_idle {label}: {idle:.4f} ms idle / {queued:.4f} ms queued "
              f"(median of {RUNS} idle calls)")


if __name__ == "__main__":
    main()
