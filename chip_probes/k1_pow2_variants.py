"""Probe: K1's power-of-two and warp designs in each variant, beside the plans' launch.

    python3 chip_probes/k1_pow2_variants.py [--n 1024 512 ...] [--lines 131 512 1024]
                                            [--out PATH]   (from the repository root)

For every variant of ``probes.variants.LINES_VARIANTS`` (one instantiation
of ``csrc/lines_pow2.cuh``, one line a CTA, or of ``csrc/lines_warp.cuh``,
a line in the lanes of a warp: length, threads a CTA, lanes a line, CTAs an
SM asked for, chain) whose length ``--n`` names (default: every length) and
every line count (``--lines``; default, the counts the paths launch at a
short length, ``PATH_LINES``, and 131, 512 and 1024 at a long one): the
CTAs an SM holds (the CUDA occupancy
calculator), a check against K1's plain version (1e-5 of max|plain|,
forward, adjoint and in place), then device time (``runtime/profile.
time_queued``) in turns, the variants of one length in order and in
reverse, beside the plans' own launch of that length (``fused.fused_lines``,
whichever design K1's rule gives it), ``torch.fft.fft`` (cuFFT, unscaled)
and the bound (one read and one write at 3.35 TB/s).  With ``--out PATH``
one JSON line a shape is also written to PATH.  Needs a GPU.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from webgpufft_tpu_torch.core import fused, radix  # noqa: E402
from webgpufft_tpu_torch.probes import variants  # noqa: E402
from webgpufft_tpu_torch.runtime import profile  # noqa: E402

TOL = 1e-5
# the line counts the paths launch at the short lengths (PERF.md's rows)
PATH_LINES = {1024: [4096, 8192], 512: [4096], 256: [65536, 98304], 32: [1536],
              64: [65536], 128: [196608, 1024]}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", help="only the variants of these lengths")
    ap.add_argument("--lines", type=int, nargs="+",
                    help="line counts (default: PATH_LINES, or 131 512 1024)")
    ap.add_argument("--out", type=Path, help="also write one JSON line a shape here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_pow2_variants: needs an NVIDIA GPU")
    card = profile.card_line()
    print(f"k1_pow2_variants [{card}]", flush=True)
    by_n = {}
    for name, v in variants.LINES_VARIANTS.items():
        if args.n is None or v.n in args.n:
            by_n.setdefault(v.n, []).append(name)
    gen = torch.Generator(device="cuda").manual_seed(15)
    records = []
    for n, names in by_n.items():
        t = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
             for k, v in fused.lines_consts(n, "forward", 1.0, "p").items()}
        vt = {v: variants.lines_variant_tables(v, "forward", 1.0, "cuda") for v in names}
        resident = {v: variants.lines_variant_resident(v) for v in names}
        for lines in args.lines or PATH_LINES.get(n, [131, 512, 1024]):
            x = torch.randn(lines, n, 2, device="cuda", generator=gen)
            want = {adj: fused.fused_lines_reference(x, t, adj) for adj in (False, True)}
            errs = {}
            for v in names:
                e = [rel(variants.lines_variant(x, vt[v], v, adj), want[adj])
                     for adj in (False, True)]
                e.append(rel(variants.lines_variant(x.clone(), vt[v], v, inplace=True),
                             want[False]))
                if max(e) > TOL:
                    raise AssertionError(f"N={n} x {lines} {v}: rel err {e}")
                errs[v] = max(e)
            plans_err = max(rel(fused.fused_lines(x, t, adjoint=adj), want[adj])
                            for adj in (False, True))
            if plans_err > TOL:
                raise AssertionError(f"N={n} x {lines} the plans' launch: rel err {plans_err}")
            arms = {v: (lambda v=v: variants.lines_variant(x, vt[v], v)) for v in names}
            arms["plans"] = lambda: fused.fused_lines(x, t)
            times = {a: [] for a in arms}
            for turn in (list(arms), list(arms)[::-1]):
                for a in turn:
                    times[a] += profile.time_queued(arms[a])
            library = profile.median(profile.time_queued(
                lambda: torch.fft.fft(torch.view_as_complex(x))))
            bound = profile.bound_ms(16 * n * lines, 0.0)[0]
            launch = fused.launch_report(n, lines)
            plans_resident = launch.resident
            rec = {"n": n, "lines": lines, "bound_ms": bound, "library_ms": library,
                   "card": card, "plans_design": radix.lines_design(n),
                   "plans_chain": list(radix.lines_chain(n)), "plans_resident": plans_resident,
                   "plans_grid": launch.grid, "plans_waves": launch.waves,
                   "plans_ms": profile.median(times["plans"]), "plans_err": plans_err,
                   "variants": {v: {"ms": profile.median(times[v]), "err": errs[v],
                                    "resident": resident[v],
                                    **variants.LINES_VARIANTS[v]._asdict()}
                                for v in names}}
            parts = "; ".join(f"{v} {r['ms']:.4f} ms ({r['resident']} CTAs an SM)"
                              for v, r in rec["variants"].items())
            print(f"K1 N={n} x {lines}: {parts}; the plans' launch ({rec['plans_design']} "
                  f"{tuple(rec['plans_chain'])}, {plans_resident} CTAs an SM, grid {launch.grid}, "
                  f"{launch.waves:.2f} waves) "
                  f"{rec['plans_ms']:.4f} ms; torch.fft.fft {library:.4f} ms; bound "
                  f"{bound:.4f} ms [{card}]", flush=True)
            records.append(rec)
            del x, want
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))


if __name__ == "__main__":
    main()
