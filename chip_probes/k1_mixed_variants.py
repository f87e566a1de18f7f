"""Probe: K1 at lengths that are not powers of two, the plans' launch and the mixed-radix variants.

    python3 chip_probes/k1_mixed_variants.py [--repo DIR] [--n 2079 6144 ...]
                                             [--out PATH]   (from the repository root)

For every length of ``LENGTHS`` (or ``--n``) at the line counts of
``lines_for``: the plans' own launch (``fused.fused_lines``, the design
K1's rule gives the length: the direct design in a checkout without the
mixed-radix design), with what ``fused.launch_report`` says of it (design,
CTAs an SM, waves); then, where the package has them, every variant of
``probes.variants.MIXED_VARIANTS`` of that length (one instantiation of
``csrc/lines_mixed.cuh``: lines a CTA, threads, CTAs an SM asked for,
chain), first checked against K1's plain version (1e-5 of max|plain|,
forward, adjoint and in place) with the CTAs an SM it holds (the CUDA
occupancy calculator); then device time (``runtime/profile.time_queued``)
in turns, the plans' launch and the variants in order and in reverse,
beside ``torch.fft.fft`` with the unitary norm (cuFFT and its scaling
pass) and without a norm (cuFFT alone), and the bound (one read and one
write at 3.35 TB/s).

``--repo DIR`` imports ``webgpufft_tpu_torch`` from DIR (default: this
repository), so that a parent commit unpacked with ``git archive`` (the
direct design at every one of these lengths) and this one are measured in
one call on one card.  With ``--out PATH`` one JSON line a shape is also
written to PATH.  Needs a GPU.
"""

import argparse
import json
import math
import sys
from pathlib import Path

import torch

TOL = 1e-5
# the lengths that are not powers of two of the sweep: 5-, 7-, 11- and
# 13-smooth sizes users meet (next_fast_len grids, the nufft path's 8232,
# traces of 1000, 3000 and 6000 samples) and the listed shapes of chip_smoke
LENGTHS = [360, 1000, 1352, 1536, 2079, 2310, 3000, 3072, 5120, 6000, 6144, 8232, 9216,
           12288, 15360]
# chip_smoke.py's phase_k1 line counts, where it lists the length
SMOKE_LINES = {360: 4096, 1352: 1025, 2079: 4096, 2310: 2048, 6144: 1024}
MIN_BYTES = 1 << 26   # 67.1 MB: a shape moves at least this much


def lines_for(n):
    """The line counts a length is timed at: chip_smoke.py's where it lists
    the length, and the fewest that move ``MIN_BYTES`` (16 bytes a point)
    where that count moves less."""
    least = math.ceil(MIN_BYTES / (16 * n))
    smoke = SMOKE_LINES.get(n)
    if smoke is None:
        return [least]
    return [smoke] if smoke >= least else [smoke, least]


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--n", type=int, nargs="+", help="only these lengths")
    ap.add_argument("--out", type=Path, help="also write one JSON line a shape here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_mixed_variants: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.core import fused, radix
    from webgpufft_tpu_torch.probes import variants
    from webgpufft_tpu_torch.runtime import profile
    mixed = getattr(variants, "MIXED_VARIANTS", {})
    card = profile.card_line()
    print(f"k1_mixed_variants: {Path(T.__file__).parent} [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    records = []
    for n in args.n or LENGTHS:
        names = [v for v, rec in mixed.items() if rec.n == n]
        t = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
             for k, v in fused.lines_consts(n, "forward", 1.0, "p").items()}
        vt = {v: variants.lines_variant_tables(v, "forward", 1.0, "cuda") for v in names}
        resident = {v: variants.lines_variant_resident(v) for v in names}
        for lines in lines_for(n):
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
            z = torch.view_as_complex(x)
            arms = {v: (lambda v=v: variants.lines_variant(x, vt[v], v)) for v in names}
            arms["plans"] = lambda: fused.fused_lines(x, t)
            arms["library"] = lambda: torch.fft.fft(z, norm="ortho")
            arms["unscaled"] = lambda: torch.fft.fft(z)
            times = {a: [] for a in arms}
            for turn in (list(arms), list(arms)[::-1]):
                for a in turn:
                    times[a] += profile.time_queued(arms[a])
            bound = profile.bound_ms(16 * n * lines, 0.0)[0]
            launch = fused.launch_report(n, lines)
            design = getattr(radix, "lines_design", lambda n: "direct")(n)
            rec = {"n": n, "lines": lines, "bound_ms": bound, "card": card,
                   "plans_design": design, "plans_chain": list(radix.lines_chain(n)),
                   "plans_resident": launch.resident, "plans_grid": launch.grid,
                   "plans_waves": launch.waves, "plans_err": plans_err,
                   **{f"{a}_ms": profile.median(times[a])
                      for a in ("plans", "library", "unscaled")},
                   "variants": {v: {"ms": profile.median(times[v]), "err": errs[v],
                                    "resident": resident[v], **mixed[v]._asdict()}
                                for v in names}}
            parts = "".join(f"{v} {r['ms']:.4f} ms ({r['resident']} CTAs an SM); "
                            for v, r in rec["variants"].items())
            print(f"K1 N={n} x {lines}: the plans' launch ({design} "
                  f"{tuple(rec['plans_chain'])}, {launch.resident} CTAs an SM, grid "
                  f"{launch.grid}, {launch.waves:.2f} waves) {rec['plans_ms']:.4f} ms "
                  f"(share {bound / rec['plans_ms']:.2f}); {parts}torch.fft.fft ortho "
                  f"{rec['library_ms']:.4f} ms, unscaled {rec['unscaled_ms']:.4f} ms; bound "
                  f"{bound:.4f} ms [{card}]", flush=True)
            records.append(rec)
            del x, z, want
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))


if __name__ == "__main__":
    main()
