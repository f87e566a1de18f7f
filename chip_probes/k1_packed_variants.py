"""Probe: K1 at the short lengths (128 points or less), the plans' launch and the packed variants.

    python3 chip_probes/k1_packed_variants.py [--repo DIR] [--n 16 64 128 ...]
                                              [--out PATH]   (from the repository root)

For every length of 128 or less that K1 takes (``fused.choose_split``), or
those of ``--n``, at the line counts of ``lines_for``: the plans' own launch
(``fused.fused_lines``, the design K1's rule gives the length: the direct
design, or the warp design at 32, in a checkout without the packed design)
with what ``fused.launch_report`` says of it (design, CTAs an SM, grid,
waves) and the host microseconds a call takes to return while the device
is busy; then, where the package has them, every variant of
``probes.variants.PACKED_VARIANTS`` of that length (one instantiation of
``csrc/lines_packed.cuh``: lanes a line, stages; 128 points only, which
the rule leaves on the direct design though the packed one won at one of
its line counts), first
checked against K1's plain version (1e-5 of max|plain|, forward, adjoint
and in place; a variant that fails is listed, left out of the timing, and
the script exits 1 at its end) with the CTAs an SM it holds (the CUDA
occupancy calculator); then device time (``runtime/profile.time_queued``) in turns,
the plans' launch and the variants in order and in reverse, beside
``torch.fft.fft`` with the unitary norm (cuFFT and its scaling pass) and
without a norm (cuFFT alone), and the bound (one read and one write at
3.35 TB/s).  Last, the host microseconds a call of the plans' launch takes
while the calls cycle through every length of 128 or less that K1 takes
at 1000 lines (a different kernel each call, so no launch finds its
occupancy answer left by the call before).

``--repo DIR`` imports ``webgpufft_tpu_torch`` from DIR (default: this
repository), so that a parent commit unpacked with ``git archive`` (the
direct design at these lengths) and this one are measured in one call on
one card.  With ``--out PATH`` one JSON line a shape is also written to
PATH.  Needs a GPU.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

TOL = 1e-5
# the line counts the paths launch at these lengths (PERF.md's K1 rows):
# chip_smoke.py's listed 16 x 100,003, 64 x 65,536, 128 x 8192, 4 and
# 8 x 1000 and 6 x 77, the facade path's 128 x 196,608 and the examples
# path's 32 x 1536 (NS-3D main at n 32)
PATH_LINES = {16: [100003], 64: [65536], 128: [8192, 196608], 4: [1000], 8: [1000], 6: [77],
              32: [1536]}
MOVED = 1 << 22        # points of the long count: 67.1 MB moved (16 bytes a point)
SHORT_LINES = 1000     # the short count where no path names one
HOST_CALLS, HOST_ROUNDS = 100, 5


def lines_for(n):
    """The line counts a length is timed at: 2^22 / N lines (67.1 MB), and
    the paths' own counts where ``PATH_LINES`` names the length, else (or
    where the path's count is the long one) 1000."""
    counts = {MOVED // n, *PATH_LINES.get(n, [SHORT_LINES])}
    return sorted(counts if len(counts) > 1 else counts | {SHORT_LINES})


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def host_us(fn):
    """Median over HOST_ROUNDS rounds of the host microseconds one of
    HOST_CALLS back-to-back calls takes to return, with a long elementwise
    pass (1 GiB) queued first so that the calls only enqueue."""
    blocker = torch.zeros(1 << 28, device="cuda")
    fn()
    rounds = []
    for _ in range(HOST_ROUNDS):
        torch.cuda.synchronize()
        blocker.add_(1.0)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        rounds.append((time.perf_counter() - t0) * 1e6 / HOST_CALLS)
        torch.cuda.synchronize()
    return sorted(rounds)[len(rounds) // 2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--n", type=int, nargs="+", help="only these lengths")
    ap.add_argument("--out", type=Path, help="also write one JSON line a shape here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_packed_variants: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.core import fused, radix
    from webgpufft_tpu_torch.probes import variants
    from webgpufft_tpu_torch.runtime import profile
    packed = getattr(variants, "PACKED_VARIANTS", {})
    card = profile.card_line()
    print(f"k1_packed_variants: {Path(T.__file__).parent} [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(19)
    lengths = args.n or [n for n in range(2, 129) if fused.choose_split(n)]
    records, failed = [], []
    for n in lengths:
        names = [v for v, rec in packed.items() if rec.n == n]
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
                if not max(e) <= TOL:
                    print(f"FAIL N={n} x {lines} {v}: rel err {e}", flush=True)
                    failed.append((n, lines, v))
                    continue
                errs[v] = max(e)
            plans_err = max(rel(fused.fused_lines(x, t, adjoint=adj), want[adj])
                            for adj in (False, True))
            if not plans_err <= TOL:
                print(f"FAIL N={n} x {lines} the plans' launch: rel err {plans_err}", flush=True)
                failed.append((n, lines, "plans"))
            z = torch.view_as_complex(x)
            arms = {v: (lambda v=v: variants.lines_variant(x, vt[v], v)) for v in errs}
            arms["plans"] = lambda: fused.fused_lines(x, t)
            arms["library"] = lambda: torch.fft.fft(z, norm="ortho")
            arms["unscaled"] = lambda: torch.fft.fft(z)
            times = {a: [] for a in arms}
            for turn in (list(arms), list(arms)[::-1]):
                for a in turn:
                    times[a] += profile.time_queued(arms[a])
            bound = profile.bound_ms(16 * n * lines, 0.0)[0]
            launch = fused.launch_report(n, lines)
            rec = {"n": n, "lines": lines, "bound_ms": bound, "card": card,
                   "plans_design": launch.design, "plans_chain": list(radix.lines_chain(n)),
                   "plans_resident": launch.resident, "plans_grid": launch.grid,
                   "plans_waves": launch.waves, "plans_err": plans_err,
                   "plans_host_us": host_us(arms["plans"]),
                   **{f"{a}_ms": profile.median(times[a])
                      for a in ("plans", "library", "unscaled")},
                   "variants": {v: {"ms": profile.median(times[v]), "err": errs[v],
                                    "resident": resident[v], **packed[v]._asdict()}
                                for v in errs}}
            parts = "".join(f"{v} {r['ms']:.4f} ms ({r['resident']} CTAs an SM); "
                            for v, r in rec["variants"].items())
            print(f"K1 N={n} x {lines}: the plans' launch ({launch.design} "
                  f"{tuple(rec['plans_chain'])}, {launch.resident} CTAs an SM, grid "
                  f"{launch.grid}, {launch.waves:.2f} waves) {rec['plans_ms']:.4f} ms "
                  f"(share {bound / rec['plans_ms']:.2f}, host {rec['plans_host_us']:.2f} us a "
                  f"call); {parts}torch.fft.fft ortho {rec['library_ms']:.4f} ms, unscaled "
                  f"{rec['unscaled_ms']:.4f} ms; bound {bound:.4f} ms [{card}]", flush=True)
            records.append(rec)
            del x, z, want
    cycle = []
    for n in (n for n in range(2, 129) if fused.choose_split(n)):
        t = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
             for k, v in fused.lines_consts(n, "forward", 1.0, "p").items()}
        cycle.append((torch.randn(SHORT_LINES, n, 2, device="cuda", generator=gen), t))
    turn = iter(range(1 << 62))

    def cycling():
        x, t = cycle[next(turn) % len(cycle)]
        fused.fused_lines(x, t)

    print(f"K1 host cost cycling through {len(cycle)} lengths x {SHORT_LINES}: "
          f"{host_us(cycling):.2f} us a call [{card}]", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))
    if failed:
        raise SystemExit(f"k1_packed_variants: {len(failed)} variant launches disagree with the "
                         f"plain version: {failed}")


if __name__ == "__main__":
    main()
