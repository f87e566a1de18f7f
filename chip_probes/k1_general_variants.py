"""Probe: K1 at the lengths of its general and direct designs, the plans' launch and the general design's variants.

    python3 chip_probes/k1_general_variants.py [--repo DIR] [--variants] [--n ...]
                                               [--out PATH]   (from the repository root)
    python3 chip_probes/k1_general_variants.py --fit SWEEP.jsonl BEFORE.jsonl [--cluster]
    python3 chip_probes/k1_general_variants.py --summary BEFORE.jsonl [AFTER.jsonl]
    python3 chip_probes/k1_general_variants.py --cluster [--repo DIR] [--variants] [--n ...]
    python3 chip_probes/k1_general_variants.py --ab P1.jsonl C1.jsonl C2.jsonl P2.jsonl

For every length K1's rule gives the general or the direct design
(``radix.lines_design``; in a checkout without the general design, the 740
lengths of the direct design), or the lengths of ``--n``, at two line
counts (``lines_for``: 1000 lines, and the fewest that move 67.1 MB): the
plans' own launch (``fused.fused_lines`` on the unitary tables), first
checked against K1's plain version (1e-5 of max|plain|, forward and
adjoint), with what ``fused.launch_report`` says of it (design, CTAs an SM,
waves); with ``--variants`` every candidate of ``candidates(n)`` in the
general design (``probes.variants.general_variant``: a chain in the fewest
passes of ``radix.GENERAL_RADICES``, in two or three orders, in the least
class of points a thread that holds it and the next), first checked the
same way; then device time (``runtime/profile.time_queued``) in two turns,
in order and in reverse, beside ``torch.fft.fft`` with the unitary norm
(cuFFT and its scaling pass) and without a norm (cuFFT alone), and the
bound (``profile.bound_ms``: one read and one write at 3.35 TB/s).

``--cluster`` takes the lengths of the cluster design instead (11583 to
16128, ``radix.CLUSTER_LINES``; in a checkout without it, the direct
design's lengths from 11583), and with ``--variants`` times every candidate
of ``probes.variants.cluster_candidates(n)`` in the cluster design
(``probes.variants.cluster_variant`` on the (lines, N, 2) view, tile 1: a
chain of the fewest passes with each of its radices first, across the
cluster, every cluster size of 2, 4 and 8 its first radix holds, the least
and the widest class of 24, 32 and 64 points a thread that holds it); with
``--fit`` it writes the cluster design's table, ``WGFFT_CLUSTER_LINES`` of
``webgpufft_tpu_torch/csrc/cluster.cuh`` (which ``core/radix.py`` reads),
with the lengths whose best variant beats BEFORE at both counts by
``MARGIN``.

``--ab P1 C1 C2 P2`` (no GPU) compares the four arms of a parent / change
A/B (the plans' launch of each run): every shape whose design moved, C / P
(the mean of two arms each), whether both C arms beat both P arms, and the
ratio to cuFFT unscaled before and after (min / median / max); the shapes
whose design did not move, and those outside 1 %.

``--repo DIR`` imports ``webgpufft_tpu_torch`` from DIR (default: this
repository), so that a parent commit unpacked with ``git archive`` and this
one are measured in one call on one card.  With ``--out PATH`` one JSON
line a shape is also written to PATH.  Needs a GPU.

``--fit SWEEP BEFORE`` (no GPU) picks each length's variant from a sweep
with ``--variants`` and the direct design's times of BEFORE (the parent's
plans' launch): of the variants faster than the direct design at both
counts, the one whose worse ratio to it is the least; and writes the
general design's table, ``WGFFT_GENERAL_LINES`` of
``webgpufft_tpu_torch/csrc/lines.cuh`` and ``_GENERAL`` of
``webgpufft_tpu_torch/core/radix.py``, with the lengths that won.
``--summary BEFORE [AFTER]`` (no GPU) prints the tables PERF.md keeps: the
distribution of the plans' launch over cuFFT unscaled at each count, the
20 worst ratios, and every 5-smooth length at 67 MB (beside AFTER's where
given).
"""

import argparse
import json
import math
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
MIN_BYTES = 1 << 26   # 67.1 MB: the long count moves at least this much
SHORT_LINES = 1000
RUNS = 5              # timed runs a turn
CTA_POINTS = 2048     # lines a CTA: as many as keep a CTA near this many points
CLUSTER_FROM = 11583  # --cluster: the lengths of this and more
MARGIN = 0.97         # --fit --cluster: a length moves where it wins at both counts by this


def lines_for(n):
    """The line counts a length is timed at: 1000 and the fewest that move
    ``MIN_BYTES`` (16 bytes a point)."""
    return [SHORT_LINES, math.ceil(MIN_BYTES / (16 * n))]


def fewest_passes(n, radices):
    """Every multiset (sorted, widest first) of the fewest ``radices`` that
    multiply to n, in at most four passes."""
    for passes in range(1, 5):
        found = []

        def rec(rem, k, top, pre):
            if k == 0:
                if rem == 1:
                    found.append(tuple(pre))
                return
            for r in radices:
                if r <= top and rem % r == 0:
                    rec(rem // r, k - 1, r, pre + [r])
        rec(n, passes, max(radices), [])
        if found:
            return found
    return []


def candidates(n, radix):
    """The general design's variants of length n: (name, chain, points,
    lines a CTA).  The chain is the multiset of the fewest passes whose
    widest radix is the least (then whose narrowest is the most), widest
    first, widest last and (three passes or more) widest second; each in
    the least class of points a thread (``radix.GENERAL_CLASSES``: 16, 20,
    24, 32, 64) whose radices and threads hold it, the widest-first chain in
    every class that holds it; lines a CTA as many as keep a CTA near ``CTA_POINTS``
    points (fewer where the class's threads run out), and below that many
    points the widest-first chain with twice as many lines a CTA too."""
    sets = [s for s in fewest_passes(n, radix.GENERAL_RADICES) if len(s) >= 2]
    if not sets:
        return []
    chain = min(sets, key=lambda s: (max(s), -min(s)))
    orders = {"wide first": chain, "wide last": chain[::-1]}
    if len(chain) >= 3:
        orders["wide second"] = (chain[1], chain[0]) + chain[2:]

    def fit(c, e, points):
        lines = max(1, points // n)
        while lines > 1 and radix.general_threads(n, c, e, lines) is None:
            lines -= 1
        return lines if radix.general_threads(n, c, e, lines) is not None else None

    out = []
    for order, c in orders.items():
        fits = [(e, fit(c, e, CTA_POINTS)) for e in sorted(radix.GENERAL_CLASSES)]
        fits = [(e, lines) for e, lines in fits if lines is not None]
        shapes = fits if order == "wide first" else fits[:1]
        if order == "wide first" and fits and n < CTA_POINTS:
            e = fits[0][0]
            shapes.append((e, fit(c, e, 2 * CTA_POINTS)))
        for e, lines in shapes:
            name = f"{'x'.join(map(str, c))} E{e} L{lines}"
            if all(name != have for have, *_ in out):
                out.append((name, c, e, lines))
    return out


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def sweep(args):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k1_general_variants: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.core import fused, radix
    from webgpufft_tpu_torch.probes import variants
    from webgpufft_tpu_torch.runtime import profile
    card = profile.card_line()
    print(f"k1_general_variants: {Path(T.__file__).parent} [{card}]", flush=True)
    if args.variants and not hasattr(variants, "general_variant"):
        raise SystemExit("k1_general_variants: --variants needs a checkout with the general design")
    if args.cluster and args.variants and not hasattr(variants, "cluster_variant"):
        raise SystemExit("k1_general_variants: --cluster --variants needs a checkout with the "
                         "cluster design")
    designs = ("direct", "cluster") if args.cluster else ("direct", "general")
    lengths = args.n or [n for n in range(2, radix.MAX_LENGTH + 1) if fused.choose_split(n)
                         and radix.lines_design(n) in designs
                         and (n >= CLUSTER_FROM or not args.cluster)]
    gen = torch.Generator(device="cuda").manual_seed(20)
    out = open(args.out, "w") if args.out else None
    for n in lengths:
        scale = 1.0 / math.sqrt(n)
        t = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
             for k, v in fused.lines_consts(n, "forward", scale, "p").items()}
        if not args.variants:
            cands = []
        elif args.cluster:
            cands = [(name, c, e, clusters)
                     for name, c, e, _, clusters in variants.cluster_candidates(n)]
        else:
            cands = candidates(n, radix)
        vt = {name: {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
                     for k, v in radix.chain_consts(n, "forward", scale, "p", c).items()}
              for name, c, _, _ in cands}
        launch_variant = (
            (lambda x, tt, c, e, per, adj=False:
             variants.cluster_variant(x, tt, c, e, 1, per, adj)) if args.cluster
            else variants.general_variant)
        for lines in lines_for(n):
            x = torch.randn(lines, n, 2, device="cuda", generator=gen)
            want = {adj: fused.fused_lines_reference(x, t, adj) for adj in (False, True)}
            z = torch.view_as_complex(x)
            arms = {"plans": lambda: fused.fused_lines(x, t),
                    "library": lambda: torch.fft.fft(z, norm="ortho"),
                    "unscaled": lambda: torch.fft.fft(z)}
            errs = {}
            runs = {"plans": lambda adj: fused.fused_lines(x, t, adjoint=adj)}
            for name, c, e, per in cands:
                runs[name] = (lambda adj, c=c, e=e, per=per, tt=vt[name]:
                              launch_variant(x, tt, c, e, per, adj))
                arms[name] = (lambda c=c, e=e, per=per, tt=vt[name]:
                              launch_variant(x, tt, c, e, per))
            # a kernel that fails or disagrees is reported, left untimed, and
            # the sweep goes on (the fit takes only variants that passed)
            for name, run in runs.items():
                try:
                    errs[name] = max(rel(run(adj), want[adj]) for adj in (False, True))
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    errs[name] = float("inf")
                    print(f"FAIL K1 N={n} x {lines} {name}: {e}", flush=True)
                if not errs[name] <= TOL:
                    print(f"FAIL K1 N={n} x {lines} {name}: rel err {errs[name]}", flush=True)
                    del arms[name]
            err = errs["plans"]
            times = {a: [] for a in arms}
            for turn in (list(arms), list(arms)[::-1]):
                for a in turn:
                    times[a] += profile.time_queued(arms[a], runs=RUNS)
            ms = {a: profile.median(v) for a, v in times.items()}
            ms.setdefault("plans", float("nan"))
            bound = profile.bound_ms(16 * n * lines, 0.0)[0]
            launch = fused.launch_report(n, lines)
            rec = {"n": n, "lines": lines, "bound_ms": bound, "card": card,
                   "plans_design": launch.design, "plans_chain": list(radix.lines_chain(n)),
                   "plans_resident": launch.resident, "plans_grid": launch.grid,
                   "plans_waves": launch.waves, "plans_err": err,
                   **{f"{a}_ms": ms[a] for a in ("plans", "library", "unscaled")},
                   "variants": {}}
            for name, c, e, per in cands:
                if name not in ms:
                    continue
                if args.cluster:
                    r = variants.cluster_report(lines, n, 1, c, e, 1, per)
                    rec["variants"][name] = {"ms": ms[name], "err": errs[name], "chain": list(c),
                                             "points": e, "clusters": per, "threads": r.threads,
                                             "resident": r.resident, "held": r.clusters,
                                             "shared": r.shared}
                    continue
                r = variants.general_report(n, lines, c, e, per)
                rec["variants"][name] = {"ms": ms[name], "err": errs[name], "chain": list(c),
                                         "points": e, "lines": per, "threads": r.threads,
                                         "resident": r.resident}
            parts = "".join(f"{v} {r['ms']:.4f} ms ({r['threads']} threads, {r['resident']} "
                            f"CTAs an SM); " for v, r in rec["variants"].items())
            if args.cluster and rec["variants"]:
                best = min(rec["variants"].items(), key=lambda kv: kv[1]["ms"])
                parts = (f"best of {len(rec['variants'])} cluster variants {best[0]} "
                         f"{best[1]['ms']:.4f} ms ({best[1]['threads']} threads, "
                         f"{best[1]['resident']} CTAs an SM, {best[1]['held']} clusters held); ")
            print(f"K1 N={n} x {lines}: the plans' launch ({launch.design} "
                  f"{tuple(rec['plans_chain'])}, {launch.resident} CTAs an SM, "
                  f"{launch.waves:.2f} waves) {ms['plans']:.4f} ms; {parts}torch.fft.fft ortho "
                  f"{ms['library']:.4f} ms, unscaled {ms['unscaled']:.4f} ms; bound "
                  f"{bound:.4f} ms [{card}]", flush=True)
            if out is not None:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            del x, z, want
    if out is not None:
        out.close()


def read(path):
    """{(n, lines): record} of a JSON-lines file of this probe."""
    recs = [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]
    return {(r["n"], r["lines"]): r for r in recs}


def fit(sweep_path, before_path):
    """The general design's table from a sweep with ``--variants`` and the
    direct design's times (BEFORE's plans' launch): {n: (points, lines,
    chain, variant, worse ratio)}, and the lengths left to the direct
    design."""
    runs, before = read(sweep_path), read(before_path)
    by_n = {}
    for (n, lines), rec in runs.items():
        by_n.setdefault(n, {})[lines] = rec
    table, left = {}, []
    for n, counts in sorted(by_n.items()):
        names = set.intersection(*(set(r["variants"]) for r in counts.values()))
        best = None
        for name in sorted(names):
            worst = max(r["variants"][name]["ms"] / before[(n, lines)]["plans_ms"]
                        for lines, r in counts.items())
            if best is None or worst < best[1]:
                best = (name, worst)
        if best is None or best[1] >= 1.0:
            left.append(n)
            continue
        v = next(iter(counts.values()))["variants"][best[0]]
        table[n] = (v["points"], v["lines"], tuple(v["chain"]), best[0], best[1])
    return table, left


def fit_cluster(sweep_path, before_path):
    """The cluster design's table from a sweep with ``--cluster --variants``
    and BEFORE's plans' launch: {n: (points, clusters, chain, variant, worse
    ratio)} for the lengths whose best variant (the least worse ratio over
    the two counts) beats BEFORE at both by ``MARGIN``; and the lengths
    left, {n: (best variant, its worse ratio)}."""
    runs, before = read(sweep_path), read(before_path)
    by_n = {}
    for (n, lines), rec in runs.items():
        by_n.setdefault(n, {})[lines] = rec
    table, left = {}, {}
    for n, counts in sorted(by_n.items()):
        names = set.intersection(*(set(r["variants"]) for r in counts.values()))
        scored = [(max(r["variants"][name]["ms"] / before[(n, lines)]["plans_ms"]
                       for lines, r in counts.items()), name) for name in sorted(names)]
        if not scored:
            left[n] = (None, float("inf"))
            continue
        worst, name = min(scored)
        if worst >= MARGIN:
            left[n] = (name, worst)
            continue
        v = next(iter(counts.values()))["variants"][name]
        table[n] = (v["points"], v["clusters"], tuple(v["chain"]), name, worst)
    return table, left


def write_cluster_rule(table):
    """Write ``table`` ({n: (points, clusters, chain, ...)}) as the cluster
    design's K1 table, ``WGFFT_CLUSTER_LINES`` of csrc/cluster.cuh."""
    items = [f"X({n}, {e}, {c}, {', '.join(map(str, chain))})"
             for n, (e, c, chain, *_) in sorted(table.items())]
    rows, row = [], ""
    for item in items:
        if row and len(row) + len(item) + 1 > 94:
            rows.append(row)
            row = ""
        row += item + " "
    if row:
        rows.append(row)
    body = "".join(f" \\\n  {r.rstrip():<94}" for r in rows)
    body = re.sub(r" +$", "", body)
    path = ROOT / "webgpufft_tpu_torch" / "csrc" / "cluster.cuh"
    text = path.read_text()
    text = re.sub(r"#define WGFFT_CLUSTER_LINES\(X\)(?: \\\n(?:.*\\\n)*.*)?\n",
                  lambda _: f"#define WGFFT_CLUSTER_LINES(X){body}\n", text, count=1)
    path.write_text(text)


def write_rule(table):
    """Write ``table`` ({n: (points, lines, chain, ...)}) as the general
    design's table in csrc/lines.cuh and core/radix.py."""
    entries = [(n, e, per, *chain) for n, (e, per, chain, *_) in sorted(table.items())]
    cuh = ROOT / "webgpufft_tpu_torch" / "csrc" / "lines.cuh"
    rows, row = [], ""
    for e in entries:
        item = f"X({', '.join(map(str, e))}) "
        if len(row) + len(item) > 94:
            rows.append(row)
            row = ""
        row += item
    rows.append(row)
    body = "".join(f"  {r.rstrip():<94}\\\n" for r in rows).rstrip("\\\n").rstrip()
    text = cuh.read_text()
    text = re.sub(r"#define WGFFT_GENERAL_LINES\(X\) \\\n(?:.*\\\n)*.*\n",
                  lambda _: f"#define WGFFT_GENERAL_LINES(X) \\\n{body}\n", text)
    cuh.write_text(text)
    py = ROOT / "webgpufft_tpu_torch" / "core" / "radix.py"
    rows, row = [], ""
    for e in entries:
        item = f"({', '.join(map(str, e))}), "
        if len(row) + len(item) > 95:
            rows.append(row)
            row = ""
        row += item
    rows.append(row)
    body = "".join(f"    {r.rstrip()}\n" for r in rows)
    text = py.read_text()
    text = re.sub(r"_GENERAL = \(\n(?:    .*\n)*\)\n", lambda _: f"_GENERAL = (\n{body})\n", text)
    py.write_text(text)


def smooth5(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def summary(before_path, after_path=None):
    """The tables PERF.md keeps of a run of this probe (and of a later one)."""
    before = read(before_path)
    after = read(after_path) if after_path else {}
    card = next(iter(before.values()))["card"]
    print(f"[{card}] {len(before)} shapes")
    for name, runs in (("before", before), ("after", after)):
        if not runs:
            continue
        for count in ("short", "long"):
            ratios = sorted(r["plans_ms"] / r["unscaled_ms"] for r in runs.values()
                            if (r["lines"] == SHORT_LINES) == (count == "short"))
            if not ratios:
                continue
            q = [ratios[int(f * (len(ratios) - 1))] for f in (0, 0.1, 0.25, 0.5, 0.75, 0.9, 1)]
            over = sum(x > 1.10 for x in ratios)
            print(f"{name} {count} count: {len(ratios)} lengths, plans / cuFFT unscaled "
                  f"min {q[0]:.3f} p10 {q[1]:.3f} p25 {q[2]:.3f} median {q[3]:.3f} p75 {q[4]:.3f} "
                  f"p90 {q[5]:.3f} max {q[6]:.3f}; over 1.10: {over}")
    worst = sorted(before.values(), key=lambda r: -r["plans_ms"] / r["unscaled_ms"])[:20]
    print("20 worst ratios (before): n x lines, design chain, plans ms, unscaled ms, ortho ms, "
          "bound ms, ratio" + ("; after ms, ratio" if after else ""))
    for r in worst:
        a = after.get((r["n"], r["lines"]))
        tail = (f"; {a['plans_ms']:.4f} {a['plans_ms'] / a['unscaled_ms']:.3f}" if a else "")
        print(f"  {r['n']} x {r['lines']}, {r['plans_design']} {tuple(r['plans_chain'])}, "
              f"{r['plans_ms']:.4f}, {r['unscaled_ms']:.4f}, {r['library_ms']:.4f}, "
              f"{r['bound_ms']:.4f}, {r['plans_ms'] / r['unscaled_ms']:.3f}{tail}")
    print("5-smooth lengths at the long count: n x lines, before ms (ratio to unscaled)"
          + ("; after ms (ratio), share of the bound" if after else ""))
    for (n, lines), r in sorted(before.items()):
        if lines == SHORT_LINES or not smooth5(n):
            continue
        a = after.get((n, lines))
        tail = (f"; {a['plans_design']} {tuple(a['plans_chain'])} {a['plans_ms']:.4f} "
                f"({a['plans_ms'] / a['unscaled_ms']:.3f}), {a['bound_ms'] / a['plans_ms']:.2f}"
                if a else "")
        print(f"  {n} x {lines}: {r['plans_ms']:.4f} ({r['plans_ms'] / r['unscaled_ms']:.3f}), "
              f"unscaled {r['unscaled_ms']:.4f}, ortho {r['library_ms']:.4f}{tail}")


def ab(p1, c1, c2, p2):
    """Every shape whose design moved: C / P, both C arms under both P arms,
    and the ratios to cuFFT unscaled (the mean of the arms' own) before and
    after; and the shapes whose design did not move."""
    P1, C1, C2, P2 = (read(p) for p in (p1, c1, c2, p2))
    moved, other, losers, before, after = [], [], [], [], []
    for key, c in sorted(C1.items()):
        if key not in P1 or key not in P2 or key not in C2:
            continue
        cs = (c["plans_ms"], C2[key]["plans_ms"])
        ps = (P1[key]["plans_ms"], P2[key]["plans_ms"])
        ratio = sum(cs) / sum(ps)
        if c["plans_design"] != P1[key]["plans_design"]:
            moved.append((ratio, key))
            if max(cs) >= min(ps):
                losers.append((key, cs, ps))
            count = "short" if key[1] == SHORT_LINES else "long"
            before.append((count, sum(ps) / (P1[key]["unscaled_ms"] + P2[key]["unscaled_ms"])))
            after.append((count, sum(cs) / (c["unscaled_ms"] + C2[key]["unscaled_ms"])))
        else:
            other.append((ratio, key))
    for name, rows in (("moved", moved), ("unmoved", other)):
        if not rows:
            continue
        rows.sort()
        within = sum(abs(r - 1) <= 0.01 for r, _ in rows)
        print(f"{len(rows)} {name} shapes: C / P min {rows[0][0]:.3f} ({rows[0][1]}) median "
              f"{rows[len(rows) // 2][0]:.3f} max {rows[-1][0]:.3f} ({rows[-1][1]}); "
              f"{within} within 1 %")
    if moved:
        print(f"both C arms under both P arms at {len(moved) - len(losers)} of {len(moved)}")
        for key, cs, ps in losers:
            print(f"  not faster in both arms: {key} C {cs} P {ps}")
        for name, ratios in (("before", before), ("after", after)):
            for count in ("short", "long"):
                sel = sorted(r for c, r in ratios if c == count)
                if sel:
                    print(f"  ratio to cuFFT unscaled {name}, {count} count: min {sel[0]:.3f} "
                          f"median {sel[len(sel) // 2]:.3f} max {sel[-1]:.3f}; under 1.5 at "
                          f"{sum(r < 1.5 for r in sel)} of {len(sel)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--variants", action="store_true",
                    help="also time the general design's candidates of each length")
    ap.add_argument("--n", type=int, nargs="+", help="only these lengths")
    ap.add_argument("--out", type=Path, help="also write one JSON line a shape here")
    ap.add_argument("--ab", nargs=4, metavar=("P1", "C1", "C2", "P2"),
                    help="compare the arms of a parent / change A/B (no GPU)")
    ap.add_argument("--cluster", action="store_true",
                    help="the cluster design's lengths (11583 on) and variants; with --fit its "
                         "table")
    ap.add_argument("--fit", nargs=2, metavar=("SWEEP", "BEFORE"),
                    help="write the general design's table from a sweep (no GPU)")
    ap.add_argument("--summary", nargs="+", metavar="RUN",
                    help="print PERF.md's tables of a run, beside a later one (no GPU)")
    args = ap.parse_args()
    if args.ab:
        ab(*args.ab)
    elif args.fit and args.cluster:
        table, left = fit_cluster(*args.fit)
        write_cluster_rule(table)
        for n, (e, c, chain, name, worst) in sorted(table.items()):
            print(f"{n}: {name} (worse ratio to BEFORE {worst:.3f})")
        for n, (name, worst) in sorted(left.items()):
            print(f"{n} stays: best variant {name}, worse ratio to BEFORE {worst:.3f}")
        print(f"{len(table)} lengths to the cluster design, {len(left)} left")
    elif args.fit:
        table, left = fit(*args.fit)
        write_rule(table)
        for n, (e, per, chain, name, worst) in sorted(table.items()):
            print(f"{n}: {name} (worse ratio to the direct design {worst:.3f})")
        print(f"{len(table)} lengths to the general design; left to the direct design: {left}")
    elif args.summary:
        summary(*args.summary)
    else:
        sweep(args)


if __name__ == "__main__":
    main()
