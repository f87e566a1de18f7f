"""Probe: K2 at the heights outside its fixed design, the plans' launch and the general design's variants.

    python3 chip_probes/k2_general_variants.py [--repo DIR] [--variants] [--h ...]
                                               [--out PATH]   (from the repository root)
    python3 chip_probes/k2_general_variants.py --fft2 [--repo DIR] [--out PATH]
    python3 chip_probes/k2_general_variants.py --fit SWEEP.jsonl BEFORE.jsonl [--cluster]
    python3 chip_probes/k2_general_variants.py --cluster [--repo DIR] [--variants] [--h ...]
    python3 chip_probes/k2_general_variants.py --summary BEFORE.jsonl [AFTER.jsonl]
    python3 chip_probes/k2_general_variants.py --ab P1.jsonl C1.jsonl C2.jsonl P2.jsonl

For every height K2 takes outside its fixed design (``fused_cols.FIXED_COLS``),
or the heights of ``--h``, at two views (``views_for``: (2, H, 2 * 33), the
``domain`` phase's view of few column tiles, and (1, H, 2 * cols) with the
fewest columns that move 67.1 MB): the plans' own launch
(``fused_cols.fused_cols`` on the unitary tables), first checked against
K2's plain version (1e-5 of max|plain|, forward and adjoint), with what
``fused_cols.launch_shape`` says of it (design, tile, grid, CTAs the card
holds); with ``--variants`` every candidate of ``candidates(h)`` in the
general design (``probes.variants.general_cols_variant``: a chain in the
fewest passes of ``radix.GENERAL_RADICES``, two at least, in two or three
orders, in the least class of points a thread that holds it (and the next
for the widest-first order), at every tile of 1 to 64 columns whose tile
holds 512 to 16384 points), first checked the same way; then device time
(``runtime/profile.time_queued``) in two turns, in order and in reverse,
beside ``torch.fft.fft`` along axis 1 with the unitary norm (cuFFT and its
scaling pass) and without a norm (cuFFT alone), and the bound
(``profile.bound_ms``: one read and one write at 3.35 TB/s).

``--cluster`` takes the heights of the cluster design instead (11583 to
16128, ``fused_cols.CLUSTER_COLS``; in a checkout without it, the heights
from 11583 outside the fixed design), and with ``--variants`` times every
candidate of ``probes.variants.cluster_candidates(h, CLUSTER_TILES)`` in
the cluster design (``probes.variants.cluster_variant``: a chain of the
fewest passes with each of its radices first, across the cluster, every
cluster size of 2, 4 and 8 its first radix holds, tiles of 1 to 16
columns, the least and the widest class of 24, 32 and 64 points a thread
that holds it); with ``--fit`` it writes the cluster design's table,
``WGFFT_CLUSTER_COLS`` of ``webgpufft_tpu_torch/csrc/cluster.cuh`` (which
``core/fused_cols.py`` reads), the same way as the general design's.
``--fft2 --cluster`` times the facade's ``fft2`` of 16-s seismic records
instead (``SEISMIC``: (8, 16000, 64) time-major and (8, 64, 16000)
trace-major), each split into K1, K2 and the rest.

``--fft2`` times the facade's ``fft2`` of eight HD frames (8, 1080, 1920),
queued and from idle, beside ``torch.fft.fft2``; its two kernels alone (K1
at 1920 over 8640 lines, K2 at (8, 1080, 3840)) beside cuFFT's row and
column passes (``torch.fft.fft`` along each axis) and their bounds; the
rest of the call is the queued call less the two; and the device time of
every kernel of ten calls under ``torch.profiler``.

``--repo DIR`` imports ``webgpufft_tpu_torch`` from DIR (default: this
repository), so that a parent commit unpacked with ``git archive`` and this
one are measured in one call on one card.  With ``--out PATH`` one JSON
line a view is also written to PATH.  Needs a GPU.

``--fit SWEEP BEFORE`` (no GPU) picks each height's entries from a sweep
with ``--variants`` and the parent's times of BEFORE (its plans' launch):
for each chain order, the fastest variant at each view; of the orders whose
variants beat the parent at both views by ``MARGIN``, the one whose worse
ratio to it is the least.  Where the two views' winners differ, the height
gets two entries, views of up to ``SPLIT`` columns in all and views of more.
It writes the general design's table, ``WGFFT_GENERAL_COLS`` of
``webgpufft_tpu_torch/csrc/cols_general.cuh`` (which
``core/fused_cols.py`` reads).  ``--summary BEFORE [AFTER]`` (no GPU) prints
the tables PERF.md keeps: the distribution of the plans' launch over cuFFT
unscaled at each view, the 20 worst ratios, the designs.  ``--ab P1 C1 C2
P2`` (no GPU) compares the four arms of a parent / change A/B: every view
the change runs in the general design, C / P and whether both C arms beat
both P arms.
"""

import argparse
import json
import math
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
MIN_BYTES = 1 << 26   # 67.1 MB: the long view moves at least this much
FEW_PRE, FEW_COLS = 2, 33   # chip_smoke.py's domain view (2, H, 66)
RUNS = 5              # timed runs a turn
TILES = (1, 2, 4, 8, 16, 32, 64)
LEAST_POINTS, MOST_POINTS = 512, 16384   # a candidate tile's points
MARGIN = 0.97         # --fit: a height moves where it wins at both views by this
SPLIT = 128           # --fit: columns in all of the few-tile entry, at most
ALL_COLUMNS = 1 << 40
HD = (8, 1080, 1920)  # the facade's fft2 of eight HD frames
# the facade's fft2 of eight 16-s shot records at 1 ms, 64 receivers: time-
# major (K2 down the 16000 samples) and trace-major as SEG-Y stores them (K1)
SEISMIC = ((8, 16000, 64), (8, 64, 16000))
CLUSTER_FROM = 11583  # --cluster: the heights of this and more
CLUSTER_TILES = (1, 2, 4, 8, 16)


def views_for(h):
    """The (pre, cols) views a height is timed at: (2, 33) and (1, the
    fewest columns that move ``MIN_BYTES``, 16 bytes a point)."""
    return [(FEW_PRE, FEW_COLS), (1, math.ceil(MIN_BYTES / (16 * h)))]


def fewest_passes(n, radices, least=2):
    """Every multiset (sorted, widest first) of the fewest ``radices`` that
    multiply to n, in ``least`` to four passes."""
    for passes in range(least, 5):
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


def candidates(h, radix, fused_cols):
    """The general design's variants of height h: (name, chain, points,
    tile).  The chain is the multiset of the fewest passes (two at least)
    whose widest radix is the least (then whose narrowest is the most),
    widest first, widest last and (three passes or more) widest second;
    each at every tile of ``TILES`` whose points lie in ``LEAST_POINTS`` ..
    ``MOST_POINTS`` (the widest tile the design holds where none does), in
    the least class of points a thread (``radix.GENERAL_CLASSES``) whose
    radices, threads and shared memory hold it there, the widest-first
    chain in the next class too."""
    sets = fewest_passes(h, radix.GENERAL_RADICES)
    if not sets:
        return []
    chain = min(sets, key=lambda s: (max(s), -min(s)))
    orders = [chain, chain[::-1]]
    if len(chain) >= 3:
        orders.append((chain[1], chain[0]) + chain[2:])
    held = {(c, t): [e for e in sorted(radix.GENERAL_CLASSES)
                     if fused_cols.general_cols_threads(h, c, e, t)]
            for c in orders for t in TILES}
    out = []
    for i, c in enumerate(dict.fromkeys(orders)):
        fits = [t for t in TILES if held[(c, t)]]
        for t in [t for t in fits if LEAST_POINTS <= h * t <= MOST_POINTS] or fits[-1:]:
            for e in held[(c, t)][:2 if i == 0 else 1]:
                out.append((f"{'x'.join(map(str, c))} E{e} T{t}", c, e, t))
    return out


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def load(repo):
    """The package of checkout ``repo`` and its modules the probe uses."""
    sys.path.insert(0, str(Path(repo).resolve()))
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.core import fused, fused_cols, radix
    from webgpufft_tpu_torch.probes import variants
    from webgpufft_tpu_torch.runtime import profile
    return T, fused, fused_cols, radix, variants, profile


def dev_tables(consts):
    import torch
    return {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda") for k, v in consts.items()}


def sweep(args):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_general_variants: needs an NVIDIA GPU")
    T, fused, fused_cols, radix, variants, profile = load(args.repo)
    card = profile.card_line()
    print(f"k2_general_variants: {Path(T.__file__).parent} [{card}]", flush=True)
    if args.variants and not hasattr(variants, "general_cols_variant"):
        raise SystemExit("k2_general_variants: --variants needs a checkout with the general design")
    if args.cluster and args.variants and not hasattr(variants, "cluster_variant"):
        raise SystemExit("k2_general_variants: --cluster --variants needs a checkout with the "
                         "cluster design")
    fixed = {f.h for f in fused_cols.FIXED_COLS}
    heights = args.h or [h for h in range(2, radix.MAX_LENGTH + 1)
                         if fused_cols.choose_split(h) and h not in fixed
                         and (h >= CLUSTER_FROM or not args.cluster)]
    chain_of = getattr(fused_cols, "cols_chain", radix.radix_chain)
    gen = torch.Generator(device="cuda").manual_seed(21)
    out = open(args.out, "w") if args.out else None
    failures = 0
    for h in heights:
        scale = 1.0 / math.sqrt(h)
        t = dev_tables(fused_cols.cols_consts(h, "forward", scale, "p"))
        if not args.variants:
            cands = []
        elif args.cluster:
            cands = [(name, c, e, (tile, clusters)) for name, c, e, tile, clusters
                     in variants.cluster_candidates(h, CLUSTER_TILES)]
        else:
            cands = candidates(h, radix, fused_cols)
        vt = {c: dev_tables(radix.chain_consts(h, "forward", scale, "p", c))
              for c in {c for _, c, _, _ in cands}}
        launch_variant = (
            (lambda x, tt, c, e, shape, adj=False:
             variants.cluster_variant(x, tt, c, e, *shape, adj)) if args.cluster
            else variants.general_cols_variant)
        for pre, cols in views_for(h):
            x = torch.randn(pre, h, 2 * cols, device="cuda", generator=gen)
            want = {adj: fused_cols.fused_cols_reference(x, t, adj) for adj in (False, True)}
            z = torch.view_as_complex(x.view(pre, h, cols, 2))
            arms = {"plans": lambda: fused_cols.fused_cols(x, t),
                    "library": lambda: torch.fft.fft(z, dim=1, norm="ortho"),
                    "unscaled": lambda: torch.fft.fft(z, dim=1)}
            runs = {"plans": lambda adj: fused_cols.fused_cols(x, t, adjoint=adj)}
            for name, c, e, tile in cands:
                runs[name] = (lambda adj, c=c, e=e, tile=tile:
                              launch_variant(x, vt[c], c, e, tile, adj))
                arms[name] = (lambda c=c, e=e, tile=tile:
                              launch_variant(x, vt[c], c, e, tile))
            # a kernel that fails or disagrees is reported, left untimed, and
            # the sweep goes on (the fit takes only variants that passed)
            errs = {}
            for name, run in runs.items():
                try:
                    errs[name] = max(rel(run(adj), want[adj]) for adj in (False, True))
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    errs[name] = float("inf")
                    print(f"FAIL K2 ({pre}, {h}, {2 * cols}) {name}: {e}", flush=True)
                if not errs[name] <= TOL:
                    failures += 1
                    print(f"FAIL K2 ({pre}, {h}, {2 * cols}) {name}: rel err {errs[name]}",
                          flush=True)
                    del arms[name]
            times = {a: [] for a in arms}
            for turn in (list(arms), list(arms)[::-1]):
                for a in turn:
                    times[a] += profile.time_queued(arms[a], runs=RUNS)
            ms = {a: profile.median(v) for a, v in times.items()}
            ms.setdefault("plans", float("nan"))
            bound = profile.bound_ms(16 * h * cols * pre, 0.0)[0]
            launch, resident = fused_cols.launch_shape(pre, h, cols)
            rec = {"h": h, "pre": pre, "cols": cols, "bound_ms": bound, "card": card,
                   "plans_design": launch.design, "plans_chain": list(chain_of(h)),
                   "plans_tile": launch.tile, "plans_grid": launch.grid,
                   "plans_threads": launch.threads, "plans_resident": resident,
                   "plans_err": errs["plans"],
                   **{f"{a}_ms": ms[a] for a in ("plans", "library", "unscaled")},
                   "variants": {}}
            for name, c, e, tile in cands:
                if name not in ms:
                    continue
                if args.cluster:
                    r = variants.cluster_report(pre, h, cols, c, e, *tile)
                    rec["variants"][name] = {"ms": ms[name], "err": errs[name], "chain": list(c),
                                             "points": e, "tile": tile[0], "clusters": tile[1],
                                             "threads": r.threads, "resident": r.resident,
                                             "held": r.clusters, "shared": r.shared}
                    continue
                r = variants.general_cols_report(pre, h, cols, c, e, tile)
                rec["variants"][name] = {"ms": ms[name], "err": errs[name], "chain": list(c),
                                         "points": e, "tile": tile, "threads": r.threads,
                                         "resident": r.resident}
            best = min(rec["variants"].items(), key=lambda kv: kv[1]["ms"], default=None)
            tail = (f"; best variant {best[0]} {best[1]['ms']:.4f} ms ({best[1]['threads']} "
                    f"threads, {best[1]['resident']} CTAs an SM) of {len(rec['variants'])}"
                    if best else "")
            print(f"K2 ({pre}, {h}, {2 * cols}): the plans' launch ({launch.design} "
                  f"{tuple(rec['plans_chain'])}, tile {launch.tile}, grid {launch.grid}, "
                  f"{resident} held) {ms['plans']:.4f} ms{tail}; torch.fft.fft ortho "
                  f"{ms['library']:.4f} ms, unscaled {ms['unscaled']:.4f} ms; bound "
                  f"{bound:.4f} ms [{card}]", flush=True)
            if out is not None:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            del x, z, want
    if out is not None:
        out.close()
    print(f"k2_general_variants: {failures} failures")
    if failures:
        raise SystemExit(1)


def fft2(args):
    """The facade's fft2 of eight HD frames split into K1, K2 and the rest."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_general_variants: needs an NVIDIA GPU")
    T, fused, fused_cols, radix, variants, profile = load(args.repo)
    from webgpufft_tpu_torch import fft as wfft
    card = profile.card_line()
    gen = torch.Generator(device="cuda").manual_seed(21)
    for shape in (SEISMIC if args.cluster else (HD,)):
        fft2_split(args, shape, torch, fused, fused_cols, radix, profile, wfft, card, gen)


def fft2_split(args, shape, torch, fused, fused_cols, radix, profile, wfft, card, gen):
    """One facade fft2 of ``shape`` (b, h, n) split into K1, K2 and the rest."""
    b, h, n = shape
    z = torch.randn(*shape, dtype=torch.complex64, device="cuda", generator=gen)
    want = torch.fft.fft2(z)
    got = torch.view_as_complex(wfft.fft2(z).contiguous())
    err = rel(got, want)
    lines = torch.randn(b * h, n, 2, device="cuda", generator=gen)
    cols = torch.randn(b, h, 2 * n, device="cuda", generator=gen)
    t1 = dev_tables(fused.lines_consts(n, "forward", 1.0, "p"))
    t2 = dev_tables(fused_cols.cols_consts(h, "forward", 1.0, "p"))
    k1_err = rel(fused.fused_lines(lines, t1), fused.fused_lines_reference(lines, t1))
    k2_err = rel(fused_cols.fused_cols(cols, t2), fused_cols.fused_cols_reference(cols, t2))
    zc = torch.view_as_complex(cols.view(b, h, n, 2))
    arms = {"facade fft2": lambda: wfft.fft2(z), "torch.fft.fft2": lambda: torch.fft.fft2(z),
            "K1": lambda: fused.fused_lines(lines, t1),
            "K2": lambda: fused_cols.fused_cols(cols, t2),
            "cuFFT rows": lambda: torch.fft.fft(zc, dim=-1),
            "cuFFT columns": lambda: torch.fft.fft(zc, dim=1)}
    queued = {a: [] for a in arms}
    idle = {a: [] for a in ("facade fft2", "torch.fft.fft2")}
    for turn in (list(arms), list(arms)[::-1]):
        for a in turn:
            queued[a] += profile.time_queued(arms[a], runs=RUNS)
            if a in idle:
                idle[a] += profile.time_calls(arms[a], runs=RUNS)
    ms = {a: profile.median(v) for a, v in queued.items()}
    idle_ms = {a: profile.median(v) for a, v in idle.items()}
    launch, resident = fused_cols.launch_shape(b, h, n)
    chain_of = getattr(fused_cols, "cols_chain", radix.radix_chain)
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            wfft.fft2(z)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and not ev.key.startswith("aten::"):
            kernels[ev.key[:80]] = round(us / 10 / 1e3, 4)
    rec = {"card": card, "shape": list(shape), "err": err, "k1_err": k1_err, "k2_err": k2_err,
           "queued_ms": ms, "idle_ms": idle_ms,
           "rest_ms": ms["facade fft2"] - ms["K1"] - ms["K2"],
           "k1_bound_ms": profile.bound_ms(16 * b * h * n, 0.0)[0],
           "k2_bound_ms": profile.bound_ms(16 * b * h * n, 0.0)[0],
           "k2_design": launch.design, "k2_tile": launch.tile, "k2_grid": launch.grid,
           "k2_threads": launch.threads, "k2_resident": resident,
           "k2_chain": list(chain_of(h)), "k1_chain": list(radix.lines_chain(n)),
           "profile_ms_a_call": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


def read(path):
    """{(h, pre, cols): record} of a JSON-lines file of this probe."""
    recs = [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]
    return {(r["h"], r["pre"], r["cols"]): r for r in recs if "h" in r}


def fit(sweep_path, before_path):
    """The general design's table from a sweep with ``--variants`` and the
    parent's times (BEFORE's plans' launch): {h: (chain, [(least, most,
    points, tile, variant, ratio)], worse ratio)}, and the heights left to
    the parent's designs with the reason."""
    runs, before = read(sweep_path), read(before_path)
    by_h = {}
    for (h, pre, cols), rec in runs.items():
        by_h.setdefault(h, {})[(pre, cols)] = rec
    table, left = {}, {}
    for h, views in sorted(by_h.items()):
        chains = {tuple(v["chain"]) for r in views.values() for v in r["variants"].values()}
        best = None
        for chain in sorted(chains):
            picks = {}
            for key, r in views.items():
                mine = [(v["ms"], name, v) for name, v in r["variants"].items()
                        if tuple(v["chain"]) == chain]
                if mine:
                    ms, name, v = min(mine, key=lambda m: m[0])
                    picks[key] = (name, v, ms / before[(h, *key)]["plans_ms"])
            if len(picks) < len(views):
                continue
            worst = max(p[2] for p in picks.values())
            if best is None or worst < best[2]:
                best = (chain, picks, worst)
        if best is None:
            left[h] = "no variant"
            continue
        if best[2] >= MARGIN:
            left[h] = f"slower (worse ratio {best[2]:.3f})"
            continue
        chain, picks, worst = best
        few = picks[(FEW_PRE, FEW_COLS)]
        big = next(p for key, p in picks.items() if key != (FEW_PRE, FEW_COLS))

        def shape(v):
            return (v["tile"], v["clusters"]) if "clusters" in v else v["tile"]
        if (few[1]["points"], shape(few[1])) == (big[1]["points"], shape(big[1])):
            entries = [(1, ALL_COLUMNS, big[1]["points"], shape(big[1]), big[0], worst)]
        else:
            entries = [(1, SPLIT, few[1]["points"], shape(few[1]), few[0], few[2]),
                       (SPLIT + 1, ALL_COLUMNS, big[1]["points"], shape(big[1]), big[0],
                        big[2])]
        table[h] = (chain, entries, worst)
    return table, left


def write_rule(table, cluster=False):
    """Write ``table`` ({h: (chain, entries, ...)}) as the general design's
    table, ``WGFFT_GENERAL_COLS`` of csrc/cols_general.cuh, or with
    ``cluster`` as the cluster design's, ``WGFFT_CLUSTER_COLS`` of
    csrc/cluster.cuh (each entry's shape (tile, clusters))."""
    items = []
    for h, (chain, entries, _) in sorted(table.items()):
        for least, most, points, tile, *_ in entries:
            most = "kAllColumns" if most == ALL_COLUMNS else str(most)
            shape = ", ".join(map(str, tile)) if cluster else str(tile)
            items.append(f"X({h}, {least}, {most}, {points}, {shape}, "
                         f"{', '.join(map(str, chain))})")
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
    name = "WGFFT_CLUSTER_COLS" if cluster else "WGFFT_GENERAL_COLS"
    path = ROOT / "webgpufft_tpu_torch" / "csrc" / ("cluster.cuh" if cluster else
                                                    "cols_general.cuh")
    text = path.read_text()
    text = re.sub(rf"#define {name}\(X\)(?: \\\n(?:.*\\\n)*.*)?\n",
                  lambda _: f"#define {name}(X){body}\n", text, count=1)
    path.write_text(text)


def quantiles(ratios):
    ratios = sorted(ratios)
    q = [ratios[int(f * (len(ratios) - 1))] for f in (0, 0.1, 0.5, 0.9, 1)]
    return (f"min {q[0]:.3f} p10 {q[1]:.3f} median {q[2]:.3f} p90 {q[3]:.3f} max {q[4]:.3f}; "
            f"over 1.10: {sum(x > 1.10 for x in ratios)}; under 1.5: {sum(x < 1.5 for x in ratios)}, "
            f"under 1: {sum(x < 1 for x in ratios)}")


def summary(before_path, after_path=None):
    """The tables PERF.md keeps of a run of this probe (and of a later one)."""
    before = read(before_path)
    after = read(after_path) if after_path else {}
    card = next(iter(before.values()))["card"]
    print(f"[{card}] {len(before)} views")
    for name, runs in (("before", before), ("after", after)):
        if not runs:
            continue
        for view in ("few tiles", "67 MB"):
            sel = [r for r in runs.values() if (r["pre"] == FEW_PRE) == (view == "few tiles")]
            designs = {}
            for r in sel:
                designs[r["plans_design"]] = designs.get(r["plans_design"], 0) + 1
            print(f"{name} {view}: {len(sel)} heights {designs}, plans / cuFFT unscaled "
                  f"{quantiles([r['plans_ms'] / r['unscaled_ms'] for r in sel])}; share of the "
                  f"bound median {sorted(r['bound_ms'] / r['plans_ms'] for r in sel)[len(sel) // 2]:.3f}")
    worst = sorted(before.values(), key=lambda r: -r["plans_ms"] / r["unscaled_ms"])[:20]
    print("20 worst ratios (before): view, design chain, plans ms, unscaled ms, ortho ms, "
          "bound ms, ratio" + ("; after design, ms, ratio" if after else ""))
    for r in worst:
        a = after.get((r["h"], r["pre"], r["cols"]))
        tail = (f"; {a['plans_design']} {a['plans_ms']:.4f} {a['plans_ms'] / a['unscaled_ms']:.3f}"
                if a else "")
        print(f"  ({r['pre']}, {r['h']}, {2 * r['cols']}), {r['plans_design']} "
              f"{tuple(r['plans_chain'])}, {r['plans_ms']:.4f}, {r['unscaled_ms']:.4f}, "
              f"{r['library_ms']:.4f}, {r['bound_ms']:.4f}, "
              f"{r['plans_ms'] / r['unscaled_ms']:.3f}{tail}")


def ab(p1, c1, c2, p2):
    """Every view the change runs in another design than the parent: C / P
    (mean of the two arms each) and whether both C arms beat both P arms;
    and the views whose design did not move."""
    P1, C1, C2, P2 = (read(p) for p in (p1, c1, c2, p2))
    moved, other, losers = [], [], []
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
        else:
            other.append((ratio, key))
    moved.sort(key=lambda m: m[0])
    if moved:
        print(f"{len(moved)} views that moved design: C / P min {moved[0][0]:.3f} ({moved[0][1]}) "
              f"median {moved[len(moved) // 2][0]:.3f} max {moved[-1][0]:.3f} ({moved[-1][1]}); "
              f"both C arms under both P arms at {len(moved) - len(losers)}")
    for key, cs, ps in losers:
        print(f"  not faster in both arms: {key} C {cs} P {ps}")
    other.sort()
    if other:
        within = sum(abs(r - 1) <= 0.01 for r, _ in other)
        print(f"{len(other)} views whose design did not move: C / P {other[0][0]:.3f} .. "
              f"{other[-1][0]:.3f}, {within} within 1 %")
        for r, key in other:
            if abs(r - 1) > 0.01:
                print(f"  {key}: {r:.3f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--variants", action="store_true",
                    help="also time the general design's candidates of each height")
    ap.add_argument("--h", type=int, nargs="+", help="only these heights")
    ap.add_argument("--out", type=Path, help="also write one JSON line a view here")
    ap.add_argument("--fft2", action="store_true",
                    help="split the facade's fft2 of eight HD frames into K1, K2 and the rest")
    ap.add_argument("--cluster", action="store_true",
                    help="the cluster design's heights (11583 on) and variants; with --fit its "
                         "table, with --fft2 the seismic records")
    ap.add_argument("--fit", nargs=2, metavar=("SWEEP", "BEFORE"),
                    help="write the general design's table from a sweep (no GPU)")
    ap.add_argument("--summary", nargs="+", metavar="RUN",
                    help="print PERF.md's tables of a run, beside a later one (no GPU)")
    ap.add_argument("--ab", nargs=4, metavar=("P1", "C1", "C2", "P2"),
                    help="compare the arms of a parent / change A/B (no GPU)")
    args = ap.parse_args()
    if args.fit:
        table, left = fit(*args.fit)
        write_rule(table, args.cluster)
        for h, (chain, entries, worst) in sorted(table.items()):
            print(f"{h}: {chain} " + "; ".join(f"{e[0]}..{e[1]} {e[4]} ({e[5]:.3f})"
                                               for e in entries) + f" (worse {worst:.3f})")
        print(f"{len(table)} heights to the {'cluster' if args.cluster else 'general'} design; "
              f"left: {len(left)}")
        for h, why in sorted(left.items()):
            print(f"  left {h}: {why}")
    elif args.summary:
        summary(*args.summary)
    elif args.ab:
        ab(*args.ab)
    elif args.fft2:
        fft2(args)
    else:
        sweep(args)


if __name__ == "__main__":
    main()
