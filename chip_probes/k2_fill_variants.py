"""Probe: K2's designs, tiles and fixed-design variants at the views that leave the card idle, and beside them.

    python3 chip_probes/k2_fill_variants.py [--repo DIR] [--views seven domain facade paths winners]
                                            [--check] [--out PATH]   (from the repository root)

For every view of ``VIEWS`` (or the groups named by ``--views``): the
plans' own launch (``fused_cols.fused_cols``, whatever K2's rule picks,
with ``fused_cols.launch_shape``'s design, tile, cluster, units and grid
where the package has them) and every variant ``variants_for`` lists: the
direct design and the ring at every tile of 1 to 32 columns that K2's
``cols_plan`` accepts, and every variant of the fixed design for the
height (``probes.variants.FIXED_VARIANTS``: a kernel per height, tile and
cluster size, ``csrc/cols_fixed.cuh``).  Each variant is first checked
against K2's plain version (1e-5 of max|plain|, forward, adjoint and in
place), with the CTAs (clusters) the card holds of it; a variant that fails
is listed and left out, and the script fails at its end.  Then device time
(``runtime/profile.time_queued``) in turns, every arm in order and in
reverse, beside ``torch.fft.fft`` along the same axis without a norm
(cuFFT alone) and the bound (one read and one write at 3.35 TB/s).
``--check`` stops after the checks.

``--repo DIR`` imports ``webgpufft_tpu_torch`` from DIR (default: this
repository); a checkout without the fixed design gets the plans' launch and
cuFFT only.  With ``--out PATH`` one JSON line a view is also written to
PATH.  Needs a GPU.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

TOL = 1e-5
# (pre, H, 2 * cols, direction): the views of chip_smoke.py's phase_k2 that
# lost to cuFFT before K2's fixed design, the domain phase's 33-column views
# where the tile is tall, the facade path's f-k gather (8, 16384, 128) and (16, 4096, 64),
# three more views of the heights the paths launch most (512, 256, 128), and
# the K2 views that beat cuFFT before it
VIEWS = {
    "seven": [(3, 2310, 66, "inverse"), (8, 16384, 64, "inverse"), (4, 1352, 130, "forward"),
              (1, 1024, 2048, "forward"), (5, 2048, 66, "forward"), (64, 360, 512, "forward"),
              (64, 1024, 66, "inverse")],
    "domain": [(2, h, 66, "forward") for h in (2048, 4096, 8192, 16384)],
    "facade": [(8, 16384, 128, "forward"), (16, 4096, 64, "forward")],
    "paths": [(64, 512, 1024, "forward"), (16, 256, 2048, "inverse"), (32, 128, 1024, "forward")],
    "winners": [(256, 256, 512, "forward"), (1, 256, 131072, "forward"),
                (256, 16, 512, "forward"), (384, 256, 512, "forward"),
                (768, 256, 512, "inverse"), (3, 256, 512, "forward"),
                (384, 128, 512, "forward"), (64, 64, 128, "inverse"),
                (8, 512, 1024, "forward"), (8, 1024, 2048, "forward"),
                (3, 128, 131072, "forward"), (6, 128, 131072, "inverse"),
                (8, 3, 512, "forward"), (8, 9, 512, "inverse"), (8, 2048, 1024, "forward")],
}
TILES = (1, 2, 4, 8, 16, 32)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def variants_for(fused_cols, radix, variants, pre, h, cols):
    """The variants timed at a view: the direct design and the ring at every
    tile of 1 to 32 columns K2's ``cols_plan`` accepts (("direct", tile),
    ("ring", tile)), then every variant of the fixed design for the height
    (("fixed", name))."""
    chain = radix.radix_chain(h)
    out = []
    for design in ("direct", "ring"):
        for tile in TILES:
            if tile > 1 and tile // 2 >= cols:
                continue   # wider than the view: the same work with idle columns
            if fused_cols._plan(chain, h, pre, cols, design, tile) is not None:
                out.append((design, tile))
    return out + [("fixed", v) for v, rec in getattr(variants, "FIXED_VARIANTS", {}).items()
                  if rec.h == h]


def name(v):
    return f"{v[0]} {v[1]}"


def launch(variants, x, t, v, adjoint=False, inplace=False):
    if v[0] == "fixed":
        return variants.cols_fixed_variant(x, t, v[1], adjoint, inplace)
    return variants.cols_variant(x, t, v[0], adjoint, v[1], inplace)


def slots_of(variants, x, t, v):
    if v[0] == "fixed":
        return variants.cols_fixed_slots(x, t, v[1])
    return variants.cols_variant_slots(x, t, v[0], v[1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--views", nargs="+", choices=sorted(VIEWS), default=list(VIEWS))
    ap.add_argument("--check", action="store_true", help="check every variant, time nothing")
    ap.add_argument("--out", type=Path, help="also write one JSON line a view here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_fill_variants: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.core import fused_cols, radix
    from webgpufft_tpu_torch.probes import variants
    from webgpufft_tpu_torch.runtime import profile
    fill = hasattr(variants, "FIXED_VARIANTS")
    card = profile.card_line()
    print(f"k2_fill_variants: {Path(T.__file__).parent} [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(18)
    records, failures = [], []
    for pre, h, lanes, direction in [v for g in args.views for v in VIEWS[g]]:
        cols = lanes // 2
        t = {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
             for k, v in fused_cols.cols_consts(h, direction, 1.0, "p").items()}
        x = torch.randn(pre, h, lanes, device="cuda", generator=gen)
        want = {adj: fused_cols.fused_cols_reference(x, t, adj) for adj in (False, True)}
        label = f"K2 ({pre}, {h}, {lanes}) {direction}"
        rec = {"view": [pre, h, lanes], "direction": direction, "card": card,
               "chain": list(radix.radix_chain(h))}
        if fill:
            shape, resident = fused_cols.launch_shape(pre, h, cols)
            rec["plans"] = {**shape._asdict(), "resident": resident}
        names = variants_for(fused_cols, radix, variants, pre, h, cols) if fill else []
        plans_err = max(rel(fused_cols.fused_cols(x, t, adjoint=adj), want[adj])
                        for adj in (False, True))
        if plans_err > TOL:
            raise AssertionError(f"{label} the plans' launch: rel err {plans_err}")
        errs, slots, good = {}, {}, []
        for v in names:
            try:
                e = [rel(launch(variants, x, t, v, adj), want[adj]) for adj in (False, True)]
                e.append(rel(launch(variants, x.clone(), t, v, inplace=True), want[False]))
                torch.cuda.synchronize()
                slots[v] = slots_of(variants, x, t, v)
            except Exception as exc:  # noqa: BLE001 - listed, the script fails at its end
                failures.append(f"{label} {name(v)}: {type(exc).__name__}: {exc}")
                continue
            if max(e) > TOL:
                failures.append(f"{label} {name(v)}: rel err {e}")
                continue
            errs[v] = max(e)
            good.append(v)
        names = good
        print(f"{label}: the plans' launch {rec.get('plans')} and {len(names)} variants within "
              f"{TOL} of the plain version", flush=True)
        if args.check:
            records.append(rec)
            continue
        z = torch.view_as_complex(x.view(pre, h, cols, 2))
        arms = {name(v): (lambda v=v: launch(variants, x, t, v)) for v in names}
        arms["plans"] = lambda: fused_cols.fused_cols(x, t)
        arms["unscaled"] = lambda: torch.fft.fft(z, dim=1)
        times = {a: [] for a in arms}
        for turn in (list(arms), list(arms)[::-1]):
            for a in turn:
                times[a] += profile.time_queued(arms[a])
        bound = profile.bound_ms(16 * pre * h * cols, 0.0)[0]
        ms = {a: profile.median(times[a]) for a in arms}
        rec.update(bound_ms=bound, plans_ms=ms["plans"], unscaled_ms=ms["unscaled"],
                   variants={name(v): {"design": v[0], "ms": ms[name(v)], "err": errs[v],
                                       "slots": slots[v]} for v in names})
        best = sorted(names, key=lambda v: ms[name(v)])[:6]
        parts = "; ".join(f"{name(v)} {ms[name(v)]:.4f} ms ({slots[v]} held)" for v in best)
        print(f"{label}: the plans' launch {ms['plans']:.4f} ms (share "
              f"{bound / ms['plans']:.2f}); fastest: {parts}; cuFFT unscaled "
              f"{ms['unscaled']:.4f} ms; bound {bound:.4f} ms [{card}]", flush=True)
        records.append(rec)
        del x, z, want
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))
    for line in failures:
        print(f"FAIL {line}")
    if failures:
        raise SystemExit(f"k2_fill_variants: {len(failures)} variants failed (listed above)")


if __name__ == "__main__":
    main()
