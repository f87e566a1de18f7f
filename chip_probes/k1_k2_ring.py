"""Probe: K2's direct design and its ring design, and K1's lines, in one run.

    python3 chip_probes/k1_k2_ring.py [--repo DIR] [--out PATH] [--e2e] [--e2e-short]
                                      [--k1-only | --k2-only]   (from the repository root)

For every long shape of the kernel table in PERF.md (K1 from N = 2048 on,
every K2 view), K1's short powers of two at the line
counts the paths launch, K1's lengths that are not powers of two (the
mixed-radix design's), every length of 128 or less K1 takes at the line
counts of ``chip_probes/k1_packed_variants.py`` (2^22 / N and the paths'
own: the packed design's), and a few beside them: the plans' own
launch (``fused.fused_lines`` / ``fused_cols.fused_cols``, whichever design
the entry point takes) in device time (``runtime/profile.time_queued``) and
in host time per call (``host_us``: the microseconds a call takes to return
while the device is busy, so that it only enqueues), beside
``torch.fft.fft`` (cuFFT) and the bound (one read and one write at 3.35
TB/s).  K2's plans' launch is named with what K2's rule picks (design,
tile, cluster, units, grid) and timed with its adjoint launch; at the
views of ``RING_CASES`` each design of
``webgpufft_tpu_torch.probes.variants`` at its own tile (``direct``;
``ring``, a 3-D tensor map where the rows are aligned and the tiles whole,
cp.async otherwise; ``ring-async``, cp.async for every tile) is first
checked against the plain version (1e-5 of max|plain|, forward and
adjoint), then timed in turns, in order and in reverse, each time the
median of both turns, with its host time per call (the fixed design's
variants are timed by ``chip_probes/k2_fill_variants.py``).  K1's plans' launch
takes the design K1's rule gives the length (``radix.lines_design``: the
power-of-two design at 256 and 1024 to 16384, the warp design at 512,
the mixed-radix design at the lengths of ``radix.MIXED_LINES``, the
packed design at those of ``radix.PACKED_LINES``, the general design at
those of ``radix.GENERAL_LINES``, the direct one elsewhere; a checkout
without a rule has the direct design there), named in the label, and is
timed with its adjoint launch; its variants are timed by
``chip_probes/k1_pow2_variants.py``.  ``--k1-only`` leaves K2 out,
``--k2-only`` K1.

``--e2e`` then times, from idle and queued, the calls whose K1 launches
are its long lines, each beside the same call on ``torch.fft`` (in turns:
yardstick, port, port, yardstick) and with its K1 launches: the
system-identification training step at 2^20 x 8 (forward + backward +
Adam, from idle only), ``matmul_toeplitz`` (4097 x 4096) @ (4096, 1024),
``solve_toeplitz`` 4096 x 256 and the overlap-save plan [2^20] * 129, set up
from ``chip_smoke.py``'s constants and helpers and checked as it checks
them.

``--e2e-short`` does the same for the calls whose K1 launches are short
lines: the headline plan [1024] x 4096, dct2 [512, 512] x 8 and fftconv
[1000, 1000] x 8 with 25 x 25 taps (from idle and queued), and one NS-3D
step at 256^3 (from idle), each beside the same call or step on
``torch.fft``.

``--repo DIR`` imports ``webgpufft_tpu_torch`` from DIR (default: this
repository), so that a parent commit unpacked with ``git archive`` and this
one are timed in one call on one card (parent, change, change, parent); a
checkout without ``probes.variants`` gets the plans' launches only.  With
``--out PATH`` one JSON line a shape or call is also written to PATH.
Needs a GPU.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

# (N, lines): the long K1 rows of PERF.md's table, more lengths whose CTA
# fills an SM (odd 2079 = 3^3 * 7 * 11; 6144, 5120, 9216, 12288), and 4096
# and 2048; then the powers of two 2^11 .. 2^14 at 131, 512 and 1024 lines
K1_CASES = [(8192, 1024), (8192, 1032), (8192, 131), (8192, 512), (16384, 512), (4096, 4096),
            (2048, 4096), (2079, 4096), (6144, 1024), (5120, 1024), (9216, 1024), (12288, 512)]
K1_CASES += [(n, lines) for n in (2048, 4096, 8192, 16384) for lines in (131, 512, 1024)
             if (n, lines) not in K1_CASES]
# the short powers of two the paths launch (PERF.md's rows): the headline
# 1024 x 4096, the fftconv path's 1024 x 8192, the dct path's 512 x 4096,
# NS-3D main's r2c body 32 x 1536, the 256^3 bodies 256 x 65,536 and
# 256 x 98,304
K1_CASES += [(1024, 4096), (1024, 8192), (512, 4096), (32, 1536), (256, 65536), (256, 98304)]
# the lengths that are not powers of two at the line counts of
# chip_probes/k1_mixed_variants.py (2079, 6144, 5120, 9216 and 12288 above),
# and the facade path's traces of 3000 samples
K1_CASES += [(360, 4096), (360, 11651), (1000, 4195), (1352, 1025), (1352, 3103), (1536, 2731),
             (2310, 2048), (3000, 1399), (3000, 4096), (3072, 1366), (6000, 700), (8232, 510),
             (15360, 274)]
# the facade path's HD frames (8640 lines of 1920) and 25 ms frames (8192
# lines of 1200): the general design (chip_probes/k1_general_variants.py
# times every length of that design)
K1_CASES += [(1920, 8640), (1200, 8192)]
# (pre, H, 2 * cols): every view of chip_smoke.py's phase_k2 (PERF.md's K2
# rows), the facade's f-k gather (8, 16384, 128), (16, 4096, 64) and three
# more views of the heights the paths launch most (512, 256, 128); K2's
# designs by name (direct, ring, ring-async) at the views of RING_CASES
K2_CASES = [(256, 256, 512), (1, 256, 131072), (64, 360, 512), (256, 16, 512), (384, 256, 512),
            (768, 256, 512), (3, 256, 512), (8, 16384, 64), (5, 2048, 66), (3, 2310, 66),
            (4, 1352, 130), (384, 128, 512), (64, 64, 128), (8, 512, 1024), (8, 1024, 2048),
            (1, 1024, 2048), (3, 128, 131072), (6, 128, 131072), (8, 3, 512), (8, 9, 512),
            (8, 2048, 1024), (64, 1024, 66), (8, 16384, 128), (16, 4096, 64),
            (64, 512, 1024), (16, 256, 2048), (32, 128, 1024)]
# the facade's fft2 of eight HD frames, an H = 32 view of the kind the
# NS-3D main at n 32 gives K2, and the halo fftconv [1000, 1000] x 8 with
# 25 x 25 taps of the examples and distributed paths (H = 1078): heights
# of K2's general design but 32 (chip_probes/k2_general_variants.py times
# every height of that design)
K2_CASES += [(8, 1080, 3840), (3, 32, 1088), (1, 1078, 2156), (8, 1078, 2156)]
RING_CASES = [(8, 1024, 2048), (1, 1024, 2048), (8, 512, 1024), (8, 2048, 1024), (64, 1024, 66),
              (16, 4096, 64), (256, 256, 512)]
TOL = 1e-5
HOST_CALLS, HOST_ROUNDS = 100, 5


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def host_us(fn):
    """Median over HOST_ROUNDS rounds of the host microseconds one of
    HOST_CALLS back-to-back calls of ``fn`` takes to return, with a long
    elementwise pass (1 GiB) queued first so that the calls only enqueue."""
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
    rounds.sort()
    return rounds[len(rounds) // 2]


def measure(label, plain, library, plan, designs, run, nbytes, card, profile,
            plan_adjoint=None):
    """Check each design, time the designs in turns, then the plans' launch
    (and its adjoint launch, where given) and the library call; returns the
    record."""
    bound = profile.bound_ms(nbytes, 0.0)[0]
    rec = {"shape": label, "bound_ms": bound, "card": card}
    want = {adj: plain(adj) for adj in (False, True)}
    for d in designs:
        errs = [rel(run(d, adj), want[adj]) for adj in (False, True)]
        if max(errs) > TOL:
            raise AssertionError(f"{label} {d}: rel err {errs}")
        rec[f"{d}_err"] = max(errs)
    times = {d: [] for d in designs}
    for turn in (designs, designs[::-1]):
        for d in turn:
            times[d] += profile.time_queued(lambda d=d: run(d, False))
    for d in designs:
        rec[d] = profile.median(times[d])
        rec[f"{d}_host_us"] = host_us(lambda d=d: run(d, False))
    err = rel(plan(), want[False])
    if err > TOL:
        raise AssertionError(f"{label} the plans' launch: rel err {err}")
    rec["plans_ms"] = profile.median(profile.time_queued(plan))
    rec["plans_host_us"] = host_us(plan)
    if plan_adjoint is not None:
        err = rel(plan_adjoint(), want[True])
        if err > TOL:
            raise AssertionError(f"{label} the plans' adjoint launch: rel err {err}")
        rec["plans_adjoint_ms"] = profile.median(profile.time_queued(plan_adjoint))
    rec["library_ms"] = profile.median(profile.time_queued(library))
    parts = "".join(f"{d} {rec[d]:.4f} ms (share {bound / rec[d]:.2f}, host "
                    f"{rec[f'{d}_host_us']:.2f} us); " for d in designs)
    adj = (f", adjoint {rec['plans_adjoint_ms']:.4f} ms" if plan_adjoint is not None else "")
    print(f"{label}: {parts}the plans' launch {rec['plans_ms']:.4f} ms (share "
          f"{bound / rec['plans_ms']:.2f}, host {rec['plans_host_us']:.2f} us a call{adj}); "
          f"torch.fft (cuFFT) {rec['library_ms']:.4f} ms; bound {bound:.4f} ms [{card}]",
          flush=True)
    return rec


def in_turns(port, yardstick, timer, median, **kw):
    """Median ms of ``port`` and of ``yardstick`` under ``timer``, timed
    yardstick, port, port, yardstick."""
    y = timer(yardstick, **kw)
    p = timer(port, **kw)
    p += timer(port, **kw)
    y += timer(yardstick, **kw)
    return median(p), median(y)


def smoke():
    """``chip_smoke.py`` of this script's own checkout, for its constants and
    yardsticks."""
    sys.path.append(str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    return chip_smoke


def long_calls(gen):
    """The calls of ``--e2e`` (module docstring): (label, port, yardstick,
    timed queued too)."""
    S = smoke()
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.examples import system_identification as sysid
    la = T.linalg
    calls = []

    n, klen, batch = S.SYSID_BIG_N, S.SYSID["klen"], S.SYSID["batch"]
    xs, k_true, eps = sysid.make_problem(n, klen, batch, S.SYSID["noise"])
    xt = torch.from_numpy(xs).cuda()
    xi = torch.stack([xt, torch.zeros_like(xt)], -1)
    obs = torch.from_numpy(sysid.observations(xs, k_true, eps)).cuda()
    model, _ = sysid.make_model(n, klen, batch, device="cuda")
    yard_model = S.torch_fft_model(n, klen)
    with torch.no_grad():
        kt = torch.from_numpy(k_true).cuda()
        S.check_close("system identification: the model", model(kt, xi), yard_model(kt, xi),
                      "the same model on torch.fft")

    def trainer(mdl):
        k = torch.zeros(klen, device="cuda", requires_grad=True)
        opt = torch.optim.Adam([k], lr=S.SYSID["lr"])

        def step():
            opt.zero_grad(set_to_none=True)
            ((mdl(k, xi) - obs) ** 2).mean().backward()
            opt.step()
        return step
    calls.append(("system identification step 2^20 x 8, klen 33", trainer(model),
                  trainer(yard_model), False))

    rows, cols, rhs = S.LA_MATMUL
    cc, rr = (torch.randn(k, device="cuda", generator=gen, dtype=torch.float64).cpu().numpy()
              for k in (rows, cols))
    xm = torch.randn(cols, rhs, device="cuda", generator=gen)
    S.check_close("matmul_toeplitz", la.matmul_toeplitz((cc, rr), xm),
                  S.yard_call(la.matmul_toeplitz, (cc, rr), xm), "the same on torch.fft",
                  tol=S.LA_TOL)
    calls.append((f"matmul_toeplitz ({rows} x {cols}) @ ({cols}, {rhs})",
                  lambda: la.matmul_toeplitz((cc, rr), xm),
                  lambda: S.yard_call(la.matmul_toeplitz, (cc, rr), xm), True))

    m, rhs = S.LA_SOLVE
    ct = 0.5 ** np.arange(m)
    bt = torch.randn(m, rhs, device="cuda", generator=gen)
    S.check_close("solve_toeplitz", la.solve_toeplitz(ct, bt),
                  S.yard_call(la.solve_toeplitz, ct, bt), "the same on torch.fft", tol=S.LA_TOL)
    calls.append((f"solve_toeplitz {m} x {rhs}", lambda: la.solve_toeplitz(ct, bt),
                  lambda: S.yard_call(la.solve_toeplitz, ct, bt), True))

    plan = T.create_plan({"type": "fftconv", "shape": [S.OS_N], "batch": 1,
                          "fftConv": {"boundary": "circular", "kernelShape": [S.OS_TAPS]}},
                         device="cuda")
    xo = 0.05 * torch.randn(1, S.OS_N, 2, device="cuda", generator=gen)
    ko = 0.05 * torch.randn(S.OS_TAPS, 2, device="cuda", generator=gen)
    xc, kc = torch.view_as_complex(xo), torch.view_as_complex(ko)

    def os_yard():
        return S.torch_fft_conv(xc, kc, (S.OS_N,), (S.OS_N,), (0,), dtype=torch.complex64)
    S.check_close("overlap-save", torch.view_as_complex(plan(xo, kernel=ko)),
                  S.torch_fft_conv(xc, kc, (S.OS_N,), (S.OS_N,), (0,)), "torch.fft complex128")
    calls.append((f"overlap-save plan [2^20] * {S.OS_TAPS}", lambda: plan(xo, kernel=ko),
                  os_yard, True))
    return calls


def short_calls(gen):
    """The calls of ``--e2e-short`` (module docstring), as ``long_calls``."""
    S = smoke()
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    from webgpufft_tpu_torch.utils import mathref
    calls = []

    plan = T.create_plan(S.HEADLINE, device="cuda")
    xh = torch.randn(4096, 1024, 2, device="cuda", generator=gen)
    zh = torch.view_as_complex(xh)
    S.check_oracle("headline plan", plan(xh), torch.fft.fft(zh, norm="ortho"))
    calls.append(("headline plan(x) c2c [1024] b4096", lambda: plan(xh),
                  lambda: torch.fft.fft(zh, norm="ortho"), True))

    dct = T.create_plan({"type": "dct2", "shape": [512, 512], "batch": 8,
                         "normalize": "unitary"}, device="cuda")
    xd = torch.randn(8, 512, 512, device="cuda", generator=gen)
    S.check_close("dct2 [512, 512] b8", dct(xd), S.torch_fft_dct2(xd, 1.0 / 512),
                  "the DCT-II on torch.fft")
    calls.append(("dct2 [512, 512] b8 plan(x)", lambda: dct(xd),
                  lambda: S.torch_fft_dct2(xd, 1.0 / 512), True))

    shape, kshape = [1000, 1000], [25, 25]
    conv = T.create_plan({"type": "fftconv", "shape": shape, "batch": 8,
                          "fftConv": {"kernelShape": kshape, "boundary": "linear-same"}},
                         device="cuda")
    geo = mathref.fftconv_out_shape(shape, kshape, "linear-same")
    xc = torch.randn(8, 1000, 1000, 2, device="cuda", generator=gen)
    kc = torch.randn(25, 25, 2, device="cuda", generator=gen)
    zc, zk = torch.view_as_complex(xc), torch.view_as_complex(kc)
    S.check_close("fftconv [1000, 1000] b8", torch.view_as_complex(conv(xc, kernel=kc)),
                  S.torch_fft_conv(zc, zk, *geo), "torch.fft complex128")
    calls.append(("fftconv [1000, 1000] b8 k25x25 plan(x, kernel)", lambda: conv(xc, kernel=kc),
                  lambda: S.torch_fft_conv(zc, zk, *geo, dtype=torch.complex64), True))

    step, to_s, _ = ns.make_stepper3(S.NS_N, S.NS_NU, S.NS_DT, device="cuda")
    fstep, _, _ = S.torch_fft_stepper3(S.NS_N, S.NS_NU, S.NS_DT)
    u_hat = to_s(0.1 * torch.randn(3, S.NS_N, S.NS_N, S.NS_N, device="cuda", generator=gen))
    S.check_close("NS-3D step", step(u_hat), fstep(u_hat), "the torch.fft step")
    calls.append((f"NS-3D step {S.NS_N}^3", lambda: step(u_hat), lambda: fstep(u_hat), False))
    return calls


def end_to_end(calls, card, profile):
    """Each call from idle (and queued where asked) in turns beside its
    yardstick on ``torch.fft``, with its K1 launches; one record each."""
    S = smoke()
    records = []
    for label, port, yardstick, queued in calls:
        _, made = S.counted(port)
        rec = {"call": label, "k1_launches": made[0], "card": card}
        runs = dict(runs=S.GRAD_RUNS) if not queued else S.HEAVY
        rec["idle_ms"], rec["torch_fft_idle_ms"] = in_turns(port, yardstick, profile.time_calls,
                                                            profile.median, **runs)
        text = f"{rec['idle_ms']:.4f} ms idle"
        yard = f"{rec['torch_fft_idle_ms']:.4f} ms idle"
        if queued:
            rec["queued_ms"], rec["torch_fft_queued_ms"] = in_turns(
                port, yardstick, profile.time_queued, profile.median, **S.HEAVY_QUEUED)
            text += f" / {rec['queued_ms']:.4f} ms queued"
            yard += f" / {rec['torch_fft_queued_ms']:.4f} ms queued"
        print(f"{label}: port {text} (K1 launches {made[0]}); the same on torch.fft {yard} "
              f"[{card}]", flush=True)
        records.append(rec)
        torch.cuda.empty_cache()
    return records


def tables_on_card(consts):
    return {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda") for k, v in consts.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--out", type=Path, help="also write one JSON line a shape or call here")
    ap.add_argument("--e2e", action="store_true",
                    help="also time the calls whose K1 launches are long lines")
    ap.add_argument("--e2e-short", action="store_true",
                    help="also time the calls whose K1 launches are short lines")
    ap.add_argument("--k1-only", action="store_true", help="leave K2's shapes out")
    ap.add_argument("--k2-only", action="store_true", help="leave K1's shapes out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_k2_ring: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import probes
    from webgpufft_tpu_torch.core import fused, fused_cols, radix
    from webgpufft_tpu_torch.runtime import profile
    variants = getattr(probes, "variants", None)
    card = profile.card_line()
    print(f"k1_k2_ring: {Path(T.__file__).parent} [{card}]")
    gen = torch.Generator(device="cuda").manual_seed(13)
    records = []
    from k1_packed_variants import lines_for   # this checkout's line counts
    short = [(n, lines) for n in range(2, 129) if fused.choose_split(n)
             for lines in lines_for(n) if (n, lines) not in K1_CASES]
    for n, lines in [] if args.k2_only else K1_CASES + short:
        t = tables_on_card(fused.lines_consts(n, "forward", 1.0, "p"))
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        design = getattr(radix, "lines_design", lambda n: "direct")(n)
        rec = measure(
            f"K1 N={n} x {lines} lines (plans: {design})",
            lambda adj: fused.fused_lines_reference(x, t, adj),
            lambda: torch.fft.fft(torch.view_as_complex(x)), lambda: fused.fused_lines(x, t),
            [], None, 16 * n * lines, card, profile,
            plan_adjoint=lambda: fused.fused_lines(x, t, adjoint=True))
        if hasattr(fused, "launch_report"):
            launch = fused.launch_report(n, lines)
            rec.update(design=launch.design, resident=launch.resident, waves=launch.waves)
        records.append(rec)
        del x
    for pre, h, lanes in [] if args.k1_only else K2_CASES:
        t = tables_on_card(fused_cols.cols_consts(h, "forward", 1.0, "p"))
        x = torch.randn(pre, h, lanes, device="cuda", generator=gen)
        cols = lanes // 2
        label = f"K2 ({pre}, {h}, {lanes})"
        plans = {}
        if hasattr(fused_cols, "cols_rule"):
            launch, resident = fused_cols.launch_shape(pre, h, cols)
            plans = {**launch._asdict(), "resident": resident}
            label += (f" (plans: {launch.design}, tile {launch.tile}, cluster {launch.cluster}, "
                      f"units {launch.units}, grid {launch.grid})")
        elif hasattr(fused_cols, "launch_shape"):
            grid, tile = fused_cols.launch_shape(h, cols)
            plans = {"design": "ring" if grid else "direct", "tile": tile, "grid": grid}
            label += f" (plans: {plans['design']}, tile {tile})"
        designs = [d for d in ("direct", "ring", "ring-async")
                   if variants is not None and (pre, h, lanes) in RING_CASES]
        rec = measure(
            label, lambda adj: fused_cols.fused_cols_reference(x, t, adj),
            lambda: torch.fft.fft(torch.view_as_complex(x.view(pre, h, cols, 2)), dim=1),
            lambda: fused_cols.fused_cols(x, t), designs,
            lambda d, adj: variants.cols_variant(x, t, d, adjoint=adj), 8 * pre * h * lanes,
            card, profile, plan_adjoint=lambda: fused_cols.fused_cols(x, t, adjoint=True))
        rec["plans"] = plans
        records.append(rec)
        del x
    if args.e2e:
        records += end_to_end(long_calls(gen), card, profile)
    if args.e2e_short:
        records += end_to_end(short_calls(gen), card, profile)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(rec) + "\n" for rec in records))


if __name__ == "__main__":
    main()
