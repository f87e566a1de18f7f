"""Probe: K2's direct design and its ring design, and K1's long lines, in one run.

    python3 chip_probes/k1_k2_ring.py [--repo DIR] [--out PATH]   (from the repository root)

For every long shape of the kernel table in PERF.md (K1 from N = 2048 on,
K2 tiles of 8192 points or more) and a few beside them: the plans' own
launch (``fused.fused_lines`` / ``fused_cols.fused_cols``, whichever design
the entry point takes) in device time (``runtime/profile.time_queued``) and
in host time per call (``host_us``: the microseconds a call takes to return
while the device is busy, so that it only enqueues), beside
``torch.fft.fft`` (cuFFT) and the bound (one read and one write at 3.35
TB/s).  For K2, each design of ``webgpufft_tpu_torch.probes.variants``
(``direct``; ``ring``, a 3-D tensor map where the rows are aligned and the
tiles whole, cp.async otherwise; ``ring-async``, cp.async for every tile)
is first checked against the plain version (1e-5 of max|plain|, forward
and adjoint), then timed in turns, in order and in reverse, each time the
median of both turns, with its host time per call.  K1 has one design (the
ring was measured for its long lines and not kept: PERF.md).

``--e2e`` then times, from idle and queued, the calls whose K1 launches
are its long lines, each beside the same call on ``torch.fft`` (in turns:
yardstick, port, port, yardstick) and with its K1 launches: the
system-identification training step at 2^20 x 8 (forward + backward +
Adam, from idle only), ``matmul_toeplitz`` (4097 x 4096) @ (4096, 1024),
``solve_toeplitz`` 4096 x 256 and the overlap-save plan [2^20] * 129, set up
from ``chip_smoke.py``'s constants and helpers and checked as it checks
them.

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
# and 2048
K1_CASES = [(8192, 1024), (8192, 1032), (8192, 131), (8192, 512), (16384, 512), (4096, 4096),
            (2048, 4096), (2079, 4096), (6144, 1024), (5120, 1024), (9216, 1024), (12288, 512)]
# (pre, H, 2 * cols)
K2_CASES = [(8, 1024, 2048), (1, 1024, 2048), (8, 512, 1024), (8, 2048, 1024),
            (64, 1024, 66), (16, 4096, 64), (256, 256, 512)]
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


def measure(label, plain, library, plan, designs, run, nbytes, card, profile):
    """Check each design, time the designs in turns, then the plans' launch
    and the library call; returns the record."""
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
    rec["library_ms"] = profile.median(profile.time_queued(library))
    parts = "".join(f"{d} {rec[d]:.4f} ms (share {bound / rec[d]:.2f}, host "
                    f"{rec[f'{d}_host_us']:.2f} us); " for d in designs)
    print(f"{label}: {parts}the plans' launch {rec['plans_ms']:.4f} ms (share "
          f"{bound / rec['plans_ms']:.2f}, host {rec['plans_host_us']:.2f} us a call); "
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


def end_to_end(card, profile):
    """The calls of ``--e2e`` (module docstring); one record each."""
    sys.path.append(str(Path(__file__).resolve().parent.parent))
    import chip_smoke as S
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.examples import system_identification as sysid
    la = T.linalg
    gen = torch.Generator(device="cuda").manual_seed(S.SEED)
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_k2_ring: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import probes
    from webgpufft_tpu_torch.core import fused, fused_cols
    from webgpufft_tpu_torch.runtime import profile
    variants = getattr(probes, "variants", None)
    card = profile.card_line()
    print(f"k1_k2_ring: {Path(T.__file__).parent} [{card}]")
    gen = torch.Generator(device="cuda").manual_seed(13)
    records = []
    for n, lines in K1_CASES:
        t = tables_on_card(fused.lines_consts(n, "forward", 1.0, "p"))
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        records.append(measure(
            f"K1 N={n} x {lines} lines", lambda adj: fused.fused_lines_reference(x, t, adj),
            lambda: torch.fft.fft(torch.view_as_complex(x)), lambda: fused.fused_lines(x, t),
            [], None, 16 * n * lines, card, profile))
        del x
    for pre, h, lanes in K2_CASES:
        t = tables_on_card(fused_cols.cols_consts(h, "forward", 1.0, "p"))
        x = torch.randn(pre, h, lanes, device="cuda", generator=gen)
        cols = lanes // 2
        label = f"K2 ({pre}, {h}, {lanes})"
        if hasattr(fused_cols, "launch_shape"):
            grid, tile = fused_cols.launch_shape(h, cols)
            label += f" (plans: {'ring' if grid else 'direct'}, tile {tile})"
        designs = list(variants.COLS_DESIGNS) if variants is not None else []
        records.append(measure(
            label, lambda adj: fused_cols.fused_cols_reference(x, t, adj),
            lambda: torch.fft.fft(torch.view_as_complex(x.view(pre, h, cols, 2)), dim=1),
            lambda: fused_cols.fused_cols(x, t), designs,
            lambda d, adj: variants.cols_variant(x, t, d, adjoint=adj), 8 * pre * h * lanes,
            card, profile))
        del x
    if args.e2e:
        records += end_to_end(card, profile)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(rec) + "\n" for rec in records))


if __name__ == "__main__":
    main()
