"""Smoke run of the PyTorch port (webgpufft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout's sources, holds each
kernel against its plain PyTorch version (at the shapes the paths below give
it, and at lengths that stress the radix chain: the shared-memory limit, every
odd radix, one-butterfly lengths, a ragged column count, small digits), and
drives four paths through the
port's entry points, each with the kernels' launch counts set to 0 just
before it and read just after (each must launch both kernels):

- c2c: ``create_plan(...)(x)`` on the batched 1-D headline plan and a 256^3
  plan;
- r2c: the 256^3 batch-3 plan of the Navier-Stokes step;
- c2r: the 256^3 batch-6 plan of the same step;
- ns3d: the 3-D Navier-Stokes solver (``webgpufft_tpu_torch.examples.
  navier_stokes3d``) at 256^3, nu = 2e-2, dt = 1e-2, on the embedded
  Taylor-Green vortex and the ABC flow, held against their analytic
  solutions at rel err < 1e-4.

Plans and kernels are checked against ``torch.fft`` as an independent
oracle, as are the Rader, Bluestein and four-step axes and the odd-length
r2c paths.  Then each kernel is timed beside its plain version, its bound
(the bytes it must move, one read and one write, over the data sheet's
3.35 TB/s, or its flops over 67 TFLOP/s if that is more) and the one
``torch.fft.fft`` call that computes the same function (cuFFT, a yardstick the
port never calls), and each plan and the solver step beside ``torch.fft``.
Every phase raises on failure, so the script exits non-zero; it never falls
back to the CPU.

Tolerance, unless a phase says otherwise: max|actual - expected| <= 1e-5 *
max|expected|, the JAX package's f32 accuracy bar.  TF32 is switched off for
this process so the plain versions and the oracle contract in full f32.

Output: one line per result; then the kernel record as one JSON object, the
``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import time

import numpy as np
import torch

TOL = 1e-5
NS_TOL = 1e-4      # the solver against its analytic solutions
SEED = 1234
WARMUP = 5
RUNS = 25          # timed calls per block; two blocks per version
QUEUED = 10        # back-to-back launches per timed run of a kernel
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores
NS_N, NS_NU, NS_DT, NS_STEPS = 256, 2e-2, 1e-2, 5
RFFT_DIMS = (2, 3, 1)   # torch.fft.rfftn packs the last dim given: logical axis 0


def rel_err(actual, expected):
    return float((actual - expected).abs().max() / expected.abs().max())


def abs_err(actual, expected):
    return float((actual - expected).abs().max())


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line():
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"count {torch.cuda.device_count()}")
    print(f"device: nvidia-smi name,power.limit = {smi}")
    print(f"device: allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build():
    from webgpufft_tpu_torch import _build
    t0 = time.perf_counter()
    path = _build.library_path()
    fresh = not path.exists()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.2f} s ({'compiled' if fresh else 'reused'} "
          f"{path.name} with {' '.join(_build.NVCC_FLAGS)})")


def to_dev(consts):
    return {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
            for k, v in consts.items()}


def cols_tables_h2_is_1(h, direction, scale):
    """K2 tables for the degenerate split (h, 1): stage 1 is the identity."""
    from webgpufft_tpu_torch.core import dft, radix
    w1 = dft.dft_matrix(h, direction) * np.complex64(scale)
    ones = np.ones((h, 1, 1), np.float32)
    return to_dev({**radix.chain_consts(h, direction, scale, "p"),
                   "p/w1re": w1.real.astype(np.float32),
                   "p/w1im": w1.imag.astype(np.float32),
                   "p/tre": ones, "p/tim": np.zeros_like(ones),
                   "p/w2re": np.ones((1, 1), np.float32),
                   "p/w2im": np.zeros((1, 1), np.float32)})


def compare(label, kernel, plain, x, tables):
    y = kernel(x, tables)
    ref = plain(x, tables)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(y).all()), f"{label}: non-finite kernel output")
    err = rel_err(y, ref)
    aerr = abs_err(y, ref)
    print(f"{label}: max rel err {err:.3e}, max abs err {aerr:.3e} vs plain "
          f"(limit {TOL:.0e} * max|plain|)")
    require(err <= TOL, f"{label}: kernel disagrees with its plain version")
    return aerr


def phase_k1(gen):
    from webgpufft_tpu_torch.core import fused, radix
    cases = {}
    worst = 0.0
    # the headline and non-square splits; the shapes the r2c (batch 3) and c2r
    # (batch 6) paths give K1 at 256^3 (b*128*256 body lines and b*256
    # Nyquist-slab lines of 256); then lengths that stress the radix chain:
    # 128 * 128 (the shared-memory limit), every odd radix, 13 * 13 * 8, short
    # lines that take the multi-line CTA, and the small digits 8 * 8 and 8 * 16
    for n, lines, direction, normalize in [
            (1024, 4096, "forward", "unitary"), (1024, 4096, "inverse", "unitary"),
            (2048, 4096, "forward", "none"), (360, 4096, "inverse", "backward"),
            (256, 3 * 128 * 256, "forward", "none"), (256, 6 * 256, "inverse", "none"),
            (16384, 512, "inverse", "backward"), (2310, 2048, "forward", "unitary"),
            (4096, 4096, "forward", "none"), (1352, 1025, "inverse", "unitary"),
            (16, 100003, "forward", "none"), (6, 77, "inverse", "backward"),
            (64, 65536, "forward", "none"), (128, 8192, "inverse", "unitary")]:
        scale = {"none": 1.0, "unitary": 1.0 / math.sqrt(n),
                 "backward": 1.0 / n if direction == "inverse" else 1.0}[normalize]
        tables = to_dev(fused.lines_consts(n, direction, scale, "p"))
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        label = (f"K1 fused_lines N={n} chain={radix.radix_chain(n)} lines={lines} "
                 f"{direction} {normalize}")
        worst = max(worst, compare(label, fused.fused_lines, fused.fused_lines_reference,
                                   x, tables))
        cases[(n, lines, direction)] = (x, tables, normalize)
    return cases, worst


def phase_k2(gen):
    from webgpufft_tpu_torch.core import fused_cols, radix
    cases = {}
    worst = 0.0
    # the c2c 256^3 view and other splits; the views the r2c (batch 3) and c2r
    # (batch 6) paths give K2 at 256^3 ((b*128, 256, 512) bodies and the
    # (b, 256, 512) Nyquist slab); then a tall tile at the shared-memory limit,
    # a ragged column count (33), every odd radix, and the small-digit views
    # 8 * 16 and 8 * 8 of rank > 1 plans
    for pre, h, lanes, direction in [
            (256, 256, 512, "forward"), (1, 256, 131072, "forward"),
            (64, 360, 512, "forward"), (256, 16, 512, "forward"),
            (3 * 128, 256, 512, "forward"), (6 * 128, 256, 512, "inverse"),
            (3, 256, 512, "forward"), (8, 16384, 64, "inverse"), (5, 2048, 66, "forward"),
            (3, 2310, 66, "inverse"), (4, 1352, 130, "forward"),
            (3 * 128, 128, 512, "forward"), (64, 64, 128, "inverse")]:
        if h == 16:
            tables = cols_tables_h2_is_1(h, direction, 1.0)
            split = (16, 1)
        else:
            tables = to_dev(fused_cols.cols_consts(h, direction, 1.0, "p"))
            split = fused_cols.choose_split(h)
        x = torch.randn(pre, h, lanes, device="cuda", generator=gen)
        label = (f"K2 fused_cols view=({pre}, {h}, {lanes}) split={split} "
                 f"chain={radix.radix_chain(h)} {direction}")
        worst = max(worst, compare(label, fused_cols.fused_cols,
                                   fused_cols.fused_cols_reference, x, tables))
        cases[(pre, h, lanes)] = (x, tables, direction)
    return cases, worst


def check_oracle(label, y, expected):
    torch.cuda.synchronize()
    require(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    err = rel_err(torch.view_as_complex(y), expected)
    print(f"{label}: max rel err {err:.3e} vs torch.fft (limit {TOL:.0e} * max|expected|)")
    require(err <= TOL, f"{label}: disagrees with torch.fft")


def phase_headline(gen):
    import webgpufft_tpu_torch as T
    opts = {"type": "c2c", "shape": [1024], "batch": 4096,
            "direction": "forward", "normalize": "unitary"}
    plan = T.create_plan(opts, device="cuda")
    x = torch.randn(4096, 1024, 2, device="cuda", generator=gen)
    y = plan(x)
    require(tuple(y.shape) == (4096, 1024, 2) and y.dtype == torch.float32,
            f"headline: output {y.dtype} {tuple(y.shape)}")
    require(plan.route.mode == "pallas-fused",
            f"headline: route {plan.route.mode} {plan.route.reasons}")
    print(f"headline plan c2c [1024] b4096 forward unitary: route {plan.route.mode}, "
          f"reasons {list(plan.route.reasons)}")
    check_oracle("headline plan", y,
                 torch.fft.fft(torch.view_as_complex(x), norm="ortho"))
    return plan, x


def phase_3d(gen):
    import webgpufft_tpu_torch as T
    shape = [256, 256, 256]
    fwd = T.create_plan({"type": "c2c", "shape": shape, "batch": 1,
                         "direction": "forward", "normalize": "backward"}, device="cuda")
    inv = T.create_plan({"type": "c2c", "shape": shape, "batch": 1,
                         "direction": "inverse", "normalize": "backward"}, device="cuda")
    want = ("c2c-axis0-fused-cols", "c2c-axis1-fused-cols", "c2c-axis2-fused-lines")
    for plan in (fwd, inv):
        require(plan.route.mode == "pallas-fused"
                and all(r in plan.route.reasons for r in want),
                f"256^3: route {plan.route.mode} {plan.route.reasons}")
    print(f"3-D plan c2c 256^3 b1: route {fwd.route.mode}, reasons {list(fwd.route.reasons)}")
    x = torch.randn(1, *shape, 2, device="cuda", generator=gen)
    y = fwd(x)
    check_oracle("3-D plan forward", y,
                 torch.fft.fftn(torch.view_as_complex(x), dim=(1, 2, 3)))
    back = inv(y)
    torch.cuda.synchronize()
    err = rel_err(back, x)
    print(f"3-D plan round trip: max rel err {err:.3e} vs input (limit {TOL:.0e} * max|x|)")
    require(err <= TOL, "3-D plan round trip does not return the input")
    return fwd, x


def real_plan(kind, batch, normalize):
    import webgpufft_tpu_torch as T
    return T.create_plan({"type": kind, "shape": [NS_N] * 3, "batch": batch,
                          "direction": "forward" if kind == "r2c" else "inverse",
                          "normalize": normalize}, device="cuda")


def check_real_route(label, plan):
    kind = plan.spec.plan_type
    want = (f"{kind}-axis1-fused-cols", f"{kind}-axis2-fused-lines")
    print(f"{label}: route {plan.route.mode}, reasons {list(plan.route.reasons)}")
    require(plan.route.mode == "pallas-mixed" and all(r in plan.route.reasons for r in want),
            f"{label}: route {plan.route.mode} {plan.route.reasons}")


def phase_r2c(gen):
    """The solver's r2c plan, [256]^3 batch 3, on six fields in two calls;
    returns the fields and their packed spectra for the c2r path."""
    plan = real_plan("r2c", 3, "none")
    check_real_route("r2c 256^3 b3", plan)
    x = torch.randn(6, NS_N, NS_N, NS_N, device="cuda", generator=gen)
    y = torch.cat([plan(x[:3]), plan(x[3:])])
    require(tuple(y.shape) == (6, NS_N // 2 + 1, NS_N, NS_N, 2), f"r2c: output {tuple(y.shape)}")
    check_oracle("r2c 256^3 b3", y, torch.fft.rfftn(x, dim=RFFT_DIMS))
    return x, y


def phase_c2r(y):
    """The solver's c2r plan, [256]^3 batch 6, on the r2c spectra."""
    plan = real_plan("c2r", 6, "backward")
    check_real_route("c2r 256^3 b6", plan)
    back = plan(y)
    torch.cuda.synchronize()
    want = torch.fft.irfftn(torch.view_as_complex(y), s=(NS_N,) * 3, dim=RFFT_DIMS)
    err = rel_err(back, want)
    print(f"c2r 256^3 b6: max rel err {err:.3e} vs torch.fft (limit {TOL:.0e} * max|expected|)")
    require(bool(torch.isfinite(back).all()) and err <= TOL, "c2r disagrees with torch.fft")
    return back


def phase_real_round_trips(x, y, back):
    err = rel_err(back, x)
    print(f"r2c -> c2r round trip 256^3: max rel err {err:.3e} vs input (limit {TOL:.0e})")
    require(err <= TOL, "r2c -> c2r round trip does not return the input")
    again = real_plan("r2c", 3, "none")(back[:3])
    torch.cuda.synchronize()
    err = rel_err(again, y[:3])
    print(f"c2r -> r2c round trip 256^3: max rel err {err:.3e} vs spectrum (limit {TOL:.0e})")
    require(err <= TOL, "c2r -> r2c round trip does not return the spectrum")


def phase_axis_kinds(gen):
    """Rader, Bluestein and four-step c2c axes and the odd-n0 r2c paths
    against torch.fft."""
    import webgpufft_tpu_torch as T
    for shape, batch, kind in [([4093], 256, "rader"), ([4099], 256, "bluestein"),
                               ([1048576], 4, "four-step")]:
        plan = T.create_plan({"type": "c2c", "shape": shape, "batch": batch}, device="cuda")
        require(kind in plan.route.axis_kinds or plan.route.mode == "four-step-hbm",
                f"c2c {shape}: route {plan.route.mode} {plan.route.axis_kinds}")
        x = torch.randn(batch, *shape, 2, device="cuda", generator=gen)
        check_oracle(f"c2c {shape} b{batch} ({kind}, route {plan.route.mode})", plan(x),
                     torch.fft.fft(torch.view_as_complex(x)))
    for shape in ([17], [9, 4]):
        plan = T.create_plan({"type": "r2c", "shape": shape, "batch": 4096}, device="cuda")
        x = torch.randn(4096, *shape, device="cuda", generator=gen)
        dims = tuple(range(2, 1 + len(shape))) + (1,)
        check_oracle(f"r2c {shape} b4096 (odd n0, route {plan.route.mode})", plan(x),
                     torch.fft.rfftn(x, dim=dims))


def phase_ns3d():
    """The solver at 256^3 on two flows with analytic solutions."""
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    t_end = NS_DT * NS_STEPS
    for label, make in [("embedded Taylor-Green", ns.taylor_green_embedded),
                        ("ABC flow", ns.abc_flow)]:
        u = ns.run3(make(NS_N, 0.0, NS_NU, device="cuda"), NS_N, NS_NU, NS_DT, NS_STEPS,
                    device="cuda")
        ref = make(NS_N, t_end, NS_NU, device="cuda")
        torch.cuda.synchronize()
        require(tuple(u.shape) == (3, NS_N, NS_N, NS_N) and bool(torch.isfinite(u).all()),
                f"NS-3D {label}: output {tuple(u.shape)}")
        err = rel_err(u, ref)
        print(f"NS-3D {label} {NS_N}^3, nu={NS_NU}, dt={NS_DT}, {NS_STEPS} steps (t={t_end:g}): "
              f"max rel err {err:.3e} vs analytic (limit {NS_TOL:.0e})")
        require(err < NS_TOL, f"NS-3D {label} departs from its analytic solution")


def drive(name, paths, fn, *args):
    """Run one path with both launch counts set to 0 just before it and
    read just after; both kernels must have launched."""
    from webgpufft_tpu_torch.core import fused, fused_cols
    fused.fused_lines.launches = 0
    fused_cols.fused_cols.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    k1, k2 = fused.fused_lines.launches, fused_cols.fused_cols.launches
    print(f"path {name} launches: fused_lines {k1}, fused_cols {k2}")
    require(k1 > 0, f"path {name} never launched fused_lines")
    require(k2 > 0, f"path {name} never launched fused_cols")
    paths[name] = (k1, k2)
    return out


def time_ms(fn, *args):
    """RUNS single-call times from CUDA events on an idle device, after
    WARMUP: the host's share of the call is in each."""
    for _ in range(WARMUP):
        fn(*args)
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


def time_queued(fn, *args, runs=RUNS):
    """Device time of one call: median over ``runs`` of QUEUED back-to-back
    calls between two CUDA events, over QUEUED.  A long elementwise pass is
    queued first, so the device is still busy while the host enqueues and
    the calls run back to back: the host's share of a call (tens of
    microseconds in the wrappers) is left out unless it exceeds the device's."""
    if time_queued.blocker is None:
        time_queued.blocker = torch.zeros(1 << 28, device="cuda")
    for _ in range(WARMUP):
        fn(*args)
    times = []
    for _ in range(runs):
        time_queued.blocker.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(QUEUED):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / QUEUED)
    return times


time_queued.blocker = None


def fft_norm(direction, normalize):
    """The ``norm`` of torch.fft that matches a plan's normalize."""
    if normalize == "unitary":
        return "ortho"
    unscaled = "backward" if direction == "forward" else "forward"
    return unscaled if normalize == "none" else "backward"


def time_kernel(label, kernel, plain, library, args, n, transforms, card):
    """One kernel shape: the kernel's device time beside its plain version's
    and the library call's (plain, library, kernel, kernel, library, plain:
    medians over both blocks of each), its bound, and the single-call time
    from an idle device, host share included."""
    nbytes = 16 * n * transforms                       # one read, one write
    flops = 5.0 * n * math.log2(n) * transforms        # a radix-2 FFT's count
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    bound, bound_by = max((by_bytes, "bytes"), (by_ops, "operations"))
    p = time_queued(plain, *args, runs=8)
    f = time_queued(library, args[0])
    k = time_queued(kernel, *args)
    k += time_queued(kernel, *args)
    f += time_queued(library, args[0])
    p += time_queued(plain, *args, runs=8)
    km, pm, fm = median(k), median(p), median(f)
    idle = median(time_ms(kernel, *args))
    print(f"time {label}: kernel {km:.4f} ms ({nbytes / km / 1e6:.1f} GB/s, "
          f"roofline share {bound / km:.2f}), plain {pm:.4f} ms, bound {bound:.4f} ms by "
          f"{bound_by} ({nbytes} bytes at 3.35 TB/s), torch.fft.fft (cuFFT) {fm:.4f} ms; "
          f"one call from idle {idle:.4f} ms [{card}]")
    return {"ms": km, "plain_ms": pm, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": fm}


def phase_timing(k1_cases, k2_cases, headline, volume, card):
    from webgpufft_tpu_torch.core import fused, fused_cols
    out = {}
    for (n, lines, direction), (x, t, normalize) in k1_cases.items():
        if (n, direction) == (1024, "inverse"):
            continue  # same work as the forward headline
        fft = torch.fft.fft if direction == "forward" else torch.fft.ifft
        norm = fft_norm(direction, normalize)
        out[("K1", n, lines)] = time_kernel(
            f"K1 fused_lines N={n} lines={lines}", fused.fused_lines,
            fused.fused_lines_reference,
            lambda v, fft=fft, norm=norm: fft(torch.view_as_complex(v), dim=-1, norm=norm),
            (x, t), n, lines, card)
    for (pre, h, lanes), (x, t, direction) in k2_cases.items():
        fft = torch.fft.fft if direction == "forward" else torch.fft.ifft
        norm = fft_norm(direction, "none")
        out[("K2", pre, h, lanes)] = time_kernel(
            f"K2 fused_cols view=({pre}, {h}, {lanes})", fused_cols.fused_cols,
            fused_cols.fused_cols_reference,
            lambda v, fft=fft, norm=norm: fft(
                torch.view_as_complex(v.view(v.shape[0], v.shape[1], -1, 2)), dim=1, norm=norm),
            (x, t), h, pre * lanes // 2, card)
    for label, (plan, x), oracle in [
            ("headline plan(x) c2c [1024] b4096", headline,
             lambda z: torch.fft.fft(z, norm="ortho")),
            ("3-D plan(x) c2c 256^3 b1", volume,
             lambda z: torch.fft.fftn(z, dim=(1, 2, 3)))]:
        pm = median(time_ms(plan, x))
        fm = median(time_ms(lambda v: torch.view_as_real(oracle(torch.view_as_complex(v))), x))
        nbytes = 8 * x.numel()
        print(f"time {label}: {pm:.4f} ms ({nbytes / pm / 1e6:.1f} GB/s); torch.fft "
              f"(cuFFT) yardstick {fm:.4f} ms ({nbytes / fm / 1e6:.1f} GB/s), "
              f"min-bytes {nbytes} [{card}]")
    return out


def phase_solver_timing(gen, x, y, card):
    """The solver's plans beside torch.fft, and one solver step beside the
    same step on torch.fft.rfftn/irfftn (ms per step, CUDA events)."""
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    r2c, c2r = real_plan("r2c", 3, "none"), real_plan("c2r", 6, "backward")
    x3 = x[:3].contiguous()
    for label, plan, arg, plain in [
            ("r2c 256^3 b3", r2c, x3, lambda v: torch.fft.rfftn(v, dim=RFFT_DIMS)),
            ("c2r 256^3 b6", c2r, y,
             lambda v: torch.fft.irfftn(torch.view_as_complex(v), s=(NS_N,) * 3, dim=RFFT_DIMS))]:
        pm = median(time_ms(plan, arg))
        fm = median(time_ms(plain, arg))
        print(f"time {label} plan(x): {pm:.4f} ms; torch.fft (cuFFT) {fm:.4f} ms [{card}]")
    step, to_s, _ = ns.make_stepper3(NS_N, NS_NU, NS_DT, device="cuda")
    fstep, _, _ = ns.make_torch_fft_stepper3(NS_N, NS_NU, NS_DT, device="cuda")
    u_hat = to_s(0.1 * torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen))
    err = rel_err(step(u_hat), fstep(u_hat))
    print(f"NS-3D step {NS_N}^3: max rel err {err:.3e} vs the torch.fft step "
          f"(limit {TOL:.0e} * max|expected|)")
    require(err <= TOL, "NS-3D step disagrees with the torch.fft step")
    p = time_ms(fstep, u_hat)
    k = time_ms(step, u_hat)
    k += time_ms(step, u_hat)
    p += time_ms(fstep, u_hat)
    km, pm = median(k), median(p)
    print(f"time NS-3D step {NS_N}^3 (RK2: 2 x (c2r b6 + r2c b3) + pointwise): "
          f"port {km:.4f} ms/step, torch.fft step {pm:.4f} ms/step [{card}]")
    return km, pm


def main():
    card_name, smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_build()
    k1_cases, k1_err = phase_k1(gen)
    k2_cases, k2_err = phase_k2(gen)

    # the main paths: the counts of each are launches made by its own
    # entry-point calls only
    paths = {}
    headline, volume = drive("c2c", paths, lambda: (phase_headline(gen), phase_3d(gen)))
    x, y = drive("r2c", paths, phase_r2c, gen)
    back = drive("c2r", paths, phase_c2r, y)
    phase_real_round_trips(x, y, back)
    del back
    phase_axis_kinds(gen)
    drive("ns3d", paths, phase_ns3d)

    times = phase_timing(k1_cases, k2_cases, headline, volume, smi)
    phase_solver_timing(gen, x, y, smi)
    # each kernel's record carries the times of its headline shape
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"webgpufft_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": sum(c[i] for c in paths.values()),
         "launches_by_path": {p: c[i] for p, c in paths.items()},
         "max_abs_err": err, "shape": shape, **times[key]}
        for i, (name, src, replaces, err, shape, key) in enumerate([
            ("fused_lines", "fused_lines.cu", "webgpufft_tpu/core/fused.py:223",
             k1_err, "N=1024 x 4096 lines", ("K1", 1024, 4096)),
            ("fused_cols", "fused_cols.cu", "webgpufft_tpu/core/fused_cols.py:161",
             k2_err, "view (256, 256, 512)", ("K2", 256, 256, 512))])]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
