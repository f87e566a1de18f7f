"""Smoke run of the PyTorch port (webgpufft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout's sources, holds each
kernel against its plain PyTorch version, drives the c2c main path through
``create_plan(...)(x)`` (the batched 1-D headline plan and a 256^3 plan),
checks the results against ``torch.fft`` as an independent oracle, and times
each kernel beside its plain version.  Every phase raises on failure, so the
script exits non-zero; it never falls back to the CPU.

Tolerance everywhere: max|actual - expected| <= 1e-5 * max|expected|, the
JAX package's f32 accuracy bar.  TF32 is switched off for this process so
the plain versions and the oracle contract in full f32.

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
SEED = 1234
WARMUP = 5
RUNS = 25          # timed launches per block; two blocks per version


def rel_err(actual, expected):
    return float((actual - expected).abs().max() / expected.abs().max())


def abs_err(actual, expected):
    return float((actual - expected).abs().max())


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
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
    from webgpufft_tpu_torch.core import dft
    w1 = dft.dft_matrix(h, direction) * np.complex64(scale)
    ones = np.ones((h, 1, 1), np.float32)
    return to_dev({"p/w1re": w1.real.astype(np.float32),
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
    from webgpufft_tpu_torch.core import fused
    cases = {}
    worst = 0.0
    for n, lines, direction, normalize in [
            (1024, 4096, "forward", "unitary"), (1024, 4096, "inverse", "unitary"),
            (2048, 4096, "forward", "none"), (360, 4096, "inverse", "backward")]:
        scale = {"none": 1.0, "unitary": 1.0 / math.sqrt(n),
                 "backward": 1.0 / n if direction == "inverse" else 1.0}[normalize]
        tables = to_dev(fused.lines_consts(n, direction, scale, "p"))
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        label = f"K1 fused_lines N={n} split={fused.choose_split(n)} lines={lines} {direction} {normalize}"
        worst = max(worst, compare(label, fused.fused_lines, fused.fused_lines_reference,
                                   x, tables))
        cases[(n, lines, direction)] = (x, tables)
    return cases, worst


def phase_k2(gen):
    from webgpufft_tpu_torch.core import fused_cols
    cases = {}
    worst = 0.0
    for pre, h, lanes in [(256, 256, 512), (1, 256, 131072), (64, 360, 512), (256, 16, 512)]:
        if h == 16:
            tables = cols_tables_h2_is_1(h, "forward", 1.0)
            split = (16, 1)
        else:
            tables = to_dev(fused_cols.cols_consts(h, "forward", 1.0, "p"))
            split = fused_cols.choose_split(h)
        x = torch.randn(pre, h, lanes, device="cuda", generator=gen)
        label = f"K2 fused_cols view=({pre}, {h}, {lanes}) split={split} forward"
        worst = max(worst, compare(label, fused_cols.fused_cols,
                                   fused_cols.fused_cols_reference, x, tables))
        cases[(pre, h, lanes)] = (x, tables)
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


def time_ms(fn, *args):
    """Median of RUNS single-launch times from CUDA events, after WARMUP."""
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


def time_pair(label, kernel, plain, args, nbytes, card):
    """Plain, kernel, kernel, plain: medians over both blocks of each."""
    p = time_ms(plain, *args)
    k = time_ms(kernel, *args)
    k += time_ms(kernel, *args)
    p += time_ms(plain, *args)
    km, pm = median(k), median(p)
    print(f"time {label}: kernel {km:.4f} ms ({nbytes / km / 1e6:.1f} GB/s), "
          f"plain {pm:.4f} ms ({nbytes / pm / 1e6:.1f} GB/s), "
          f"min-bytes {nbytes} [{card}]")
    return km, pm


def phase_timing(k1_cases, k2_cases, headline, volume, card):
    from webgpufft_tpu_torch.core import fused, fused_cols
    out = {}
    for (n, lines, direction), (x, t) in k1_cases.items():
        if (n, direction) == (1024, "inverse"):
            continue  # same work as the forward headline
        out[("K1", n)] = time_pair(f"K1 fused_lines N={n} lines={lines}", fused.fused_lines,
                                   fused.fused_lines_reference, (x, t), 16 * n * lines, card)
    for (pre, h, lanes), (x, t) in k2_cases.items():
        out[("K2", pre, h, lanes)] = time_pair(
            f"K2 fused_cols view=({pre}, {h}, {lanes})", fused_cols.fused_cols,
            fused_cols.fused_cols_reference, (x, t), 8 * pre * h * lanes, card)
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


def main():
    card_name, smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_build()
    k1_cases, k1_err = phase_k1(gen)
    k2_cases, k2_err = phase_k2(gen)

    from webgpufft_tpu_torch.core import fused, fused_cols
    # the main path: the counts below are launches made by create_plan(...)(x) only
    fused.fused_lines.launches = 0
    fused_cols.fused_cols.launches = 0
    headline = phase_headline(gen)
    volume = phase_3d(gen)
    k1_launches = fused.fused_lines.launches
    k2_launches = fused_cols.fused_cols.launches
    print(f"main path launches: fused_lines {k1_launches}, fused_cols {k2_launches}")
    require(k1_launches > 0, "main path never launched fused_lines")
    require(k2_launches > 0, "main path never launched fused_cols")

    times = phase_timing(k1_cases, k2_cases, headline, volume, smi)
    k1_ms, k1_plain = times[("K1", 1024)]
    k2_ms, k2_plain = times[("K2", 256, 256, 512)]
    record = {"kernels": [
        {"name": "fused_lines", "route": "cuda",
         "source": "webgpufft_tpu_torch/csrc/fused_lines.cu",
         "replaces": "webgpufft_tpu/core/fused.py:223", "launches": k1_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "fused_cols", "route": "cuda",
         "source": "webgpufft_tpu_torch/csrc/fused_cols.cu",
         "replaces": "webgpufft_tpu/core/fused_cols.py:161", "launches": k2_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
