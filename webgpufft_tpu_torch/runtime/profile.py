"""Roofline accounting + timing on CUDA events.

Port of ``webgpufft_tpu/runtime/profile.py``.  The FLOP and byte models and
the result records are the JAX package's; the timing is rewritten for a GPU
that the process drives directly: ``torch.cuda.Event`` pairs on the current
stream (a median of runs after a warm-up), and ``time.perf_counter`` around
the calls for CPU tensors.  The JAX module's tunnel protocols
(``unrolled_chain_time``, ``slope_chain_time``, ``hbm_stream_time``) exist to
cancel a remote runtime's per-dispatch latency and are not carried: an event
pair already measures device time.

Two ways to time a call on the card:

- ``time_calls``: one call between two events on an idle device.  The host's
  share of the call (Python, the wrappers, the launch) is in the number:
  what a caller who synchronizes after every call sees.
- ``time_queued``: several calls back to back behind a long elementwise
  kernel, so the device is still busy while the host enqueues them: device
  time per call, the host's share left out unless it exceeds the device's.

``chip_smoke.py``, ``chip_profile.py``, the scripts under ``chip_probes/``
and the measured planner (``runtime/measure.py``) all time through this
module.
"""

from __future__ import annotations

import math
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

# Peak device-memory bandwidth, GB/s, by ``torch.cuda.get_device_name``
# (data sheets).  A card that is not listed raises: no number is guessed.
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}
# Peak FP32 rate outside the tensor cores, GFLOP/s (data sheets).
FP32_GFLOPS = {
    "NVIDIA H100 80GB HBM3": 67000.0,
}

WARMUP = 5
RUNS = 25       # timed runs per call of a timing function
QUEUED = 10     # back-to-back calls per run of time_queued


def _device_name(device=None) -> str:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"no data-sheet numbers for device {dev}")
    return torch.cuda.get_device_name(dev)


def device_hbm_gbps(device=None) -> float:
    """The data-sheet memory bandwidth of ``device`` (default: the current
    CUDA device), GB/s."""
    name = _device_name(device)
    if name not in HBM_GBPS:
        raise ValueError(f"no data-sheet bandwidth recorded for {name!r}; "
                         f"known: {sorted(HBM_GBPS)}")
    return HBM_GBPS[name]


def device_fp32_gflops(device=None) -> float:
    """The data-sheet FP32 rate of ``device``, GFLOP/s."""
    name = _device_name(device)
    if name not in FP32_GFLOPS:
        raise ValueError(f"no data-sheet FP32 rate recorded for {name!r}; "
                         f"known: {sorted(FP32_GFLOPS)}")
    return FP32_GFLOPS[name]


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them: what
    stands beside every time that is kept (a card set below its full limit
    runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def fft_flops(n_total: int, batch: int) -> float:
    """The usual FLOP model: 5*N*log2(N) per transform."""
    return 5.0 * n_total * math.log2(max(n_total, 2)) * batch


def fft_min_bytes(n_total: int, batch: int, bytes_per_elem: int = 8) -> float:
    """Minimum memory traffic: read the input once + write the output once."""
    return 2.0 * n_total * batch * bytes_per_elem


def bound_ms(nbytes: float, flops: float, device=None):
    """(ms, "bytes" | "operations"): the least time ``device`` could take to
    move ``nbytes`` and do ``flops`` FP32 operations, whichever is more."""
    by_bytes = nbytes / (device_hbm_gbps(device) * 1e9) * 1e3
    by_ops = flops / (device_fp32_gflops(device) * 1e9) * 1e3
    return max((by_bytes, "bytes"), (by_ops, "operations"))


def median(xs) -> float:
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def time_calls(fn: Callable, *args, runs: int = RUNS, warmup: int = WARMUP,
               device="cuda") -> List[float]:
    """``runs`` single-call times in ms after ``warmup`` calls.  On a CUDA
    device each is one event pair around one call on an idle device (the
    host's share of the call included); on the CPU, ``perf_counter``."""
    for _ in range(warmup):
        fn(*args)
    times = []
    if not _is_cuda(device):
        for _ in range(runs):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    torch.cuda.synchronize(device)
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


_blocker: Optional[torch.Tensor] = None


def time_queued(fn: Callable, *args, runs: int = RUNS, queued: int = QUEUED,
                warmup: int = WARMUP, device="cuda") -> List[float]:
    """``runs`` per-call times in ms, each from ``queued`` back-to-back calls
    between two events, over ``queued``.  On a CUDA device a long elementwise
    pass (1 GiB) is queued first, so the device is still busy while the host
    enqueues and the calls run back to back: device time, without the host's
    share unless that exceeds the device's.  On the CPU it is the plain mean
    of ``queued`` calls."""
    global _blocker
    for _ in range(warmup):
        fn(*args)
    times = []
    if not _is_cuda(device):
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(queued):
                fn(*args)
            times.append((time.perf_counter() - t0) * 1e3 / queued)
        return times
    if _blocker is None or _blocker.device != torch.device(device):
        _blocker = torch.zeros(1 << 28, device=device)
    for _ in range(runs):
        _blocker.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(queued):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / queued)
    return times


def time_chained(fn: Callable, x, iters: int, *, warmup: int = 2) -> float:
    """Average seconds per call of ``fn`` with a serializing data dependency
    (y = fn(y)): one event pair (or ``perf_counter`` on the CPU) around
    ``iters`` chained calls.  ``fn`` must map a tensor to a same-shaped one."""
    y = x
    for _ in range(warmup):
        y = fn(y)
    y = x
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn(y)
        return max((time.perf_counter() - t0) / iters, 1e-9)
    torch.cuda.synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        y = fn(y)
    end.record()
    end.synchronize()
    return max(start.elapsed_time(end) * 1e-3 / iters, 1e-9)


@dataclass
class BenchResult:
    avg_ms: float
    gflops: float
    eff_gbps: float
    pct_roofline: float
    iters: int


def bench_transform(fn: Callable, x, n_total: int, batch: int,
                    iters: int = 30) -> BenchResult:
    """``time_chained`` of ``fn`` on CUDA tensor ``x`` beside the FLOP model
    and the card's data-sheet bandwidth."""
    dt = time_chained(fn, x, iters)
    gf = fft_flops(n_total, batch) / dt / 1e9
    gb = fft_min_bytes(n_total, batch) / dt / 1e9
    roof = device_hbm_gbps(x.device)
    return BenchResult(avg_ms=dt * 1e3, gflops=gf, eff_gbps=gb,
                       pct_roofline=100.0 * gb / roof, iters=iters)


@dataclass
class RobustBenchResult:
    avg_ms: float             # best-of-trials median device time per call
    eff_gbps: float           # min_bytes / time
    pct_roofline: float       # vs the data-sheet bandwidth
    copy_ceiling_gbps: float  # best copy bandwidth measured beside it
    vs_copy_ceiling: float    # eff_gbps / copy_ceiling
    trials: int


def measured_copy_ceiling_gbps(x, *, reps: int = 8) -> float:
    """Achievable bandwidth: the device time of an elementwise negation (one
    read + one write) of a tensor of ``x``'s size, median of ``reps``."""
    flat = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
    out = torch.empty_like(flat)
    ms = median(time_queued(lambda: torch.neg(flat, out=out), runs=max(reps, 1),
                            device=x.device))
    return 2.0 * flat.numel() * flat.element_size() / (ms * 1e-3) / 1e9


def robust_bench(fn: Callable, x, min_bytes: float, *, reps: int = 8,
                 trials: int = 3) -> RobustBenchResult:
    """``trials`` alternating (transform, copy probe) measurements on CUDA
    tensor ``x``, best-of over trials for both, so ``vs_copy_ceiling`` sees
    the same device conditions above and below the line."""
    best_ms = float("inf")
    best_ceil = 0.0
    for _ in range(max(trials, 1)):
        best_ms = min(best_ms, median(time_queued(fn, x, runs=max(reps, 1),
                                                  device=x.device)))
        best_ceil = max(best_ceil, measured_copy_ceiling_gbps(x, reps=reps))
    gb = min_bytes / (best_ms * 1e-3) / 1e9
    roof = device_hbm_gbps(x.device)
    return RobustBenchResult(
        avg_ms=best_ms, eff_gbps=gb, pct_roofline=100.0 * gb / roof,
        copy_ceiling_gbps=best_ceil,
        vs_copy_ceiling=gb / best_ceil if best_ceil > 0 else 0.0, trials=trials)
