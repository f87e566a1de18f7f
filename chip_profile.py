"""Where the device time goes in the PyTorch port's main paths, on one GPU.

    python3 chip_profile.py

Profiles, with ``torch.profiler`` (CPU and CUDA activities), a few calls of
the headline c2c plan ([1024] x 4096), the c2c 256^3 plan, the dct2
[512, 512] x 8 plan, the fftconv [1000, 1000] x 8 plan (25 x 25 taps), the
overlap-save plan on [2^20], the Navier-Stokes step's r2c (256^3 batch 3) and
c2r (256^3 batch 6) plans, the solver step itself, the reverse-mode
gradient of the kinetic energy after one step with respect to the initial
velocity (forward + backward), and the DSP toolboxes' device paths on the
(8, 2^22) signal of chip_smoke's signal path: one section of the parallel-
prefix IIR route, sosfilt of butter(8, 0.1) (four sections), FIR lfilter of
129 taps, and dlsim of an 8-state system over 1000 steps (the host-driven
loop), and prints for each: device time per call,
the device's busy share (device time over the host's time for the same
calls, synchronised at the end, profiler off), and the device time per call
of every kernel by name (operator rows repeat their kernels' time and are
left out).  The port's own kernels show as ``fused_lines_kernel``,
``pow2_lines_kernel``, ``warp_lines_kernel`` and ``mixed_lines_kernel`` (K1,
by the design its rule gives a length) and ``fused_cols_kernel`` (K2).  It needs a GPU and builds the kernels on first use.
"""

import time

import torch
from torch.profiler import ProfilerActivity, profile

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.examples import navier_stokes3d as ns
from webgpufft_tpu_torch.runtime.profile import card_line
from chip_smoke import torch_fft_stepper3

CALLS = 3
NS_N, NS_NU, NS_DT = 256, 2e-2, 1e-2
TOP = 14


def device_time_us(event):
    return getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0.0)


def profile_calls(label, fn, *args):
    """Device time by kernel from a profiled window of CALLS calls; the busy
    share is that device time over the host's time for the same calls with
    the profiler off (the profiler slows the host, not the kernels)."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn(*args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn(*args)
        torch.cuda.synchronize()
    # kernel and memcpy rows only: an operator's row (aten::, an autograd
    # node, a Function) repeats the device time of the kernels it launched
    rows = [(e.key, device_time_us(e) / 1e3 / CALLS, e.count / CALLS)
            for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    if total <= 0:
        raise RuntimeError(f"{label}: the profiler recorded no device time")
    print(f"profile {label}: device {total:.4f} ms/call, host {wall_ms:.4f} ms/call "
          f"(profiler off), busy share {total / wall_ms:.3f}")
    for key, ms, count in rows[:TOP]:
        print(f"    {ms:9.4f} ms  {ms / total:6.3f}  x{count:g}  {key[:90]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    gen = torch.Generator(device="cuda").manual_seed(1234)

    plan = T.create_plan({"type": "c2c", "shape": [1024], "batch": 4096,
                          "direction": "forward", "normalize": "unitary"}, device="cuda")
    profile_calls("headline c2c [1024] b4096",
                  plan, torch.randn(4096, 1024, 2, device="cuda", generator=gen))
    plan = T.create_plan({"type": "c2c", "shape": [256] * 3, "batch": 1}, device="cuda")
    profile_calls("c2c 256^3 b1",
                  plan, torch.randn(1, 256, 256, 256, 2, device="cuda", generator=gen))
    plan = T.create_plan({"type": "dct2", "shape": [512, 512], "batch": 8,
                          "normalize": "unitary"}, device="cuda")
    profile_calls("dct2 [512, 512] b8", plan,
                  torch.randn(8, 512, 512, device="cuda", generator=gen))
    plan = T.create_plan({"type": "fftconv", "shape": [1000, 1000], "batch": 8,
                          "fftConv": {"kernelShape": [25, 25], "boundary": "linear-same"}},
                         device="cuda")
    k = torch.randn(25, 25, 2, device="cuda", generator=gen)
    profile_calls("fftconv [1000, 1000] b8 k25x25", lambda v: plan(v, kernel=k),
                  torch.randn(8, 1000, 1000, 2, device="cuda", generator=gen))
    os_plan = T.create_plan({"type": "fftconv", "shape": [1 << 20], "batch": 1,
                             "fftConv": {"kernelShape": [129], "boundary": "circular"}},
                            device="cuda")
    k = torch.randn(129, 2, device="cuda", generator=gen)
    profile_calls("fftconv overlap-save [2^20] k129", lambda v: os_plan(v, kernel=k),
                  torch.randn(1, 1 << 20, 2, device="cuda", generator=gen))
    r2c = T.create_plan({"type": "r2c", "shape": [NS_N] * 3, "batch": 3}, device="cuda")
    x = torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen)
    profile_calls("r2c 256^3 b3", r2c, x)
    c2r = T.create_plan({"type": "c2r", "shape": [NS_N] * 3, "batch": 6,
                         "direction": "inverse", "normalize": "backward"}, device="cuda")
    y = torch.cat([r2c(x), r2c(x)])
    profile_calls("c2r 256^3 b6", c2r, y)
    del x, y
    step, to_s, _ = ns.make_stepper3(NS_N, NS_NU, NS_DT, device="cuda")
    u_hat = to_s(0.1 * torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen))
    profile_calls("NS-3D step 256^3", step, u_hat)
    fstep, fto_s, fto_p = torch_fft_stepper3(NS_N, NS_NU, NS_DT)
    profile_calls("NS-3D step 256^3 on torch.fft", fstep, u_hat)
    del u_hat

    # forward + backward: d(kinetic energy after one step)/d(u0), reverse mode
    _, _, to_p = ns.make_stepper3(NS_N, NS_NU, NS_DT, device="cuda")
    u0 = 0.1 * torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen)

    def energy(u, s=step, a=to_s, b=to_p):
        return 0.5 * b(s(a(u))).pow(2).sum(0).mean()

    profile_calls("NS-3D energy forward alone 256^3", energy, u0)
    profile_calls("NS-3D energy gradient (forward + backward) 256^3", torch.func.grad(energy), u0)
    profile_calls("NS-3D energy gradient 256^3 on torch.fft",
                  torch.func.grad(lambda u: energy(u, fstep, fto_s, fto_p)), u0)
    del u0

    # the DSP toolboxes on chip_smoke's signal
    import numpy as np
    from webgpufft_tpu_torch import filtering as F
    sig = torch.randn(8, 1 << 22, device="cuda", generator=gen)
    sos = F.butter(8, 0.1, output="sos")
    z0 = torch.zeros(8, 2, device="cuda")
    profile_calls("parallel-prefix IIR, one K = 2 section, (8, 2^22)",
                  lambda v: F._iir_assoc(sos[0, :3], sos[0, 3:], v, z0), sig)
    profile_calls("sosfilt butter(8, 0.1), (8, 2^22)", lambda v: F.sosfilt(sos, v), sig)
    fir = F.firwin(129, 0.2)
    profile_calls("lfilter firwin(129, 0.2), (8, 2^22)", lambda v: F.lfilter(fir, 1.0, v), sig)
    rng = np.random.default_rng(1234)
    a = rng.standard_normal((8, 8))
    a -= (np.linalg.eigvals(a).real.max() + 0.5) * np.eye(8)
    sysd = T.ltisys.cont2discrete((a, rng.standard_normal((8, 2)), rng.standard_normal((2, 8)),
                                   np.zeros((2, 2))), 2e-3)
    u = rng.standard_normal((1000, 2))
    profile_calls("dlsim 8 states, 2 inputs, 1000 steps", lambda v: T.ltisys.dlsim(sysd, v), u)


if __name__ == "__main__":
    main()
