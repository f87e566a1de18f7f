"""Device self-test: a quick correctness sweep of the port on one device.

Usage: python -m webgpufft_tpu_torch.selftest [--deep] [--device cpu]

Builds one plan per family on the device (default: the GPU, and it fails
loudly without one), compares against the numpy oracle
(``utils/mathref.py``), and prints a PASS/FAIL line each: the fast way to
validate a new card, CUDA stack or torch version.  On a GPU the first kernel
launch builds the CUDA kernels.

``--deep`` (``run(deep=True)``) adds the 256^3 r2c/c2r geometry of the
Navier-Stokes solver and a 2^20-class overlap-save convolution: gigabytes of
arrays, for a GPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def run(tol: float = 1e-5, deep: bool = False, device="cuda") -> bool:
    import webgpufft_tpu_torch as W
    from webgpufft_tpu_torch.core.cplx import interleave
    from webgpufft_tpu_torch.utils import mathref as R

    dev = W._resolve_device(device)
    rng = np.random.default_rng(0)
    ok_all = True
    cache = W.PlanCache()

    def plan(opts):
        return W.create_plan(opts, device=dev, cache=cache)

    def up(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def check(label, got, ref):
        nonlocal ok_all
        got = got.double().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        ref = np.asarray(ref, dtype=np.float64)
        err = np.max(np.abs(got - ref)) / max(1e-12, np.max(np.abs(ref)))
        ok = bool(err <= tol)
        ok_all &= ok
        print(f"{'PASS' if ok else 'FAIL'} {label:34s} max_rel_err={err:.2e}")

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev} ({name}) torch={torch.__version__}")

    def c2c_case(label, n, batch, **opts):
        z = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
        p = plan({"type": "c2c", "shape": [n], "batch": batch, **opts})
        check(label, p(up(interleave(z))),
              interleave(R.fft_nd(z, [n], "forward", opts.get("normalize", "none"))))
        return p

    c2c_case("c2c mixed (96)", 96, 2, normalize="unitary")
    c2c_case("c2c rader (17)", 17, 1)
    c2c_case("c2c bluestein (34)", 34, 1)
    # the kernels' own shapes: K1 on a batch of lines, K1 + K2 on a volume
    p = c2c_case("c2c lines (1024 b64)", 1024, 64, normalize="unitary")
    assert p.route.mode == "pallas-fused", p.route
    z = rng.standard_normal((2, 16, 8, 64)) + 1j * rng.standard_normal((2, 16, 8, 64))
    p = plan({"type": "c2c", "shape": [16, 8, 64], "batch": 2})
    assert p.route.mode == "pallas-fused", p.route
    check("c2c volume (16x8x64 b2)", p(up(interleave(z))),
          interleave(R.fft_nd(z, [16, 8, 64], "forward")))

    x = rng.standard_normal((2, 16, 6)).astype(np.float32)
    p = plan({"type": "r2c", "shape": [16, 6], "direction": "forward", "batch": 2})
    check("r2c 2d", p(up(x)), interleave(R.r2c_packed(x, [16, 6])))
    packed = R.r2c_packed(x.astype(np.float64), [16, 6])
    p = plan({"type": "c2r", "shape": [16, 6], "direction": "inverse",
              "normalize": "backward", "batch": 2})
    check("c2r 2d", p(up(interleave(packed))), x)

    def real_volume(n, label):
        xv = rng.standard_normal((3, n, n, n)).astype(np.float32)
        p = plan({"type": "r2c", "shape": [n, n, n], "batch": 3})
        yv = p(up(xv))
        check(f"r2c 3d ({label})", yv, interleave(R.r2c_packed(xv, [n, n, n])))
        p = plan({"type": "c2r", "shape": [n, n, n], "direction": "inverse",
                  "normalize": "backward", "batch": 3})
        check(f"c2r 3d ({label})", p(yv), xv)

    real_volume(32, "32^3 b3")
    if deep:
        real_volume(256, "deep 256^3 b3")
        nos, bos, kos = 1032000, 8, 129
        zos = rng.standard_normal((bos, nos)) + 1j * rng.standard_normal((bos, nos))
        kker = rng.standard_normal((kos,)) + 1j * rng.standard_normal((kos,))
        p = plan({"type": "fftconv", "shape": [nos], "batch": bos,
                  "fftConv": {"boundary": "circular", "kernelShape": [kos],
                              "tuning": {"overlapSave": "on", "overlapBlock": 8192}}})
        assert p.route.mode == "overlap-save", p.route
        check("fftconv overlap-save deep (2^20-class)",
              p(up(interleave(zos)), kernel=up(interleave(kker))),
              interleave(R.fftconv(zos, kker, [nos], batch=bos, boundary="circular",
                                   kernel_shape=[kos])))
        del zos, kker

    xr = rng.standard_normal((2, 8, 8)).astype(np.float32)
    for kind in ("dct2", "dst3"):
        p = plan({"type": kind, "shape": [8, 8], "direction": "forward", "batch": 2})
        check(f"{kind} 8x8", p(up(xr)), R.dct_nd(xr, [8, 8], kind, "forward"))

    zc = rng.standard_normal((2, 16)) + 1j * rng.standard_normal((2, 16))
    k = rng.standard_normal((5,)) + 1j * rng.standard_normal((5,))
    p = plan({"type": "fftconv", "shape": [16], "batch": 2,
              "fftConv": {"boundary": "linear-same", "kernelShape": [5]}})
    check("fftconv linear-same", p(up(interleave(zc)), kernel=up(interleave(k))),
          interleave(R.fftconv(zc, k, [16], batch=2, boundary="linear-same",
                               kernel_shape=[5])))

    p = plan({"type": "conv2d", "shape": [8, 8], "batch": 1,
              "conv": {"kernelSize": 3, "padding": "same"}})
    xi = rng.standard_normal((1, *p.in_shape)).astype(np.float32)
    w = rng.standard_normal((3, 3)).astype(np.float32)
    check("conv2d 3x3 same", p(up(xi), kernel=up(w)), R.conv2d_direct(xi, w, pad=p.pad))

    # the four-step route (forced small so the selftest stays fast)
    z = rng.standard_normal((1, 4096)) + 1j * rng.standard_normal((1, 4096))
    p = plan({"type": "c2c", "shape": [4096], "batch": 1, "tuning": {"fourStepMinN": 4096}})
    assert p.route.mode == "four-step-hbm", p.route
    check("c2c four-step (4096)", p(up(interleave(z))),
          interleave(R.fft_nd(z, [4096], "forward")))

    # the overlap-save streaming convolution route (forced small blocks)
    zc = rng.standard_normal((1, 512)) + 1j * rng.standard_normal((1, 512))
    k = rng.standard_normal((9,)) + 1j * rng.standard_normal((9,))
    p = plan({"type": "fftconv", "shape": [512], "batch": 1,
              "fftConv": {"boundary": "circular", "kernelShape": [9],
                          "tuning": {"overlapSave": "on", "overlapBlock": 64}}})
    assert p.route.mode == "overlap-save", p.route
    check("fftconv overlap-save (512)", p(up(interleave(zc)), kernel=up(interleave(k))),
          interleave(R.fftconv(zc, k, [512], batch=1, boundary="circular",
                               kernel_shape=[9])))

    # reverse mode through a kernel pass: d/dx sum |F x|^2 = 2 n x
    xg = up(rng.standard_normal((16, 256, 2))).requires_grad_()
    p = plan({"type": "c2c", "shape": [256], "batch": 16})
    g, = torch.autograd.grad(p(xg).pow(2).sum(), xg)
    check("grad c2c parseval (256 b16)", g, 2 * 256 * xg.detach().double().cpu().numpy())

    # export/load round trip on this device
    p = plan({"type": "c2c", "shape": [64], "batch": 8, "normalize": "unitary"})
    ep = W.load_exported_plan(W.export_plan(p), device=dev)
    z = rng.standard_normal((8, 64)) + 1j * rng.standard_normal((8, 64))
    check("export/load (64)", ep(up(interleave(z))),
          interleave(R.fft_nd(z, [64], "forward", "unitary")))

    print("SELFTEST", "PASS" if ok_all else "FAIL")
    return ok_all


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev_arg = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    sys.exit(0 if run(deep="--deep" in argv, device=dev_arg) else 1)
