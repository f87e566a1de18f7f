"""Plan export for serving: build and export a plan in one process, load
and run the artifact in a serving process that never builds a plan from
options.

Port of ``examples/aot_serving.py``::

    python -m webgpufft_tpu_torch.examples.aot_serving build artifact.bin [--device cpu]
    python -m webgpufft_tpu_torch.examples.aot_serving serve artifact.bin [--device cpu]

``run(device)`` does both: it builds here and serves in a second Python
process (``serve ... --out``), which writes its output for this one to read.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import create_plan, export_plan, load_exported_plan

N = 1024


def build(path: str, device="cuda", batch: int = 64, verbose: bool = True):
    """Export the unitary c2c plan [1024] x ``batch`` to ``path``."""
    plan = create_plan({"type": "c2c", "shape": [N], "batch": batch,
                        "direction": "forward", "normalize": "unitary"}, device=device)
    blob = export_plan(plan, path=path)
    if verbose:
        print(f"exported {len(blob)} bytes -> {path} (route {plan.route.mode})")
    return plan


def request(batch: int) -> np.ndarray:
    """The serving request: a seeded (batch, 1024, 2) float32 batch."""
    return np.random.default_rng(0).standard_normal((batch, N, 2)).astype(np.float32)


def serve(path: str, device="cuda", out=None, verbose: bool = True):
    """Load the artifact on ``device`` and run one request through it;
    returns (output, max rel err against numpy).  ``out``: an ``.npz`` that
    gets the output and this process's K1/K2 launch counts."""
    from ..core import fused, fused_cols
    ep = load_exported_plan(path, device=device)
    batch = ep.spec_dict["batch"]
    if verbose:
        print(f"loaded {ep.spec_dict['plan_type']} shape={ep.spec_dict['shape']} "
              f"batch={batch} route={ep.route_mode} device={ep.plan.device}")
    x = request(batch)
    y = ep(torch.from_numpy(x).to(ep.plan.device)).cpu().numpy()
    z = x[..., 0] + 1j * x[..., 1]
    ref = np.fft.fft(z, axis=1) / np.sqrt(N)
    err = float(np.max(np.abs(y[..., 0] + 1j * y[..., 1] - ref)) / np.max(np.abs(ref)))
    if verbose:
        print(f"served batch of {batch}, rel err vs numpy: {err:.2e}")
    if out is not None:
        np.savez(out, y=y, launches=[fused.fused_lines.launches,
                                     fused_cols.fused_cols.launches])
    return y, err


def run(device="cuda", batch: int = 64, verbose: bool = True) -> dict:
    """Build here, serve in a second process; returns the served output
    (numpy), its error against numpy, the exporting plan's route and the
    serving process's (K1, K2) launches."""
    with tempfile.TemporaryDirectory(prefix="wgfft_aot_") as tmp:
        path, out = os.path.join(tmp, "plan.bin"), os.path.join(tmp, "served.npz")
        plan = build(path, device, batch, verbose)
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        done = subprocess.run(
            [sys.executable, "-m", "webgpufft_tpu_torch.examples.aot_serving", "serve",
             path, "--device", str(device), "--out", out],
            env=env, capture_output=True, text=True, timeout=600)
        if verbose:
            print(done.stdout, end="")
        if done.returncode != 0:
            raise RuntimeError(f"the serving process failed ({done.returncode}):\n"
                               f"{done.stderr}")
        with np.load(out) as served:
            y, launches = served["y"], tuple(int(v) for v in served["launches"])
    ref = request(batch)
    z = np.fft.fft(ref[..., 0] + 1j * ref[..., 1], axis=1) / np.sqrt(N)
    err = float(np.max(np.abs(y[..., 0] + 1j * y[..., 1] - z)) / np.max(np.abs(z)))
    return {"y": y, "err": err, "route": plan.route.mode, "served_launches": launches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=("build", "serve"))
    ap.add_argument("path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="serve: save the output and the launch counts here (.npz)")
    args = ap.parse_args(argv)
    if args.command == "build":
        build(args.path, args.device)
    else:
        serve(args.path, args.device, args.out)


if __name__ == "__main__":
    main()
