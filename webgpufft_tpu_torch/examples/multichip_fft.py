"""Distributed single-transform FFT over a device mesh, on the port.

Port of ``examples/multichip_fft.py``: a plan-level c2c over the ``sp``
mesh dim, the digit-grid building block, and sequence-parallel STFT /
Welch on a signal whose time axis stays sharded.

    python -m webgpufft_tpu_torch.examples.multichip_fft                 # one card
    python -m webgpufft_tpu_torch.examples.multichip_fft --device cpu
    torchrun --nproc-per-node 4 -m webgpufft_tpu_torch.examples.multichip_fft --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .. import interleave, uninterleave
from ..parallel import (build_distributed_fft_1d, build_distributed_stft,
                        build_distributed_welch, create_distributed_plan,
                        make_mesh)
from ._world import close_world, init_world, rank0


def run(device="cuda", n: int = 2 ** 16, batch: int = 2, verbose: bool = True):
    """The example on every rank of the current world; returns the max
    relative errors of the plan and of the building block against numpy."""
    say = print if verbose and rank0() else (lambda *a, **k: None)
    ndev = dist.get_world_size()
    mesh = make_mesh({"sp": ndev}, device=device)
    plan = create_distributed_plan(type="c2c", shape=[n], batch=batch,
                                   direction="forward", mesh=mesh, seq_axis="sp")
    say(f"ranks={ndev} n={n} route={plan.route.mode} impl={plan.route.impl} "
        f"reasons={plan.route.reasons}")
    rng = np.random.default_rng(0)
    z = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    ref = np.fft.fft(z, axis=-1)
    x = torch.from_numpy(interleave(z))
    got = uninterleave(plan(x).full_tensor().cpu().numpy())
    err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    say(f"max rel err vs numpy: {err:.2e}")
    assert err < 1e-5

    fft = build_distributed_fft_1d(n, mesh, "sp", "forward")
    y = fft(x).full_tensor().cpu().numpy()
    got2 = uninterleave(y.reshape(batch, n, 2))
    err2 = float(np.max(np.abs(got2 - ref)) / np.max(np.abs(ref)))
    assert err2 < 1e-5
    say(f"building-block digit split: {fft.split}")

    # a signal analyzed where it lives: the time axis stays sharded; only
    # the window-overlap halo (one ppermute) and an nf-float psum move
    nsig = 64 * (16 * ndev - 1)
    nw = 64 * 16 * ndev + 192
    xs = rng.standard_normal(nw).astype(np.float32)
    _, _, stft_fn = build_distributed_stft(nsig, mesh, "sp", nperseg=256,
                                           noverlap=192)
    fw, welch_fn = build_distributed_welch(nw, mesh, "sp", nperseg=256,
                                           noverlap=192)
    Z = stft_fn(torch.from_numpy(xs[:nsig]))
    P = welch_fn(torch.from_numpy(xs)).full_tensor().cpu().numpy()
    say(f"seq-parallel stft: {tuple(Z.shape)} (frames sharded over sp), "
        f"welch peak at {fw[int(np.argmax(P))]:.3f}")
    return err, err2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    init_world(args.device)
    try:
        run(args.device)
    finally:
        close_world()


if __name__ == "__main__":
    main()
