"""3-D periodic Poisson solver on the distributed real-FFT path, on the
port.

Port of ``examples/poisson3d.py``: solves ``laplacian(u) = f`` on an n^3
periodic grid by the distributed rank-3 r2c, a spectral division by the
7-point Laplacian symbol and the distributed c2r, against a manufactured
solution; then the same solve on the pencil decomposition.

    python -m webgpufft_tpu_torch.examples.poisson3d                 # one card
    python -m webgpufft_tpu_torch.examples.poisson3d --device cpu --n 32
    torchrun --nproc-per-node 4 -m webgpufft_tpu_torch.examples.poisson3d --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..parallel import create_distributed_plan, make_mesh
from ..parallel.sharded import mesh_device
from ._world import rank0, world


def lap(v):
    """The periodic 7-point Laplacian of a numpy or torch 3-D field."""
    roll = torch.roll if isinstance(v, torch.Tensor) else np.roll
    out = -6.0 * v
    for ax in range(3):
        out = out + roll(v, 1, ax) + roll(v, -1, ax)
    return out


def inverse_symbol(n: int) -> np.ndarray:
    """1 / (the 7-point stencil's symbol) on the packed (n//2+1, n, n)
    spectrum (packed axis first), 0 at k = 0 (the gauge)."""
    k = np.arange(n)
    c = 2.0 * np.cos(2.0 * np.pi * k / n) - 2.0
    kz = np.arange(n // 2 + 1)
    cz = 2.0 * np.cos(2.0 * np.pi * kz / n) - 2.0
    denom = cz[:, None, None] + c[None, :, None] + c[None, None, :]
    denom[0, 0, 0] = 1.0
    inv = (1.0 / denom).astype(np.float32)
    inv[0, 0, 0] = 0.0
    return inv


def manufactured(n: int, seed: int = 0):
    """(u*, f = lap(u*)) with a zero-mean random u*, float32 numpy."""
    u_star = np.random.default_rng(seed).standard_normal((n, n, n)).astype(np.float32)
    u_star -= u_star.mean()
    return u_star, lap(u_star).astype(np.float32)


def solve(f, mesh, seq_axis, inv_sym):
    """u with lap(u) = f through the distributed plans over ``mesh``."""
    n = f.shape[-1]
    shape = [n, n, n]
    fwd = create_distributed_plan(type="r2c", shape=shape, batch=1,
                                  direction="forward", normalize="none",
                                  mesh=mesh, seq_axis=seq_axis)
    inv = create_distributed_plan(type="c2r", shape=shape, batch=1,
                                  direction="inverse", normalize="backward",
                                  mesh=mesh, seq_axis=seq_axis)
    F = fwd(f[None])                      # (1, n//2+1, n, n, 2), sharded
    # the symbol cut to this rank's shard of the spectrum, applied shard by
    # shard; the solution is read whole at the end
    sym = DTensor.from_local(inv_sym[None, ..., None], mesh,
                             [Replicate()] * mesh.ndim, run_check=False)
    sym = sym.redistribute(mesh, F.placements).to_local()
    U = DTensor.from_local(F.to_local() * sym, mesh, F.placements,
                           run_check=False, shape=F.shape, stride=F.stride())
    return inv(U).full_tensor()[0], (fwd, inv)


def run(device="cuda", n: int = 64, verbose: bool = True):
    """The slab solve (and the pencil solve when the world splits in two
    dims); returns {"res", "err", "pencil"} as relative errors."""
    say = print if verbose and rank0() else (lambda *a, **k: None)
    ndev = dist.get_world_size()
    mesh = make_mesh({"sp": ndev}, device=device)
    dev = mesh_device(mesh)
    u_star, f = manufactured(n)
    inv_sym = torch.from_numpy(inverse_symbol(n)).to(dev)
    ft = torch.from_numpy(f).to(dev)
    u, (fwd, inv) = solve(ft, mesh, "sp", inv_sym)
    say(f"ranks={ndev} grid={(n, n, n)} fwd={fwd.route.mode} inv={inv.route.mode}")
    un = u.cpu().numpy()
    res = float(np.max(np.abs(lap(un) - f)) / np.max(np.abs(f)))
    err = float(np.max(np.abs(un - u_star)) / np.max(np.abs(u_star)))
    say(f"residual |lap(u) - f| rel: {res:.2e}")
    say(f"solution error vs manufactured u*: {err:.2e}")
    assert res < 1e-4 and err < 1e-4
    out = {"res": res, "err": err, "pencil": None}
    # the pencil: grid axes 0 and 1 on their own mesh dims; the packed
    # layout is the same, so the spectral symbol is unchanged
    p1 = 2 if ndev % 2 == 0 and ndev >= 4 else 1
    p2 = ndev // p1
    if n % p1 == 0 and n % p2 == 0:
        pmesh = make_mesh({"sp1": p1, "sp2": p2}, device=device)
        up, (pf, _) = solve(ft, pmesh, ("sp1", "sp2"), inv_sym)
        perr = float((up - u).abs().max() / u.abs().max())
        say(f"pencil ({p1}x{p2}, {pf.route.mode}): |pencil - slab| rel {perr:.2e}")
        assert perr < 1e-5
        out["pencil"] = perr
    say("OK")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=64)
    args = ap.parse_args(argv)
    with world(args.device):
        run(args.device, args.n)


if __name__ == "__main__":
    main()
