"""2-D incompressible Navier-Stokes, pseudo-spectral, on the port: single
device and the distributed r2c/c2r plans.

Port of ``examples/navier_stokes2d.py``.  Vorticity-streamfunction form on
the periodic [0, 2pi)^2 torus,

    w_t + u . grad(w) = nu * laplacian(w),   u = (psi_y, -psi_x),
    laplacian(psi) = -w,

advanced with a Heun (RK2) step under the exact viscous integrating factor
exp(-nu k^2 dt) with 2/3-rule dealiasing.  Each right-hand side runs one
batch-4 c2r (u, v, w_x, w_y) and one r2c; every transform packs the
half-complex axis first (logical axis 0), so one set of wavenumber grids
drives the single-device and the distributed paths.  The Taylor-Green
vortex is an exact solution of the full nonlinear equations.

    python -m webgpufft_tpu_torch.examples.navier_stokes2d                 # one card
    python -m webgpufft_tpu_torch.examples.navier_stokes2d --device cpu --n 64
    torchrun --nproc-per-node 4 -m webgpufft_tpu_torch.examples.navier_stokes2d --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import create_plan


def spectral_grids(n: int, packed_axis: int):
    """(KX, KY, inv_k2, dealias) for an n x n grid whose r2c layout packs
    ``packed_axis`` (0: the plans' convention, 1: numpy's rfft2)."""
    full = np.fft.fftfreq(n, d=1.0 / n).astype(np.float32)
    half = np.arange(n // 2 + 1, dtype=np.float32)
    if packed_axis == 1:
        kx, ky = full[:, None], half[None, :]
    else:
        kx, ky = half[:, None], full[None, :]
    k2 = kx * kx + ky * ky
    inv_k2 = np.where(k2 > 0, 1.0 / np.maximum(k2, 1e-30), 0.0)
    kmax = n // 2
    dealias = ((np.abs(kx) <= (2.0 / 3.0) * kmax)
               & (np.abs(ky) <= (2.0 / 3.0) * kmax))
    return (kx.astype(np.float32), ky.astype(np.float32),
            inv_k2.astype(np.float32), dealias.astype(np.float32))


def make_stepper(n: int, nu: float, dt: float, *, device=None, mesh=None,
                 seq_axis="sp"):
    """Build (step, to_spectral, to_physical) for an n x n grid.
    ``step(w_hat) -> w_hat`` advances the interleaved spectral vorticity
    (n//2+1, n, 2) one RK2 step.  With ``mesh`` (``parallel.make_mesh``)
    the transforms are the distributed plans over ``seq_axis`` (a pair for
    the pencil); ``step`` then advances this rank's shard of the spectral
    state, ``to_spectral`` takes the whole physical field and
    ``to_physical`` returns it whole (``_world.MeshFields``)."""
    fields = None
    if mesh is not None:
        from ..parallel import create_distributed_plan
        from ..parallel.sharded import mesh_device
        from ._world import MeshFields
        device = mesh_device(mesh)
        fields = MeshFields(mesh, seq_axis, n, 2)

    def plan(kind, batch, direction, normalize):
        opts = {"type": kind, "shape": [n, n], "batch": batch,
                "direction": direction, "normalize": normalize}
        if mesh is None:
            return create_plan(opts, device=device)
        return fields.plan(create_distributed_plan(opts, mesh=mesh,
                                                   seq_axis=seq_axis), kind)

    fwd1 = plan("r2c", 1, "forward", "none")
    inv1 = plan("c2r", 1, "inverse", "backward")
    inv4 = plan("c2r", 4, "inverse", "backward")

    def t(a):
        a = torch.as_tensor(a, device=device)[..., None]
        return fields.cut(a) if fields is not None else a

    kx, ky, inv_k2, dealias = spectral_grids(n, 0)
    kx_t, ky_t, invk2, mask = t(kx), t(ky), t(inv_k2), t(dealias)
    visc = t(np.exp(-nu * (kx * kx + ky * ky) * dt).astype(np.float32))

    def mul_ik(z, k):
        """i * k * z in interleaved form: (re, im) -> (-k im, k re)."""
        return torch.cat([-k * z[..., 1:], k * z[..., :1]], dim=-1)

    def rhs(w_hat):
        """-dealias(FFT(u . grad w)) from the spectral vorticity."""
        psi = w_hat * invk2                      # laplacian(psi) = -w
        fields = torch.stack([mul_ik(psi, ky_t), -mul_ik(psi, kx_t),
                              mul_ik(w_hat, kx_t), mul_ik(w_hat, ky_t)])
        phys = inv4(fields)                      # one batch-4 c2r
        adv = phys[0] * phys[2] + phys[1] * phys[3]
        return -mask * fwd1(adv[None])[0]

    def step(w_hat):
        """Heun with the exact viscous integrating factor."""
        k1 = rhs(w_hat)
        k2 = rhs(visc * (w_hat + dt * k1))
        return visc * w_hat + 0.5 * dt * (visc * k1 + k2)

    step.rhs = rhs                     # the part of a step the transforms make

    def to_spectral(w):
        w = torch.as_tensor(w, dtype=torch.float32, device=device)[None]
        return fwd1(fields.scatter(w) if fields is not None else w)[0]

    def to_physical(w_hat):
        w = inv1(w_hat[None])
        return (fields.gather(w) if fields is not None else w)[0]

    return step, to_spectral, to_physical


def run(w0, n: int, nu: float, dt: float, steps: int, *, device=None,
        mesh=None, seq_axis="sp"):
    """Advance physical vorticity ``w0`` (n x n) ``steps`` steps; returns
    the final physical vorticity as numpy."""
    step, to_spectral, to_physical = make_stepper(n, nu, dt, device=device,
                                                  mesh=mesh, seq_axis=seq_axis)
    w_hat = to_spectral(w0)
    for _ in range(steps):
        w_hat = step(w_hat)
    return to_physical(w_hat).detach().cpu().numpy()


def taylor_green(n: int, t: float, nu: float):
    """Exact vorticity of the Taylor-Green vortex at time t (numpy)."""
    x = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    return (-2.0 * np.cos(X) * np.cos(Y) * np.exp(-2.0 * nu * t)).astype(np.float32)


def energy_enstrophy(w, n: int):
    """Kinetic energy and enstrophy from physical vorticity (host, numpy)."""
    W = np.fft.rfft2(w) / (n * n)
    kx = np.fft.fftfreq(n, d=1.0 / n)[:, None]
    ky = np.arange(n // 2 + 1)[None, :]
    k2 = kx * kx + ky * ky
    wgt = np.full(W.shape, 2.0)
    wgt[:, 0] = 1.0
    if n % 2 == 0:
        wgt[:, -1] = 1.0
    e_spec = np.abs(W) ** 2 * wgt
    with np.errstate(divide="ignore", invalid="ignore"):
        energy = 0.5 * np.sum(np.where(k2 > 0, e_spec / k2, 0.0))
    return float(energy), float(0.5 * np.sum(e_spec))


def main(argv=None):
    import torch.distributed as dist

    from ..parallel import make_mesh
    from ._world import rank0, world
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=128)
    args = ap.parse_args(argv)
    n, nu, dt, steps = args.n, 1e-2, 1e-2, 100
    with world(args.device) as dev:
        say = print if rank0() else (lambda *a, **k: None)
        w_num = run(taylor_green(n, 0.0, nu), n, nu, dt, steps, device=dev)
        w_ref = taylor_green(n, dt * steps, nu)
        err = np.max(np.abs(w_num - w_ref)) / np.max(np.abs(w_ref))
        say(f"Taylor-Green {n}x{n}, nu={nu}, t={dt * steps}: rel err {err:.2e}")
        assert err < 1e-4
        ndev = dist.get_world_size()
        mesh = make_mesh({"sp": ndev}, device=args.device)
        w_dist = run(taylor_green(n, 0.0, nu), n, nu, dt, steps, mesh=mesh)
        derr = np.max(np.abs(w_dist - w_num)) / np.max(np.abs(w_num))
        say(f"distributed ({ndev} ranks, sp): |dist - single| rel {derr:.2e}")
        assert derr < 1e-4
        p1 = 2 if ndev % 2 == 0 and ndev >= 4 else 1
        pmesh = make_mesh({"sp1": p1, "sp2": ndev // p1}, device=args.device)
        w_pen = run(taylor_green(n, 0.0, nu), n, nu, dt, steps, mesh=pmesh,
                    seq_axis=("sp1", "sp2"))
        perr = np.max(np.abs(w_pen - w_num)) / np.max(np.abs(w_num))
        say(f"pencil ({p1}x{ndev // p1}): |pencil - single| rel {perr:.2e}")
        assert perr < 1e-4
        rng = np.random.default_rng(7)
        w0 = rng.standard_normal((n, n)).astype(np.float32)
        w0 -= w0.mean()
        e0, z0 = energy_enstrophy(w0, n)
        w1 = run(w0, n, 5e-3, 5e-3, 200, device=dev)
        e1, z1 = energy_enstrophy(w1, n)
        say(f"turbulence: energy {e0:.4f} -> {e1:.4f}, enstrophy {z0:.2f} -> {z1:.2f}")
        assert z1 < z0 and e1 < e0 * 1.001
        say("OK")


if __name__ == "__main__":
    main()
