"""3-D incompressible Navier-Stokes, pseudo-spectral, on the PyTorch port.

Port of ``examples/navier_stokes3d.py``: single device, and distributed
over a mesh (slab or pencil, ``mesh=``).
Velocity formulation on the periodic [0, 2pi)^3 torus,

    u_t = u x omega - grad(p + |u|^2 / 2) + nu * lap(u),   div(u) = 0,

advanced in spectral space with a Heun (RK2) step under the exact viscous
integrating factor exp(-nu k^2 dt).  The pressure term is the Leray
projection P(N)_i = N_i - k_i (k . N) / k^2 of the transformed nonlinear
term N = u x omega, with 2/3-rule dealiasing.  Each right-hand side runs one
batch-6 c2r plan (u, v, w, wx, wy, wz to physical space) and one batch-3 r2c
plan (N back), both packing the half-complex axis first (logical axis 0).

    import torch
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    u0 = ns.taylor_green_embedded(256, 0.0, 2e-2, device="cuda")
    u = ns.run3(u0, 256, 2e-2, 1e-2, 10, device="cuda")

    python -m webgpufft_tpu_torch.examples.navier_stokes3d              # n = 32 on the card
    python -m webgpufft_tpu_torch.examples.navier_stokes3d --device cpu --n 16

``main`` runs the JAX example's checks: the embedded Taylor-Green vortex and
the ABC flow against their analytic solutions, decaying turbulence (energy
falls, ``max_divergence`` stays below 1e-4), then the slab and the pencil
trajectories against one device (in a one-rank world alone, or under
``torchrun``).

``make_stepper3_around`` builds the same solver around any three
transforms; the tests and the GPU scripts hand it a library FFT as the
yardstick and an independent oracle for the step (``RFFT_DIMS`` is the dim
order that makes such a library pack logical axis 0, as the plans do).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .. import create_plan

# a library rfftn halves the LAST dim it is given: listing logical axis 0
# last packs it, as the plans do
RFFT_DIMS = (2, 3, 1)

def spectral_grids3(n: int, device):
    """(kx, ky, kz, inv_k2, dealias) as float32 tensors on ``device`` in the
    plan layout: spectral shape (n//2+1, n, n), the packed half-complex
    axis first.  kx, ky and kz are (n//2+1, 1, 1), (1, n, 1) and (1, 1, n)
    and broadcast; inv_k2 and dealias are full size."""
    kx = torch.arange(n // 2 + 1, dtype=torch.float32, device=device)[:, None, None]
    full = torch.arange(n, dtype=torch.float32, device=device)
    full = torch.where(full < (n + 1) // 2, full, full - n)   # np.fft.fftfreq(n, 1/n)
    ky, kz = full[None, :, None], full[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.clamp(k2, min=1e-30), torch.zeros_like(k2))
    lim = (2.0 / 3.0) * (n // 2)
    dealias = ((kx.abs() <= lim) & (ky.abs() <= lim) & (kz.abs() <= lim)).float()
    return kx, ky, kz, inv_k2, dealias


def make_stepper3_around(n: int, nu: float, dt: float, device, fwd3, inv3, inv6,
                         cut=None):
    """(step, to_spectral, to_physical) around three transforms: ``fwd3``
    maps physical (3, n, n, n) to interleaved spectral (3, n//2+1, n, n, 2)
    unnormalized; ``inv3`` and ``inv6`` map back with 1/n^3.  ``cut``
    slices each wavenumber grid to the shard the transforms work on (the
    distributed stepper's)."""
    kx, ky, kz, inv_k2, dealias = spectral_grids3(n, device)
    if cut is not None:
        kx, ky, kz, inv_k2, dealias = (cut(t) for t in (kx, ky, kz, inv_k2, dealias))
    kx, ky, kz = kx[..., None], ky[..., None], kz[..., None]    # ride the (re, im) dim
    inv_k2, mask = inv_k2[..., None], dealias[..., None]
    visc = torch.exp(-nu * (kx * kx + ky * ky + kz * kz) * dt)

    def mul_ik(z, k):
        """i * k * z in interleaved form: (re, im) -> (-k im, k re)."""
        return torch.cat([-k * z[..., 1:], k * z[..., :1]], dim=-1)

    def project(f_hat):
        """Leray projection: remove the gradient part of (3, ..., 2)."""
        dot = (kx * f_hat[0] + ky * f_hat[1] + kz * f_hat[2]) * inv_k2
        return f_hat - torch.stack([kx * dot, ky * dot, kz * dot])

    def rhs(u_hat):
        """P(dealias(FFT(u x omega))) from the spectral velocity."""
        wx = mul_ik(u_hat[2], ky) - mul_ik(u_hat[1], kz)
        wy = mul_ik(u_hat[0], kz) - mul_ik(u_hat[2], kx)
        wz = mul_ik(u_hat[1], kx) - mul_ik(u_hat[0], ky)
        u, v, w, ox, oy, oz = inv6(torch.cat([u_hat, torch.stack([wx, wy, wz])]))
        cross = torch.stack([v * oz - w * oy, w * ox - u * oz, u * oy - v * ox])
        return project(fwd3(cross) * mask)

    def step(u_hat):
        """Heun with the exact viscous integrating factor."""
        k1 = rhs(u_hat)
        k2 = rhs(visc * (u_hat + dt * k1))
        return visc * u_hat + 0.5 * dt * (visc * k1 + k2)

    def to_spectral(u):
        """Physical (3, n, n, n) -> dealiased, projected spectral state."""
        return project(fwd3(u) * mask)

    step.rhs = rhs                     # the part of a step the transforms make
    return step, to_spectral, inv3


def make_stepper3(n: int, nu: float, dt: float, *, device=None, mesh=None,
                  seq_axis="sp", precision: str = "f32"):
    """Build (step, to_spectral, to_physical) for an n^3 velocity field on
    ``device``.  ``step(u_hat) -> u_hat`` advances the interleaved spectral
    velocity (3, n//2+1, n, n, 2) one RK2 step through the port's r2c/c2r
    plans.  With ``mesh`` (a ``DeviceMesh`` of ``parallel.make_mesh``, the
    device its own) the transforms are the distributed rank-3 plans over
    ``seq_axis``: one mesh dim shards grid axis 0 (slab), a pair shards
    axes 0 and 1 (pencil); ``step`` then advances this rank's shard of the
    spectral state, ``to_spectral`` takes the whole physical field and
    ``to_physical`` returns it whole (``_world.MeshFields``).  With
    ``precision="bf16-storage"`` the plans take and return
    bfloat16 while the solver state and the pointwise layer stay float32
    (relative error of the 1e-3 class: the accuracy trade is the caller's)."""
    fields = None
    if mesh is not None:
        from ..parallel import create_distributed_plan
        from ..parallel.sharded import mesh_device
        from ._world import MeshFields
        device = mesh_device(mesh)
        fields = MeshFields(mesh, seq_axis, n, 3)

    def plan(batch, kind, direction, normalize):
        opts = {"type": kind, "shape": [n, n, n], "batch": batch,
                "direction": direction, "normalize": normalize,
                "precision": precision}
        if mesh is not None:
            p = fields.plan(create_distributed_plan(opts, mesh=mesh,
                                                    seq_axis=seq_axis), kind)
        else:
            p = create_plan(opts, device=device)
        if precision == "bf16-storage":
            return lambda x: p(x.to(torch.bfloat16)).float()
        return p

    step, to_spectral, to_physical = make_stepper3_around(
        n, nu, dt, device, plan(3, "r2c", "forward", "none"),
        plan(3, "c2r", "inverse", "backward"), plan(6, "c2r", "inverse", "backward"),
        cut=fields.cut if fields is not None else None)
    if fields is None:
        return step, to_spectral, to_physical
    return (step, lambda u: to_spectral(fields.scatter(u)),
            lambda u_hat: fields.gather(to_physical(u_hat)))


def run3(u0, n: int, nu: float, dt: float, steps: int, *, device=None,
         mesh=None, seq_axis="sp"):
    """Advance physical velocity ``u0`` (3, n, n, n) ``steps`` steps on
    ``device`` (or over ``mesh``, see ``make_stepper3``); returns the final
    physical velocity as a tensor there."""
    if mesh is not None:
        from ..parallel.sharded import mesh_device
        device = mesh_device(mesh)
    step, to_spectral, to_physical = make_stepper3(n, nu, dt, device=device,
                                                   mesh=mesh, seq_axis=seq_axis)
    u_hat = to_spectral(torch.as_tensor(u0, dtype=torch.float32, device=device))
    for _ in range(steps):
        u_hat = step(u_hat)
    return to_physical(u_hat)


def _grid(n: int, device):
    x = torch.arange(n, dtype=torch.float64, device=device) * (2.0 * math.pi / n)
    return torch.meshgrid(x, x, x, indexing="ij")


def taylor_green_embedded(n: int, t: float, nu: float, *, device):
    """The 2-D Taylor-Green vortex as a 3-D velocity field (3, n, n, n),
    float32 on ``device``: an exact solution of the full 3-D equations (its
    nonlinear term is a pure gradient, absorbed by the pressure)."""
    X, Y, _ = _grid(n, device)
    decay = math.exp(-2.0 * nu * t)
    u = torch.cos(X) * torch.sin(Y) * decay
    v = -torch.sin(X) * torch.cos(Y) * decay
    return torch.stack([u, v, torch.zeros_like(u)]).float()


def abc_flow(n: int, t: float, nu: float, A=1.0, B=1.0, C=1.0, *, device):
    """ABC/Beltrami flow (3, n, n, n), float32 on ``device``: omega = u, so
    it decays as e^{-nu t} under the full nonlinear equations."""
    X, Y, Z = _grid(n, device)
    decay = math.exp(-nu * t)
    u = (A * torch.sin(Z) + C * torch.cos(Y)) * decay
    v = (B * torch.sin(X) + A * torch.cos(Z)) * decay
    w = (C * torch.sin(Y) + B * torch.cos(X)) * decay
    return torch.stack([u, v, w]).float()


def kinetic_energy(u) -> float:
    return float(0.5 * torch.as_tensor(u, dtype=torch.float64).pow(2).sum(0).mean())


def max_divergence(u, n: int) -> float:
    """max |k . u_hat| / max |u_hat| from the physical velocity (a numpy
    oracle, packed axis last as ``np.fft.rfftn`` packs it)."""
    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    uh = np.stack([np.fft.rfftn(c) for c in np.asarray(u)], axis=0)
    full = np.fft.fftfreq(n, d=1.0 / n)
    kx = full[:, None, None]
    ky = full[None, :, None]
    kz = np.arange(n // 2 + 1)[None, None, :]
    div = kx * uh[0] + ky * uh[1] + kz * uh[2]
    return float(np.max(np.abs(div)) / max(np.max(np.abs(uh)), 1e-30))


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main(argv=None):
    import torch.distributed as dist

    from ..parallel import make_mesh
    from ._world import rank0, world
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=32)
    args = ap.parse_args(argv)
    n, nu, dt, steps = args.n, 2e-2, 1e-2, 50
    t_end = dt * steps
    out = {}
    with world(args.device) as dev:
        say = print if rank0() else (lambda *a, **k: None)
        for name, make in [("embedded Taylor-Green", taylor_green_embedded),
                           ("ABC flow", abc_flow)]:
            u = run3(make(n, 0.0, nu, device=dev), n, nu, dt, steps, device=dev)
            err = _rel(u, make(n, t_end, nu, device=dev))
            say(f"{name} {n}^3, nu={nu}, t={t_end:g}: rel err {err:.2e}")
            assert err < 1e-4
            out[name] = err

        rng = np.random.default_rng(0)
        u0 = torch.from_numpy(rng.standard_normal((3, n, n, n)).astype(np.float32)).to(dev)
        u1 = run3(u0, n, nu, dt, steps, device=dev)
        e0 = kinetic_energy(run3(u0, n, nu, dt, 0, device=dev))
        e1 = kinetic_energy(u1)
        dv = max_divergence(u1, n)
        say(f"decaying turbulence: KE {e0:.4f} -> {e1:.4f}, "
            f"max spectral divergence {dv:.2e}")
        assert e1 < e0 and dv < 1e-4
        out.update(energy=(e0, e1), divergence=dv)

        ndev = dist.get_world_size()
        tg = taylor_green_embedded(n, 0.0, nu, device=dev)
        single = run3(tg, n, nu, dt, 10, device=dev)
        p1 = 2 if ndev % 2 == 0 and ndev >= 4 else 1
        for label, axes, seq_axis in [
                (f"slab ({ndev} ranks)", {"sp": ndev}, "sp"),
                (f"pencil ({p1} x {ndev // p1})", {"sp1": p1, "sp2": ndev // p1},
                 ("sp1", "sp2"))]:
            mesh = make_mesh(axes, device=args.device)
            d = _rel(run3(tg, n, nu, dt, 10, mesh=mesh, seq_axis=seq_axis), single)
            say(f"{label} vs one device: {d:.2e}")
            assert d < 1e-4
            out[label.split()[0]] = d
        say("OK")
    return out


if __name__ == "__main__":
    main()
