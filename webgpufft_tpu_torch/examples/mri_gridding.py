"""Non-Cartesian MRI reconstruction on the port's NUFFT layer.

Port of ``examples/mri_gridding.py``.  k-space is sampled along radial
spokes, so the samples sit between grid points:

- forward model (image -> k-space): the type-2 NUFFT
  s_j = sum_p img_p e^{-i p . k_j} (p the CMCL mode index, k_j in radians);
- gridding: the ramp-compensated adjoint (type-1 NUFFT of the
  density-compensated data; Ram-Lak |k|, the Jacobian of polar sampling);
- iterative reconstruction: conjugate gradients on A^H A x = A^H y, with A
  the type-2 operator and A^H exactly the type-1 one of opposite sign.

The forward samples are pinned against the direct NDFT on a random subset;
CG must converge to the phantom.  With ``mesh`` a distributed leg re-runs
forward and adjoint with the k-space points sharded over the mesh's ``sp``
dim (``parallel.nufft``: type 1 merges per-rank fine grids with one psum,
type 2 is collective-free) and holds them against one device.

    python -m webgpufft_tpu_torch.examples.mri_gridding            # on the card
    python -m webgpufft_tpu_torch.examples.mri_gridding --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import nufft
from ..fftapi import ascomplex

EPS = 1e-6


def shepp_logan_lite(n: int) -> np.ndarray:
    """A few-ellipse phantom (real, [0, 1])."""
    y, x = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                       indexing="ij")
    img = np.zeros((n, n))
    # (cx, cy, a, b, angle_deg, value)
    for cx, cy, a, b, ang, v in [
            (0.0, 0.0, 0.72, 0.95, 0, 1.0),
            (0.0, 0.0, 0.65, 0.87, 0, -0.4),
            (0.22, 0.0, 0.12, 0.31, -18, -0.2),
            (-0.22, 0.0, 0.16, 0.41, 18, -0.2),
            (0.0, 0.35, 0.21, 0.25, 0, 0.3),
            (0.0, -0.48, 0.046, 0.046, 0, 0.4)]:
        t = np.deg2rad(ang)
        xr = (x - cx) * np.cos(t) + (y - cy) * np.sin(t)
        yr = -(x - cx) * np.sin(t) + (y - cy) * np.cos(t)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += v
    return img


def radial_trajectory(n_spokes: int, n_read: int):
    """(kx, ky) in radians for n_spokes equiangular spokes of n_read
    signed-radius samples covering |k| <= pi (the mode count only sets
    how finely the image resolves those frequencies)."""
    r = (np.arange(n_read) - n_read // 2) / (n_read // 2)   # [-1, 1)
    th = np.pi * np.arange(n_spokes) / n_spokes             # [0, pi)
    kx = np.pi * np.outer(np.cos(th), r).ravel()
    ky = np.pi * np.outer(np.sin(th), r).ravel()
    return kx, ky, np.tile(np.abs(r), n_spokes)


def ramp_weights(absr, n_spokes: int, n_read: int) -> np.ndarray:
    """Ram-Lak density compensation of the radial samples:
    img_p = (1/(2pi)^2) int s(k) e^{+ip.k} d2k with polar d2k = |rho| drho
    dtheta, drho = 2pi/n_read, dtheta = pi/n_spokes; the DC sample repeats
    once per spoke and shares its cell (a disc of radius drho/2)."""
    drho = 2 * np.pi / n_read
    dth = np.pi / n_spokes
    w = np.pi * absr * drho * dth / (2 * np.pi) ** 2
    w[absr == 0] = np.pi * (drho / 2) ** 2 / n_spokes / (2 * np.pi) ** 2
    return w.astype(np.float32)


def operators(kx, ky, n: int, eps: float = EPS):
    """(forward, adjoint): image (n, n, 2) -> k-space (M, 2) by type 2, and
    k-space -> image by type 1 of the opposite sign."""
    def fwd(f):
        return nufft.nufft2d2(kx, ky, f, eps=eps, isign=-1)

    def adj(s):
        return nufft.nufft2d1(kx, ky, s, (n, n), eps=eps, isign=1)
    return fwd, adj


def cg(AHA, b, iters: int):
    """``iters`` conjugate-gradient steps on AHA(x) = b from x = 0."""
    x = torch.zeros_like(b)
    r = b - AHA(x)
    p = r
    rs = torch.sum(r * r)
    for _ in range(iters):
        Ap = AHA(p)
        alpha = rs / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def ndft_error(img, kx, ky, data, count: int = 400, seed: int = 0) -> float:
    """max |NUFFT - direct NDFT| / max |NDFT| over ``count`` random samples
    (the direct sum in float64 on the host)."""
    n = img.shape[0]
    sub = np.random.default_rng(seed).choice(kx.size, count, replace=False)
    p1 = np.arange(-(n // 2), (n + 1) // 2)
    ref = np.einsum("ab,sa,sb->s", img.astype(np.complex128),
                    np.exp(-1j * np.outer(kx[sub], p1)), np.exp(-1j * np.outer(ky[sub], p1)))
    got = ascomplex(data)[sub]
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def rmse(recon, img) -> float:
    return float(np.sqrt(np.mean(np.abs(ascomplex(recon).real - img) ** 2)))


def run(device="cuda", n: int = 128, n_spokes: int = 200, n_read: int = 256, *,
        iters: int = 15, mesh=None, verbose: bool = True) -> dict:
    """The whole reconstruction on ``device`` (and the distributed leg on
    ``mesh``); returns the pin, the two RMSEs (and the distributed legs'
    relative errors) with the arrays they were read from."""
    say = print if verbose else (lambda *a, **k: None)
    if mesh is not None:
        from ..parallel.sharded import mesh_device
        device = mesh_device(mesh)
    img = shepp_logan_lite(n)
    kx, ky, absr = radial_trajectory(n_spokes, n_read)
    say(f"phantom {n}x{n}, {n_spokes} spokes x {n_read} = {kx.size} samples")
    fwd, adj = operators(kx, ky, n)
    fi = torch.from_numpy(np.stack([img, np.zeros_like(img)], -1).astype(np.float32)).to(device)
    data = fwd(fi)                                               # k-space

    out = {"data": data, "ndft": ndft_error(img, kx, ky, data)}
    say(f"forward vs direct NDFT (400-sample subset): {out['ndft']:.2e}")
    assert out["ndft"] < 2e-5

    wi = torch.from_numpy(ramp_weights(absr, n_spokes, n_read)).to(device)[:, None]
    out["grid"] = adj(data * wi)
    out["rmse_grid"] = rmse(out["grid"], img)
    say(f"gridding (ramp-compensated adjoint) RMSE: {out['rmse_grid']:.3f}")

    def AHA(f):
        return adj(fwd(f))

    out["cg"] = cg(AHA, adj(data), iters)
    out["rmse_cg"] = rmse(out["cg"], img)
    say(f"CG recon ({iters} iterations) RMSE: {out['rmse_cg']:.4f}")

    if mesh is not None:
        from ..parallel import nufft as dnu
        dfwd = dnu.build_distributed_nufft_type2((kx, ky), (n, n), mesh, isign=-1, eps=EPS)
        dadj = dnu.build_distributed_nufft_type1((kx, ky), (n, n), mesh, isign=1, eps=EPS)
        ddata = dfwd(fi).full_tensor()
        dgrid = dadj(ddata * wi).full_tensor()
        out["dist_fwd"] = float((ddata - data).abs().max() / data.abs().max().clamp_min(1e-9))
        out["dist_adj"] = float((dgrid - out["grid"]).abs().max() / dgrid.abs().max())
        say(f"distributed forward/adjoint vs one device: {out['dist_fwd']:.2e} / "
            f"{out['dist_adj']:.2e} ({mesh.size()} ranks, points sharded)")
        assert out["dist_fwd"] < 1e-5
        # the adjoint sums the spreads in another order (a psum of per-rank
        # grids against sequential chunks): f32 summation-order noise
        assert out["dist_adj"] < 5e-5
    return out


def main(argv=None):
    import torch.distributed as dist

    from ..parallel import make_mesh
    from ._world import rank0, world
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with world(args.device):
        r = run(args.device, mesh=make_mesh({"sp": dist.get_world_size()}, device=args.device),
                verbose=rank0())
        # residual error is the un-sampled k-space corners (radial coverage is
        # the inscribed disc) ringing at the phantom's jumps, not CG
        assert r["rmse_grid"] < 0.12 and r["rmse_cg"] < 0.035
        if rank0():
            print("OK")


if __name__ == "__main__":
    main()
