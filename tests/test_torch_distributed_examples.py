"""The port's examples that run on a mesh, held against the JAX package's
(``examples/navier_stokes2d.py`` whole, the slab and pencil cases of
``examples/navier_stokes3d.py``, ``poisson3d`` and ``multichip_fft`` at
small sizes): the distributed runs in a gloo world of 8 CPU ranks, the
single-device runs in this process on the CPU.  Mirrors
tests/test_example_ns.py case by case and test_example_ns3d.py's slab and
pencil cases, at the JAX tests' sizes and bars."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.examples import navier_stokes2d as P2
from webgpufft_tpu_torch.examples import navier_stokes3d as P3
from torch_world import world_fixture

world = world_fixture(8)


def _load(name):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3] + "_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ns():
    return _load("navier_stokes2d.py")


@pytest.fixture(scope="module")
def ns3():
    return _load("navier_stokes3d.py")


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b)))


def test_taylor_green_exact(ns):
    n, nu, dt, steps = 32, 1e-2, 1e-2, 20
    w = P2.run(P2.taylor_green(n, 0.0, nu), n, nu, dt, steps, device="cpu")
    ref = P2.taylor_green(n, dt * steps, nu)
    assert _rel(w, ref) < 1e-5
    assert _rel(w, ns.run(ns.taylor_green(n, 0.0, nu), n, nu, dt, steps)) < 1e-5


def test_distributed_matches_single_chip(world, ns):
    n, nu, dt, steps = 32, 5e-3, 5e-3, 10
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((n, n)).astype(np.float32)
    w0 -= w0.mean()
    single = P2.run(w0, n, nu, dt, steps, device="cpu")
    dist = world.run("call", "torch_world_cases", "ns2d_run", w0, n, nu, dt, steps,
                     {"sp": 8}, "sp")
    assert _rel(dist, single) < 1e-4
    assert _rel(dist, ns.run(w0, n, nu, dt, steps)) < 1e-4


def test_pencil_matches_single_chip(world, ns):
    n, nu, dt, steps = 32, 5e-3, 5e-3, 8
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((n, n)).astype(np.float32)
    w0 -= w0.mean()
    single = P2.run(w0, n, nu, dt, steps, device="cpu")
    pencil = world.run("call", "torch_world_cases", "ns2d_run", w0, n, nu, dt,
                       steps, {"sp1": 2, "sp2": 4}, ["sp1", "sp2"])
    assert _rel(pencil, single) < 1e-4


def test_turbulence_decays(ns):
    n = 32
    rng = np.random.default_rng(11)
    w0 = rng.standard_normal((n, n)).astype(np.float32)
    w0 -= w0.mean()
    e0, z0 = P2.energy_enstrophy(w0, n)
    w1 = P2.run(w0, n, 5e-3, 5e-3, 40, device="cpu")
    e1, z1 = P2.energy_enstrophy(w1, n)
    assert z1 < z0
    assert e1 < e0 * 1.001
    assert np.all(np.isfinite(w1))
    assert _rel(w1, ns.run(w0, n, 5e-3, 5e-3, 40)) < 1e-4


def test_solver_exports_as_aot_artifact(ns):
    """The multi-step solver serializes through ``export_pipeline`` and
    the loaded artifact reproduces the direct run exactly."""
    n, nu, dt, steps = 32, 1e-2, 1e-2, 5
    step, to_s, to_p = P2.make_stepper(n, nu, dt, device="cpu")
    w_hat = to_s(P2.taylor_green(n, 0.0, nu))

    def advance(v):
        for _ in range(steps):
            v = step(v)
        return v

    art = T.load_exported_pipeline(T.export_pipeline(advance, w_hat))
    got = to_p(art(w_hat)).numpy()
    ref = P2.run(P2.taylor_green(n, 0.0, nu), n, nu, dt, steps, device="cpu")
    np.testing.assert_array_equal(got, ref)


def test_spectral_grids_conventions(ns):
    for packed_axis, shape in ((1, (16, 9)), (0, (9, 16))):
        got = P2.spectral_grids(16, packed_axis)
        for g, w in zip(got, ns.spectral_grids(16, packed_axis)):
            np.testing.assert_array_equal(g, w)
        kx, ky, inv_k2, mask = got
        assert np.broadcast_shapes(kx.shape, ky.shape) == shape
        full = np.broadcast_to(kx * kx + ky * ky, shape)
        inv = np.broadcast_to(inv_k2, shape)
        assert inv[0, 0] == 0.0
        nz = full > 0
        assert np.allclose(inv[nz], 1.0 / full[nz], rtol=1e-6)
        m = np.broadcast_to(mask, shape)
        assert m[0, 0] == 1.0 and m.min() == 0.0


def test_ns3d_slab_matches_single_chip(world, ns3):
    n, nu, dt, steps = 16, 2e-2, 1e-2, 6
    u0 = np.random.default_rng(1).standard_normal((3, n, n, n)).astype(np.float32)
    single = P3.run3(torch.from_numpy(u0), n, nu, dt, steps, device="cpu").numpy()
    dist = world.run("call", "torch_world_cases", "ns3d_run", u0, n, nu, dt, steps,
                     {"sp": 8}, "sp")
    assert _rel(dist, single) < 1e-4
    assert _rel(dist, ns3.run3(u0, n, nu, dt, steps)) < 1e-4


def test_ns3d_pencil_matches_single_chip(world, ns3):
    n, nu, dt, steps = 16, 2e-2, 1e-2, 6
    u0 = np.random.default_rng(2).standard_normal((3, n, n, n)).astype(np.float32)
    single = P3.run3(torch.from_numpy(u0), n, nu, dt, steps, device="cpu").numpy()
    dist = world.run("call", "torch_world_cases", "ns3d_run", u0, n, nu, dt, steps,
                     {"sp1": 2, "sp2": 2}, ["sp1", "sp2"])
    assert _rel(dist, single) < 1e-4


def test_poisson3d(world):
    """The example's slab and pencil solves recover the manufactured
    solution on 8 ranks (32^3, its own bars)."""
    r = world.run("call", "torch_world_cases", "example_run", "poisson3d", n=32)
    assert r["res"] < 1e-4 and r["err"] < 1e-4
    assert r["pencil"] is not None and r["pencil"] < 1e-5


def test_poisson3d_matches_jax_symbol():
    """The port's spectral symbol and stencil are the JAX example's."""
    from webgpufft_tpu_torch.examples import poisson3d as PP
    u_star, f = PP.manufactured(8)
    v = np.random.default_rng(0).standard_normal((8, 8, 8)).astype(np.float32)
    ref = -6.0 * v
    for ax in range(3):
        ref = ref + np.roll(v, 1, ax) + np.roll(v, -1, ax)
    np.testing.assert_allclose(PP.lap(v), ref, rtol=1e-6)
    np.testing.assert_allclose(PP.lap(torch.from_numpy(v)).numpy(), ref, rtol=1e-6)
    assert PP.inverse_symbol(8).shape == (5, 8, 8) and PP.inverse_symbol(8)[0, 0, 0] == 0


def test_multichip_fft(world):
    err, err2 = world.run("call", "torch_world_cases", "example_run",
                          "multichip_fft", n=4096)
    assert err < 1e-5 and err2 < 1e-5


@pytest.mark.parametrize("dim,axes,seq_axis", [
    (2, {"sp": 8}, "sp"), (2, {"sp1": 2, "sp2": 4}, ("sp1", "sp2")),
    (3, {"sp": 8}, "sp"), (3, {"sp1": 2, "sp2": 4}, ("sp1", "sp2"))])
def test_ns_step_stays_on_shards(world, dim, axes, seq_axis):
    """One distributed NS step gathers no field: the state is this rank's
    shard of the spectrum, and the only collectives are the transforms'
    exchanges, each on one mesh dim's group."""
    n = 16
    coll, shard = world.run("call", "torch_world_cases", "ns_step_collectives",
                            dim, n, axes, seq_axis)
    assert coll["all_gather"] == 0, coll
    assert coll["all_to_all"] > 0 and coll["max_group"] <= max(axes.values())
    # rank 0's shard of the packed axis (n//2 + 1 rows over the first dim)
    first = axes["sp"] if "sp" in axes else axes["sp1"]
    assert shard[-dim - 1] == -(-(n // 2 + 1) // first), shard


def test_distributed_training_matches_single_chip(world):
    """tests/test_example_train.py::test_distributed_training_matches_single_chip:
    60 Adam steps through the fftconv plan over dp 2 x sp 2 end within 1e-4
    of the single-device run (the kernel's gradient crosses the
    distributed plan's kernel layout and the psum of the replicated
    kernel)."""
    from webgpufft_tpu_torch.examples import system_identification as PI
    kw = dict(n=128, klen=9, batch=4, steps=60, noise=1e-4)
    single, _, _ = PI.run(device="cpu", **kw)
    dist, _, losses = world.run("call", "torch_world_cases", "sysid_run",
                                {"dp": 2, "sp": 2}, **kw)
    err = np.max(np.abs(dist - single)) / max(np.max(np.abs(single)), 1e-12)
    assert err < 1e-4, err
    assert losses[-1] < losses[0]


def test_mri_distributed_leg(world):
    """examples/mri_gridding.py's distributed leg at the MRI test's size,
    points sharded over 8 ranks: forward within 1e-5, the adjoint (a psum
    of per-rank grids) within 5e-5 of one device; the bars of the rest."""
    r = world.run("call", "torch_world_cases", "mri_run", {"sp": 8}, device="cpu",
                  n=32, n_spokes=56, n_read=64, iters=10)
    assert r["dist_fwd"] < 1e-5 and r["dist_adj"] < 5e-5
    assert r["ndft"] < 2e-5 and r["rmse_grid"] < 0.12 and r["rmse_cg"] < 0.06
