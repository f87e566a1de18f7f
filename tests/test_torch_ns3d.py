"""The 3-D Navier-Stokes example on the PyTorch port
(``webgpufft_tpu_torch.examples.navier_stokes3d``) against the JAX example
(``examples/navier_stokes3d.py``, loaded as tests/test_example_ns3d.py
loads it), at n = 16 on the CPU.  Tolerance: 1e-5 * max|expected|; the
bf16-storage step at the JAX example's own limit, 1e-3 of the f32 step.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.examples import navier_stokes3d as P
from torch_port_support import torch_fft_stepper3

N, NU, DT = 16, 2e-2, 1e-2


@pytest.fixture(scope="module")
def ns3():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "navier_stokes3d.py")
    spec = importlib.util.spec_from_file_location("ns3d_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("field", ["random", "taylor_green", "abc"])
def test_step_matches_jax(field, ns3, assert_close):
    if field == "random":
        u0 = (np.random.default_rng(3).standard_normal((3, N, N, N)) * 0.1).astype(np.float32)
    else:
        u0 = getattr(ns3, {"taylor_green": "taylor_green_embedded",
                           "abc": "abc_flow"}[field])(N, 0.0, NU)
    jstep, jto_s, jto_p = ns3.make_stepper3(N, NU, DT)
    tstep, tto_s, tto_p = P.make_stepper3(N, NU, DT, device="cpu")
    u_hat = np.array(jto_s(u0))
    assert_close(tto_s(torch.from_numpy(u0)).numpy(), u_hat, label="to_spectral")
    v = np.asarray(jstep(u_hat))
    got = tstep(torch.from_numpy(u_hat))
    assert tuple(got.shape) == (3, N // 2 + 1, N, N, 2)
    assert_close(got.numpy(), v, label=f"step {field}")
    assert_close(tto_p(got).numpy(), np.asarray(jto_p(v)), label="to_physical")


def test_grids_match_jax(ns3):
    want = ns3.spectral_grids3(N)
    got = P.spectral_grids3(N, "cpu")
    for w, g in zip(want, got):
        assert np.array_equal(np.broadcast_to(g.numpy(), w.shape), w)


@pytest.mark.parametrize("name", ["taylor_green_embedded", "abc_flow"])
def test_initial_fields_match_jax(name, ns3, assert_close):
    for t in (0.0, 0.3):
        assert_close(getattr(P, name)(N, t, NU, device="cpu").numpy(),
                     getattr(ns3, name)(N, t, NU), label=f"{name} t={t}")


@pytest.mark.parametrize("name", ["taylor_green_embedded", "abc_flow"])
def test_exact_solutions_hold(name, assert_close):
    """Embedded Taylor-Green (the Leray projection must cancel its
    gradient nonlinear term exactly) and ABC (omega = u) decay
    analytically under the port's full nonlinear solver."""
    steps = 12
    make = getattr(P, name)
    u = P.run3(make(N, 0.0, NU, device="cpu"), N, NU, DT, steps, device="cpu")
    assert_close(u.numpy(), make(N, DT * steps, NU, device="cpu").numpy(),
                 label=f"{name} after {steps} steps")


def test_torch_fft_stepper_matches_the_plans(assert_close):
    u0 = torch.from_numpy(
        (np.random.default_rng(4).standard_normal((3, N, N, N)) * 0.1).astype(np.float32))
    step, to_s, to_p = P.make_stepper3(N, NU, DT, device="cpu")
    fstep, fto_s, fto_p = torch_fft_stepper3(N, NU, DT, "cpu")
    u_hat = to_s(u0)
    assert_close(fto_s(u0).numpy(), u_hat.numpy(), label="to_spectral")
    assert_close(fstep(u_hat).numpy(), step(u_hat).numpy(), label="step")
    assert_close(fto_p(u_hat).numpy(), to_p(u_hat).numpy(), label="to_physical")


def test_energy_decays():
    u0 = torch.from_numpy(np.random.default_rng(0).standard_normal((3, N, N, N)).astype(np.float32))
    e0 = P.kinetic_energy(P.run3(u0, N, NU, DT, 0, device="cpu"))
    e1 = P.kinetic_energy(P.run3(u0, N, NU, DT, 5, device="cpu"))
    assert 0 < e1 < e0


def test_options_not_ported_raise():
    with pytest.raises(T.PlanError, match="precision"):
        P.make_stepper3(N, NU, DT, device="cpu", precision="f64")


def test_bf16_storage_step_tracks_f32_and_jax(ns3):
    """precision="bf16-storage": the plans take and return bfloat16, the
    solver state stays float32; a step tracks the f32 step, and the JAX
    example's bf16-storage step, within 1e-3 (the JAX test's limit)."""
    u0 = (np.random.default_rng(3).standard_normal((3, N, N, N)) * 0.1).astype(np.float32)
    step_f, to_s, _ = P.make_stepper3(N, NU, DT, device="cpu")
    step_b, to_s_b, to_p_b = P.make_stepper3(N, NU, DT, device="cpu", precision="bf16-storage")
    jstep_b, _, _ = ns3.make_stepper3(N, NU, DT, precision="bf16-storage")
    u_hat = to_s(torch.from_numpy(u0))
    vf, vb = step_f(u_hat).numpy(), step_b(u_hat)
    assert vb.dtype == torch.float32 and tuple(vb.shape) == (3, N // 2 + 1, N, N, 2)
    scale = np.max(np.abs(vf))
    assert np.max(np.abs(vb.numpy() - vf)) / scale < 1e-3
    assert np.max(np.abs(vb.numpy() - np.asarray(jstep_b(u_hat.numpy())))) / scale < 1e-3
    assert to_p_b(vb).dtype == torch.float32
    assert np.max(np.abs(to_s_b(torch.from_numpy(u0)).numpy() - u_hat.numpy())) \
        / np.max(np.abs(u_hat.numpy())) < 2e-2


def test_max_divergence_matches_jax(ns3):
    """The numpy oracle, on a tensor and on numpy, equals the JAX
    example's on a random and on a projected (divergence-free) field."""
    u0 = np.random.default_rng(5).standard_normal((3, N, N, N)).astype(np.float32)
    u1 = P.run3(torch.from_numpy(u0), N, NU, DT, 1, device="cpu")
    for u in (u0, u1.numpy()):
        want = ns3.max_divergence(u, N)
        assert P.max_divergence(torch.from_numpy(u), N) == want == P.max_divergence(u, N)
    assert ns3.max_divergence(u0, N) > 1e-2 and ns3.max_divergence(u1.numpy(), N) < 1e-4


def test_turbulence_invariants(ns3):
    """tests/test_example_ns3d.py::test_turbulence_invariants: energy falls
    and the field stays divergence-free over 10 steps of random
    turbulence; the energies equal the JAX run's at 1e-5."""
    steps = 10
    u0 = np.random.default_rng(0).standard_normal((3, N, N, N)).astype(np.float32)
    u1 = P.run3(torch.from_numpy(u0), N, NU, DT, steps, device="cpu")
    e0 = P.kinetic_energy(P.run3(torch.from_numpy(u0), N, NU, DT, 0, device="cpu"))
    e1 = P.kinetic_energy(u1)
    assert e1 < e0
    assert P.max_divergence(u1, N) < 1e-4
    je1 = ns3.kinetic_energy(ns3.run3(u0, N, NU, DT, steps))
    assert abs(e1 - je1) <= 1e-5 * je1


def test_solver_exports_as_aot_artifact():
    """tests/test_example_ns3d.py::test_solver_exports_as_aot_artifact: a
    3-step advance through ``export_pipeline``; the loaded program
    reproduces the eager run bit for bit."""
    steps = 3
    step, to_s, to_p = P.make_stepper3(N, NU, DT, device="cpu")
    u_hat = to_s(P.taylor_green_embedded(N, 0.0, NU, device="cpu"))

    def advance(v):
        for _ in range(steps):
            v = step(v)
        return v

    art = T.load_exported_pipeline(T.export_pipeline(advance, u_hat))
    got = to_p(art(u_hat)).numpy()
    ref = P.run3(P.taylor_green_embedded(N, 0.0, NU, device="cpu"), N, NU, DT, steps,
                 device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


def test_main_runs_the_example_checks():
    """``main`` at n 16 on the CPU (a one-rank world): the analytic flows,
    the turbulence invariants, slab and pencil against one device."""
    out = P.main(["--device", "cpu", "--n", "16"])
    assert out["embedded Taylor-Green"] < 1e-4 and out["ABC flow"] < 1e-4
    assert out["energy"][1] < out["energy"][0] and out["divergence"] < 1e-4
    assert out["slab"] < 1e-4 and out["pencil"] < 1e-4
