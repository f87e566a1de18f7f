"""The port's examples (``webgpufft_tpu_torch/examples/``) against the
repository's JAX scripts (``examples/``) on the same seeds, on the CPU:
the four facade demos, AOT serving, MRI gridding (tests/test_example_mri.py
case by case) and system identification (the single-device case of
tests/test_example_train.py).  The distributed halves run in the 8-rank
world of test_torch_distributed_examples.py.  Tolerance: 1e-5 of
max|JAX| (the facade bar), unless a case says otherwise."""

import importlib.util
import os
import runpy

import numpy as np
import pytest
import torch

import webgpufft_tpu_torch as T
from torch_port_support import assert_close_c, to_numpy
from webgpufft_tpu_torch.examples import aot_serving as PA
from webgpufft_tpu_torch.examples import image_blur_fftconv as PB
from webgpufft_tpu_torch.examples import mri_gridding as PM
from webgpufft_tpu_torch.examples import scipy_style as PS
from webgpufft_tpu_torch.examples import signal_toolkit as PT
from webgpufft_tpu_torch.examples import spectral_filter as PF
from webgpufft_tpu_torch.examples import system_identification as PI

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(name + "_example",
                                                  os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mri():
    return _load("mri_gridding")


def _same_named(port, jax_globals, label):
    """Every result the port's run names equals the JAX script's global of
    that name (1e-5 of its max; exactly for integers and booleans)."""
    for name, got in port.items():
        want = np.asarray(jax_globals[name])
        got = to_numpy(got)
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {name}")
        else:
            assert_close_c(got, want, 1e-5, f"{label} {name}")


@pytest.mark.parametrize("name,port", [("scipy_style", PS), ("signal_toolkit", PT)],
                         ids=["scipy_style", "signal_toolkit"])
def test_facade_script_results_match_jax(name, port, capsys):
    want = runpy.run_path(os.path.join(EXAMPLES, name + ".py"))
    got = port.run("cpu", verbose=False)
    assert set(got) <= set(want)
    _same_named(got, want, name)


def test_spectral_filter_matches_jax():
    import webgpufft_tpu as W
    r = PF.run("cpu", verbose=False)
    x, n = r["x"], r["x"].shape[1]
    fwd = W.create_plan(type="r2c", shape=[n], direction="forward", batch=8)
    inv = W.create_plan(type="c2r", shape=[n], direction="inverse",
                        normalize="backward", batch=8)
    mask = (np.arange(n // 2 + 1) <= 20).astype(np.float32)[None, :, None]
    assert_close_c(r["filtered"].numpy(), np.asarray(inv(fwd(x) * mask)), 1e-5, "filtered")
    assert r["noise_after"] < r["noise_before"] / 3


def test_image_blur_matches_jax():
    import webgpufft_tpu as W
    jex = _load("image_blur_fftconv")
    r = PB.run("cpu", verbose=False)
    np.testing.assert_array_equal(r["kern"], jex.gaussian_kernel(9, 2.0))
    plan = W.create_plan(type="fftconv", shape=[128, 128], batch=1,
                         fftConv={"boundary": "linear-same", "kernelShape": [9, 9]})
    out = plan.exec(W.interleave(r["img"].astype(np.complex64)),
                    kernel=W.interleave(r["kern"].astype(np.complex64)))
    assert_close_c(r["out"].numpy(), np.asarray(out), 1e-5, "blur")
    assert r["blurred"].std() < r["img"][0].std()


def test_aot_serving_in_a_second_process_matches_jax():
    """Built here, served by ``python -m ...aot_serving serve`` in another
    process; the served output against the JAX artifact's on the same
    request and numpy, at the JAX script's 1e-5."""
    import webgpufft_tpu as W
    r = PA.run("cpu", verbose=False)
    jplan = W.create_plan(type="c2c", shape=[1024], batch=64, direction="forward",
                          normalize="unitary", cache=W.PlanCache())
    jy = np.asarray(W.load_exported_plan(W.export_plan(jplan))(PA.request(64)))
    assert r["y"].shape == (64, 1024, 2) and r["route"] == "pallas-fused"
    assert_close_c(r["y"], jy, 1e-5, "served")
    assert r["err"] < 1e-5


# ---------------------------------------------------- tests/test_example_mri.py

def test_trajectory_geometry(mri):
    kx, ky, absr = PM.radial_trajectory(10, 64)
    for a, b in zip((kx, ky, absr), mri.radial_trajectory(10, 64)):
        np.testing.assert_array_equal(a, b)
    assert kx.shape == ky.shape == absr.shape == (640,)
    r = np.hypot(kx, ky)
    assert r.max() <= np.pi + 1e-12
    np.testing.assert_allclose(r, np.pi * absr, atol=1e-12)


def test_phantom_range(mri):
    img = PM.shepp_logan_lite(64)
    np.testing.assert_array_equal(img, mri.shepp_logan_lite(64))
    assert img.shape == (64, 64)
    assert 0.9 <= img.max() <= 1.1 and img.min() >= -1e-12


def test_small_recon_end_to_end(mri):
    """n 32, 56 spokes x 64 reads: the NDFT pin, the compensated adjoint
    near the phantom, 10 CG iterations below 0.06 (the JAX test's bars);
    k-space and the gridded image against the JAX NUFFT at 1e-5."""
    import jax.numpy as jnp
    from webgpufft_tpu import nufft as NU
    from webgpufft_tpu.fftapi import asinterleaved
    n, n_spokes, n_read = 32, 56, 64
    r = PM.run("cpu", n, n_spokes, n_read, iters=10, verbose=False)
    assert r["ndft"] < 2e-5 and r["rmse_grid"] < 0.12 and r["rmse_cg"] < 0.06
    img = mri.shepp_logan_lite(n)
    kx, ky, absr = mri.radial_trajectory(n_spokes, n_read)
    data = NU.nufft2d2(kx, ky, asinterleaved(img.astype(np.complex64)), isign=-1)
    assert_close_c(r["data"].numpy(), np.asarray(data), 1e-5, "k-space")
    wi = jnp.asarray(PM.ramp_weights(absr, n_spokes, n_read))[:, None]
    grid = NU.nufft2d1(kx, ky, jnp.asarray(data) * wi, (n, n), isign=1)
    assert_close_c(r["grid"].numpy(), np.asarray(grid), 1e-5, "gridded")


def test_aha_exports_through_generic_aot():
    """The normal operator (type 2 -> type 1) through ``export_pipeline``:
    the loaded program reproduces the eager call bit for bit, and the JAX
    operator at 1e-5."""
    from webgpufft_tpu import nufft as NU
    rng = np.random.default_rng(1)
    n, m = 16, 40
    kx = rng.uniform(0, 2 * np.pi, m)
    ky = rng.uniform(0, 2 * np.pi, m)
    fwd, adj = PM.operators(kx, ky, n)

    def aha(f):
        return adj(fwd(f))

    f0 = rng.standard_normal((n, n, 2)).astype(np.float32)
    live = aha(torch.from_numpy(f0))
    served = T.load_exported_pipeline(T.export_pipeline(aha, torch.from_numpy(f0)))
    np.testing.assert_array_equal(served(torch.from_numpy(f0)).numpy(), live.numpy())
    want = NU.nufft2d1(kx, ky, NU.nufft2d2(kx, ky, f0, eps=1e-6), (n, n), eps=1e-6)
    assert_close_c(live.numpy(), np.asarray(want), 1e-5, "AHA")


# -------------------------------------------------- tests/test_example_train.py

def test_recovers_the_kernel():
    """n 128, klen 9, batch 4, 200 Adam steps through the fftconv plan: the
    loss falls below 1e-3 of its start, the kernel within 2e-2 (the JAX
    test's bars); the trajectory ends within 1e-3 of max|k| of the JAX run's
    (observed 2.7e-08)."""
    jex = _load("system_identification")
    k_hat, k_true, losses = PI.run(n=128, klen=9, batch=4, steps=200, noise=1e-4,
                                   device="cpu")
    assert losses[-1] < losses[0] * 1e-3
    err = np.max(np.abs(k_hat - k_true)) / np.max(np.abs(k_true))
    assert err < 2e-2, err
    jk, jtrue, jlosses = jex.run(n=128, klen=9, batch=4, steps=200, noise=1e-4)
    np.testing.assert_array_equal(k_true, jtrue)
    assert np.max(np.abs(k_hat - jk)) <= 1e-3 * np.max(np.abs(jk))
    assert_close_c(losses[:5], jlosses[:5], 1e-5, "first losses")
