"""The port's LTI toolbox (webgpufft_tpu_torch/ltisys.py) through the JAX
package's own cases: tests/test_ltisys.py's classes run here with its
module stood in by ``BothModules``, so every call runs the port's copy and
the JAX package's on the same arguments and holds them together, and each
case then holds the port's result against scipy.signal at that test's own
tolerance.

Tolerance between the two packages: the conversions, discretizations,
responses and classes give equal results (the same float64 host code); the
simulations (``lsim``, ``dlsim`` and the step and impulse responses built
on them) 1e-5 of max|JAX result|: both run the state recurrence in float32,
and XLA contracts the JAX scan's multiply-adds into fused multiply-adds
where torch rounds each product (up to 2.6e-6 apart on these cases)."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import test_ltisys as J
import webgpufft_tpu_torch as T
from webgpufft_tpu import ltisys as JL
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import ltisys as L
from test_ltisys import (TestCont2Discrete, TestConversions, TestDlsim,  # noqa: F401
                         TestFrequencyResponse, TestLsim, TestLtiClasses,
                         TestPartialFractions, TestPlacePoles,
                         TestPlacePolesReviewRegressions, TestResponses,
                         TestReviewRegressions, rng)
from torch_port_support import BothModules, assert_close

SIMULATIONS = ("lsim", "dlsim", "step", "impulse", "dstep", "dimpulse")
TOLERANCES = {"*": None, **dict.fromkeys(SIMULATIONS, 1e-5)}


@pytest.fixture(autouse=True)
def _through_the_port(monkeypatch):
    monkeypatch.setattr(J, "L", BothModules(L, JL, TOLERANCES))
    # a method of a returned system object is the port's own and raises the
    # port's PlanError (through the stand-in, the JAX package's propagates)
    monkeypatch.setattr(J, "PlanError", (J.PlanError, T.PlanError))
    with TF.default_device("cpu"):
        yield


class TestNamespace:
    def test_reexported_in_filtering(self):
        assert T.filtering.lsim is L.lsim
        assert "cont2discrete" in T.filtering.__all__
        assert L.__all__ == JL.__all__

    def test_design_chain(self, rng):
        """iirdesign -> cont2discrete -> dlsim through the port's surface."""
        b, a = T.iirdesign.butter(2, 5, analog=True)
        num, den, dt = L.cont2discrete((b, a), 0.01, method="bilinear")
        u = np.ones(200)
        t, y = L.dlsim((np.atleast_1d(np.squeeze(num)), den, dt), u)
        te, ye = ss.dlsim(ss.cont2discrete(ss.butter(2, 5, analog=True),
                                           0.01, method="bilinear"), u)[:2]
        assert_close(y, ye, 2e-4, "chain")


class TestSimulationDevice:
    def test_numpy_in_numpy_out_on_the_default_device(self, monkeypatch):
        """The recurrence runs on the facade's default device; the caller
        gets float64 numpy, as from the JAX package."""
        seen = []
        real = L._scan_ss

        def spy(*args):
            seen.append(TF._default_device())
            return real(*args)
        monkeypatch.setattr(L, "_scan_ss", spy)
        _, y, x = L.lsim(ss.butter(2, 4, analog=True), np.ones(50), np.linspace(0, 1, 50))
        assert seen == [torch.device("cpu")]
        assert isinstance(y, np.ndarray) and y.dtype == np.float64
        assert isinstance(x, np.ndarray) and x.shape == (50, 2)

    def test_cuda_default_without_a_card_raises(self):
        """Outside a ``default_device`` block the recurrence asks for the
        card; without one that raises rather than computing elsewhere."""
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        with TF.default_device("cuda"), pytest.raises(RuntimeError, match="cuda"):
            L.dlsim(([1.0], [1.0, -0.5], 0.1), np.ones(8))

    def test_products_run_at_full_float32(self, monkeypatch):
        seen = []
        real = torch.addmv

        def spy(*args, **kw):
            seen.append(torch.backends.cuda.matmul.fp32_precision)
            return real(*args, **kw)
        monkeypatch.setattr(torch, "addmv", spy)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            L.dlsim(([1.0], [1.0, -0.5], 0.1), np.ones(8))
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert seen and set(seen) == {"ieee"}

    def test_matches_a_float32_loop(self, rng):
        """The device loop is the recurrence in float32, summed in the JAX
        package's order: equal to the same loop in numpy float32."""
        A = (rng.standard_normal((4, 4)) * 0.3).astype(np.float32)
        B0 = rng.standard_normal((4, 2)).astype(np.float32)
        B1 = rng.standard_normal((4, 2)).astype(np.float32)
        U = rng.standard_normal((40, 2)).astype(np.float32)
        x0 = rng.standard_normal(4).astype(np.float32)
        got = L._scan_ss(A.astype(np.float64), B0.astype(np.float64),
                         B1.astype(np.float64), x0, U)
        x, want = x0, [x0]
        for i in range(39):
            x = (A @ x + B0 @ U[i]) + B1 @ U[i + 1]
            want.append(x)
        assert_close(got, np.stack(want), 1e-6, "float32 loop")
