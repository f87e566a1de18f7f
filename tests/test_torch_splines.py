"""The port's B-spline toolbox (webgpufft_tpu_torch/splines.py) through the
JAX package's own cases: tests/test_splines.py's classes run here with its
module stood in by ``BothModules`` (numpy inputs on the CPU device), so
every call runs the port's copy and the JAX package's on the same
arguments and holds them together, and each case then holds the port's
result against scipy.signal at that test's own tolerance.

Tolerance between the two packages, as a fraction of max|JAX result|: 1e-6
for ``gauss_spline``, the spline evaluations and ``sepfir2d``; 1e-5 for the
functions that run the IIR recurrences (``symiirorder*``, ``cspline*``,
``qspline*``, ``spline_filter``), whose multiply-adds XLA fuses where torch
rounds each product (tests/test_torch_filtering.py)."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import test_splines as J
import webgpufft_tpu_torch as T
from webgpufft_tpu import splines as JS
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import splines as SP
from test_splines import (Test2D, TestEval, TestGaussSpline, TestPrefilters,  # noqa: F401
                          TestSepfir2d, TestSymiir, rng)
from torch_port_support import BothModules, assert_close

RECURSIVE = ("symiirorder1", "symiirorder2", "cspline1d", "qspline1d", "cspline2d",
             "qspline2d", "spline_filter")
TOLERANCES = {"*": 1e-6, **dict.fromkeys(RECURSIVE, 1e-5)}


@pytest.fixture(autouse=True)
def _through_the_port(monkeypatch):
    monkeypatch.setattr(J, "SP", BothModules(SP, JS, TOLERANCES))
    with TF.default_device("cpu"):
        yield


class TestNamespace:
    def test_reexported_in_filtering(self):
        assert T.filtering.cspline1d is SP.cspline1d
        assert "symiirorder2" in T.filtering.__all__
        assert SP.__all__ == JS.__all__


class TestTensors:
    def test_tensor_in_stays_on_its_device_float32_out(self, rng):
        x = torch.from_numpy(rng.standard_normal((30, 40)))
        for y in (SP.cspline2d(x), SP.qspline2d(x), SP.spline_filter(x, 0.1),
                  SP.symiirorder1(x, 2.0, 0.4), SP.sepfir2d(x, [1.0, 2.0, 1.0], [1.0])):
            assert y.dtype == torch.float32 and y.device == x.device

    def test_float32_tensor_takes_single_precision_defaults(self, rng):
        """A float32 tensor is single precision: cspline2d's default
        precision is scipy's 1e-3 for it, as for a float32 array."""
        im = rng.standard_normal((40, 50)).astype(np.float32)
        got = SP.cspline2d(torch.from_numpy(im))
        assert_close(got.numpy(), ss.cspline2d(im), 1e-5, "cspline2d f32")

    def test_eval_at_tensor_points_uses_int64_indices(self, rng, monkeypatch):
        cj = torch.from_numpy(ss.cspline1d(rng.standard_normal(40)).astype(np.float32))
        newx = torch.linspace(-5.0, 50.0, 33, dtype=torch.float64)
        got = SP.cspline1d_eval(cj, newx)
        assert_close(got.numpy(), ss.cspline1d_eval(cj.numpy().astype(np.float64),
                                                    newx.numpy()), 1e-5, "eval")
