"""The port's IIR filter design (webgpufft_tpu_torch/iirdesign.py) through
the JAX package's own cases: tests/test_iirdesign.py's classes run here with
its module stood in by ``BothModules``, so every call runs the port's copy
and the JAX package's on the same arguments and holds them equal (the same
float64 host code), and each case then holds the port's result against
scipy.signal at that test's own tolerance.  TestEndToEnd applies the design
through ``filtering``: the package's ``filtering`` is stood in by the port's
for the case (``sosfiltfilt`` held to the JAX package's at 1e-5, the bar
of tests/test_torch_filtering.py's recurrences)."""

import numpy as np
import pytest
import scipy.signal as ss

import test_iirdesign as J
import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu import iirdesign as JD
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import iirdesign as TD
from test_iirdesign import (TestConversions, TestDesigns, TestEndToEnd,  # noqa: F401
                            TestIirdesign, TestNotchPeakComb, TestOrd, TestPrototypes)
from torch_port_support import BothModules


@pytest.fixture(autouse=True)
def _through_the_port(monkeypatch):
    monkeypatch.setattr(J, "D", BothModules(TD, JD))
    monkeypatch.setattr(W, "filtering", BothModules(T.filtering, W.filtering,
                                                    {"*": None, "sosfiltfilt": 1e-5}))
    with TF.default_device("cpu"):
        yield


def test_the_port_keeps_its_own_copy():
    """Same public names, the port's own module, PlanError from the port."""
    assert TD.__all__ == JD.__all__
    assert TD.butter is not JD.butter and TD.PlanError is T.PlanError
    with pytest.raises(T.PlanError):
        TD.iirnotch(600, 30, fs=1000)


def test_design_applied_by_scipy_matches():
    """A design of the port, applied by scipy, filters as scipy's own."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(400)
    got = ss.sosfiltfilt(TD.butter(6, 0.2, output="sos"), x)
    want = ss.sosfiltfilt(ss.butter(6, 0.2, output="sos"), x)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-9
