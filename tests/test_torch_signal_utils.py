"""The signal-utility batch of the port (webgpufft_tpu_torch: the facade's
envelope, vectorstrength, czt_points, CZT/ZoomFFT, COLA/NOLA checks,
choose_conv_method and dual window; waveforms.max_len_seq; iirdesign's
tf2sos, gammatone and transforms; ltisys.abcd_normalize; filtering's
lfiltic, freqz_sos and firwin_2d; peaks.find_peaks_cwt) through the JAX
package's own cases: tests/test_signal_utils.py's classes run here with
each module they name stood in by ``BothModules`` (numpy inputs on the CPU
device), so every call runs the port's copy and the JAX package's on the
same arguments and holds them together, and each case then holds the
port's result against scipy.signal at that test's own tolerance.

Tolerance between the two packages: the facade's device functions 1e-5 of
max|JAX result| (the facade tests' bar, tests/test_torch_fftapi.py), the
recurrence of ``lfilter`` 1e-5 (tests/test_torch_filtering.py), the rest
equal (the same float64 host code)."""

import numpy as np
import pytest
import scipy.signal as ss

import test_signal_utils as J
import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu_torch import fftapi as TF
from test_signal_utils import (TestAbcdNormalize, TestClosestDualWindow,  # noqa: F401
                               TestColaNola, TestCztPoints, TestCztZoomClasses,
                               TestEnvelope, TestEnvelopeCornerBands, TestFindPeaksCwt,
                               TestFirwin2d, TestFreqzSos, TestGammatone, TestLfiltic,
                               TestMaxLenSeq, TestTf2Sos, TestTfTransformsAndBandStopObj,
                               TestVectorstrength, rng)
from test_signal_utils import TestChooseConvMethod as _JaxChooseConvMethod
from torch_port_support import BothModules

FACADE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _through_the_port(monkeypatch):
    stand_ins = {
        "wfft": BothModules(T.fft, W.fft, FACADE_TOL),
        "WV": BothModules(T.waveforms, W.waveforms),
        "D": BothModules(T.iirdesign, W.iirdesign),
        "L": BothModules(T.ltisys, W.ltisys),
    }
    for name, mod in stand_ins.items():
        monkeypatch.setattr(J, name, mod)
    # the cases that import a module inside their body get it from the
    # package: stand the port in there too, for the duration of the case
    for name, mod in {"fft": stand_ins["wfft"], "iirdesign": stand_ins["D"],
                      "filtering": BothModules(T.filtering, W.filtering,
                                               {"*": None, "lfilter": 1e-5,
                                                "freqz_sos": 1e-6}),
                      "peaks": BothModules(T.peaks, W.peaks),
                      "ShortTimeFFT": T.ShortTimeFFT}.items():
        monkeypatch.setattr(W, name, mod)
    # a class of the port called directly raises the port's PlanError
    monkeypatch.setattr(J, "PlanError", (J.PlanError, T.PlanError))
    with TF.default_device("cpu"):
        yield


class TestChooseConvMethod(_JaxChooseConvMethod):
    def test_measure(self):
        """The measured choice times both methods: the two packages' clocks
        differ, so the port's answer is held to the contract alone."""
        method, times = T.fft.choose_conv_method(np.ones(256), np.ones(64), measure=True)
        assert method in ("fft", "direct")
        assert set(times) == {"fft", "direct"}
