"""The port's peak finding (webgpufft_tpu_torch/peaks.py) through the JAX
package's own cases: tests/test_peaks.py's classes run here with its module
stood in by ``BothModules``, so every call runs the port's copy and the JAX
package's on the same arguments and holds them equal, and each case then
holds the port's result against scipy.signal exactly, as that file does.
The re-export through ``filtering`` waits for the port's filtering (ROADMAP
P11.3); the device chain runs here on the port's welch."""

import warnings

import numpy as np
import pytest
import scipy.signal as ss
import torch

import test_peaks as J
from webgpufft_tpu import peaks as JP
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import peaks as TP
from test_peaks import TestArgrel, TestFindPeaks, TestProminencesWidths  # noqa: F401
from torch_port_support import BothModules


@pytest.fixture(autouse=True)
def _through_the_port(monkeypatch):
    monkeypatch.setattr(J, "P", BothModules(TP, JP))


def test_device_chain(rng):
    """welch on the device (here the CPU device) -> find_peaks on the
    host, the tensor handed over as it is."""
    t = np.arange(2048) / 1000.0
    x = (np.sin(2 * np.pi * 100 * t) + 0.5 * np.sin(2 * np.pi * 270 * t)
         + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    f, pxx = TF.welch(torch.from_numpy(x), fs=1000.0, nperseg=512)
    pk, props = TP.find_peaks(pxx, prominence=1e-3)
    freqs = np.asarray(f)[pk]
    assert np.any(np.abs(freqs - 100.0) < 4)
    assert np.any(np.abs(freqs - 270.0) < 4)
    want, _ = ss.find_peaks(pxx.numpy().astype(np.float64), prominence=1e-3)
    assert np.array_equal(pk, want)


def test_tensor_signals_are_copied_to_the_host(rng):
    x = rng.standard_normal(300)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, kw in [("find_peaks", {"prominence": 0.5}), ("argrelmax", {"order": 2})]:
            got = getattr(TP, name)(torch.from_numpy(x), **kw)
            want = getattr(ss, name)(x, **kw)
            np.testing.assert_array_equal(got[0], want[0])
    pk, _ = ss.find_peaks(x)
    np.testing.assert_array_equal(TP.peak_prominences(torch.from_numpy(x), pk)[0],
                                  ss.peak_prominences(x, pk)[0])
