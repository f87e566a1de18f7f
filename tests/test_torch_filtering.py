"""The port's digital filtering (webgpufft_tpu_torch/filtering.py) through
the JAX package's own cases: tests/test_filtering.py's classes run here with
its module stood in by ``BothModules``, so every call runs the port's copy
(numpy inputs on the CPU device) and the JAX package's on the same
arguments and holds them together, and each case then holds the port's
result against scipy.signal at that test's own tolerance.

Tolerance between the two packages, as a fraction of max|JAX result|: the
host design functions give equal results (the same float64 code); the
device functions 1e-6, except the IIR recurrences (``lfilter`` with a
denominator, ``filtfilt``, ``sosfilt``, ``sosfiltfilt``) at 1e-5: on the
CPU both packages run the sequential recurrence in float32, and XLA
contracts its multiply-adds into fused multiply-adds where torch rounds the
product first (the port equals a float32 numpy loop bit for bit; the two
differ by up to 1.6e-6 of max|y| on these cases, each within 1.3e-6 of
scipy in float64).  The port's parallel-prefix route is held to the JAX
package's at 1e-6 in ``TestAssociativeIirRoute``."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import test_filtering as J
import webgpufft_tpu_torch as T
from webgpufft_tpu import filtering as JF
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import filtering as FL
from test_filtering import (TestFiltfilt, TestFirls, TestFirwin,  # noqa: F401
                            TestFirwin2, TestFreqz, TestFreqzZpk, TestGroupDelay,
                            TestKaiserord, TestLfilter, TestMinimumPhase,
                            TestRemez, TestSavgol, TestSos, TestWiener)
from test_filtering import TestOrderFilters as _JaxOrderFilters
from torch_port_support import BothModules, assert_close, assert_close_c

RECURRENCE_TOL = 1e-5
TOLERANCES = {"*": 1e-6, "lfilter": RECURRENCE_TOL, "filtfilt": RECURRENCE_TOL,
              "sosfilt": RECURRENCE_TOL, "sosfiltfilt": RECURRENCE_TOL}
HOST = ("firwin", "firwin2", "firwin_2d", "kaiser_beta", "kaiser_atten", "firls",
        "minimum_phase", "remez", "kaiserord", "lfilter_zi", "lfiltic", "sosfilt_zi",
        "savgol_coeffs", "group_delay")
TOLERANCES.update(dict.fromkeys(HOST))


@pytest.fixture(autouse=True)
def _through_the_port(monkeypatch):
    monkeypatch.setattr(J, "FL", BothModules(FL, JF, TOLERANCES))
    with TF.default_device("cpu"):
        yield


class TestOrderFilters(_JaxOrderFilters):
    def test_jit_composes(self, rng):
        """The JAX case traces medfilt under ``jit``; here the input is a
        tensor that requires grad: the median passes its gradient to the
        selected element of each window."""
        x = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
        x.requires_grad_(True)
        y = T.filtering.medfilt(x, 5)
        assert np.array_equal(y.detach().numpy(), ss.medfilt(x.detach().numpy(), 5))
        g, = torch.autograd.grad(y.sum(), x)
        counts = np.zeros(128)
        np.add.at(counts, [int(np.flatnonzero(x.detach().numpy() == v)[0])
                           for v in y.detach().numpy() if v != 0], 1)
        assert np.array_equal(g.numpy(), counts)


class TestNamespaceComplete:
    def test_every_advertised_name_is_bound(self):
        missing = [n for n in FL.__all__ if not hasattr(FL, n)]
        assert not missing, missing
        assert FL.__all__ == JF.__all__

    def test_scipy_signal_surface_coverage(self):
        """Every public scipy.signal name has a counterpart in the port's
        modules, as tests/test_filtering.py:568 asks of the JAX package."""
        have = set()
        for mod in (T.fft, T.filtering, T.iirdesign, T.peaks, T.ltisys,
                    T.waveforms, T.splines, T.ndimage, T.windows):
            have |= set(getattr(mod, "__all__", []))
        have |= {"ShortTimeFFT", "windows"}
        missing = [n for n in ss.__all__ if n not in have]
        assert not missing, missing

    def test_scipy_signal_surface_complete(self):
        """tests/test_parity_surface.py's scipy.signal half for the port:
        every public name of the installed scipy.signal is an attribute of
        one of the port's modules."""
        import types
        mods = [T, T.fftapi, T.filtering, T.iirdesign, T.ltisys, T.peaks,
                T.splines, T.waveforms, T.windows, T.shorttime]
        public = [n for n in dir(ss) if not n.startswith("_") and n != "test"
                  and not isinstance(getattr(ss, n), types.ModuleType)]
        missing = [n for n in public if not any(hasattr(m, n) for m in mods)]
        assert not missing, missing

    def test_reexports_are_the_modules_own(self):
        assert FL.butter is T.iirdesign.butter and FL.find_peaks is T.peaks.find_peaks
        assert FL.lsim is T.ltisys.lsim and FL.cspline1d is T.splines.cspline1d


class TestAssociativeIirRoute:
    """The port's parallel prefix against the JAX package's and scipy, and
    the CPU gate flipped."""

    @pytest.mark.parametrize("K,n,batch", [
        (2, 100, 1), (2, 4000, 3), (4, 7000, 2), (3, 3300, 1)])
    def test_assoc_matches_jax_and_scipy(self, rng, K, n, batch):
        b, a = ss.butter(K, 0.25)
        x = rng.standard_normal((batch, n)).astype(np.float32)
        zi = (rng.standard_normal((batch, K)) * 0.1).astype(np.float32)
        y, zf = FL._iir_assoc(b, a, torch.from_numpy(x), torch.from_numpy(zi))
        jy, jzf = JF._iir_assoc(b, a, x, zi)
        assert_close(y.numpy(), np.asarray(jy), 1e-6, "assoc y vs JAX")
        assert_close(zf.numpy(), np.asarray(jzf), 1e-6, "assoc zf vs JAX")
        yref, zref = ss.lfilter(b, a, x, zi=zi)
        scale = max(np.max(np.abs(yref)), 1e-9)
        assert np.max(np.abs(y.numpy() - yref)) / scale < 1e-5
        assert np.max(np.abs(zf.numpy() - zref)) < 1e-5 * max(np.max(np.abs(zref)), 1)

    @pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
    def test_assoc_short_signals(self, rng, n):
        """The odd/even recursion at the lengths where it ends early."""
        b, a = ss.butter(2, 0.3)
        x = rng.standard_normal((2, n)).astype(np.float32)
        zi = rng.standard_normal((2, 2)).astype(np.float32)
        y, zf = FL._iir_assoc(b, a, torch.from_numpy(x), torch.from_numpy(zi))
        yref, zref = ss.lfilter(b, a, x, zi=zi)
        assert_close(y.numpy(), yref, 1e-6, f"n={n} y")
        assert_close(zf.numpy(), zref, 1e-6, f"n={n} zf")

    def test_gated_route_consistency(self, rng, monkeypatch):
        """Flipping the CPU gate routes lfilter through the assoc path with
        unchanged results; the CUDA gate does not apply to CPU tensors."""
        b, a = ss.butter(2, 0.3)
        x = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
        calls = []
        monkeypatch.setattr(FL, "_iir_assoc", lambda *args: calls.append(1) or
                            _assoc(*args))
        monkeypatch.setattr(FL, "IIR_ASSOC_MIN_N_CUDA", 1)
        y_seq = FL.lfilter(b, a, x).numpy()
        assert not calls
        monkeypatch.setattr(FL, "IIR_ASSOC_MIN_N", 64)
        y_assoc = FL.lfilter(b, a, x).numpy()
        assert calls
        scale = max(np.max(np.abs(y_seq)), 1e-9)
        assert np.max(np.abs(y_assoc - y_seq)) / scale < 1e-5

    def test_order_above_the_cap_runs_the_loop(self, rng, monkeypatch):
        """Order 6 in ba form exceeds IIR_ASSOC_MAX_K: the sequential loop
        runs whatever the gate says."""
        b, a = ss.butter(6, 0.2)
        x = torch.from_numpy(rng.standard_normal((2, 300)).astype(np.float32))
        monkeypatch.setattr(FL, "IIR_ASSOC_MIN_N", 1)
        monkeypatch.setattr(FL, "_iir_assoc", None)
        assert_close(FL.lfilter(b, a, x).numpy(), ss.lfilter(b, a, x.numpy()), 2e-4,
                     "order 6")


_assoc = FL._iir_assoc


class TestTorchSpecifics:
    """What the port adds around the JAX package's contract: devices,
    float32 out, the TF32 scope, tensors in."""

    def test_float64_in_float32_out_on_the_input_device(self, rng):
        x = torch.from_numpy(rng.standard_normal((2, 64)))
        b, a = ss.butter(2, 0.3)
        for y in (FL.lfilter(b, a, x), FL.sosfilt(ss.butter(2, 0.3, output="sos"), x),
                  FL.savgol_filter(x, 7, 2), FL.medfilt(x, 3), FL.wiener(x)):
            assert y.dtype == torch.float32 and y.device == x.device

    def test_numpy_goes_to_the_default_device(self):
        with TF.default_device("cpu"):
            y = FL.lfilter([1.0, 0.5], 1.0, np.ones(32))
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"

    def test_tf32_is_off_inside_the_products(self, rng, monkeypatch):
        """The FIR state einsum and the savgol edge rule multiply at full
        float32 whatever the caller set, and the parallel prefix calls no
        matmul at all (broadcast multiply-adds); products of the plan layer,
        which the convolutions call, are tested in test_torch_compose.py."""
        import sys
        seen = []
        real_matmul, real_einsum = torch.matmul, torch.einsum

        def spy(real):
            def f(*args, **kw):
                if sys._getframe(1).f_code.co_filename == FL.__file__:
                    seen.append(torch.backends.cuda.matmul.fp32_precision)
                return real(*args, **kw)
            return f
        monkeypatch.setattr(torch, "matmul", spy(real_matmul))
        monkeypatch.setattr(torch, "einsum", spy(real_einsum))
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
            b, a = ss.butter(2, 0.3)
            FL._iir_assoc(b, a, x, torch.zeros(2, 2))
            assert not seen
            FL.lfilter(ss.firwin(9, 0.3), 1.0, x, zi=np.zeros(8))
            FL.savgol_filter(x, 11, 3)
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert seen and set(seen) == {"ieee"}, seen

    def test_complex_tensor_data(self, rng):
        z = rng.standard_normal(80) + 1j * rng.standard_normal(80)
        b, a = ss.butter(2, 0.4)
        y = FL.lfilter(b, a, torch.from_numpy(z.astype(np.complex64)))
        assert_close_c(TF.ascomplex(y), ss.lfilter(b, a, z), 2e-4, "complex tensor")

    def test_no_tensor_cast_outside_the_facade_helpers(self):
        """User data enters the new modules through ``fftapi._f32`` /
        ``asinterleaved`` and host tables through ``fftapi._const``."""
        import inspect
        import re
        for mod in (T.filtering, T.ltisys, T.splines, T.ndimage):
            src = inspect.getsource(mod)
            assert not re.search(r"torch\.(as_tensor|tensor|from_numpy)\(", src), mod.__name__
