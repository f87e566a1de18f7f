"""The port's control-toolkit example
(webgpufft_tpu_torch/examples/control_toolkit.py) against the JAX package's
(examples/control_toolkit.py), run as its script: the same designs (equal:
the same float64 host code), the same filtered signals and simulations
(1e-5 of max|JAX result|, the bar of the recurrences in
tests/test_torch_filtering.py and tests/test_torch_ltisys.py)."""

import os
import runpy

import numpy as np
import pytest

from webgpufft_tpu import filtering as JF
from webgpufft_tpu_torch.examples import control_toolkit
from torch_port_support import close, same

EXAMPLE = os.path.join(os.path.dirname(__file__), os.pardir, "examples", "control_toolkit.py")


@pytest.fixture(scope="module")
def both():
    ref = runpy.run_path(EXAMPLE, run_name="__main__")
    return control_toolkit.run("cpu", verbose=False), ref


@pytest.mark.parametrize("name", ["sos", "taps_pm", "taps_k", "w", "mag", "phase", "K",
                                  "computed_poles"])
def test_designs_and_host_results_are_equal(both, name):
    port, ref = both
    jname = {"computed_poles": "fsf"}.get(name, name)
    want = ref[jname].computed_poles if name == "computed_poles" else ref[jname]
    same(port[name], want, name)


@pytest.mark.parametrize("name", ["y_open", "y_closed", "yd", "xd"])
def test_simulations_agree(both, name):
    port, ref = both
    close(port[name], ref[name], 1e-5, name)


@pytest.mark.parametrize("name,apply", [
    ("y_ellip", lambda r: JF.sosfiltfilt(r["sos"], r["x"])),
    ("y_remez", lambda r: JF.lfilter(r["taps_pm"], 1.0, r["x"])),
    ("y_kaiser", lambda r: r["y"])])
def test_filtered_signals_agree(both, name, apply):
    port, ref = both
    close(port[name], np.asarray(apply(ref)), 1e-5, name)
