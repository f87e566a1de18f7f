"""Filter-design / LTI-control workflow on the PyTorch port's toolboxes.

Port of ``examples/control_toolkit.py``.  Design an anti-aliasing filter
three ways (elliptic IIR via iirdesign, equiripple FIR via remez, Kaiser
via kaiserord), apply them on the device (the SOS recurrence, and FIR
convolutions on the package's kernels), then model a plant
(mass-spring-damper), discretize it, simulate a step and a noisy digital
loop with the device state-space recurrence, and place closed-loop poles
with full-state feedback.

    python -m webgpufft_tpu_torch.examples.control_toolkit            # on the card
    python -m webgpufft_tpu_torch.examples.control_toolkit --device cpu

``run(device)`` returns every intermediate by the name the JAX example's
script gives it, so the two can be held side by side.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import filtering as flt
from .. import ltisys as lts
from ..fftapi import default_device


def run(device="cuda", verbose: bool = True) -> dict:
    """The whole workflow with the signal and the simulations on
    ``device``; returns the named results (numpy where the JAX example's
    are host values, tensors where its are device arrays)."""
    say = print if verbose else (lambda *a, **k: None)
    out = {}
    fs = 2000.0
    rng = np.random.default_rng(0)
    t = np.arange(int(2 * fs)) / fs
    x = (np.sin(2 * np.pi * 50 * t) + 0.7 * np.sin(2 * np.pi * 640 * t)
         + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    with default_device(device):
        # --- 1. three anti-aliasing designs for a 4x decimation (keep < 250 Hz)
        sos = flt.iirdesign(200, 280, gpass=0.5, gstop=60, ftype="ellip",
                            output="sos", fs=fs)
        taps_pm = flt.remez(121, [0, 200, 280, fs / 2], [1, 0], fs=fs)
        n_k, beta = flt.kaiserord(60, width=80 / (fs / 2))
        taps_k = flt.firwin(n_k | 1, 240, window=("kaiser", beta), fs=fs)
        out.update(sos=sos, taps_pm=taps_pm, taps_k=taps_k)
        say(f"designs: ellip sos {sos.shape[0]} sections, remez {taps_pm.size} "
            f"taps, kaiser {taps_k.size} taps")

        # --- 2. apply on the device; the 640 Hz leakage after filtering
        for name, y in [("ellip", flt.sosfiltfilt(sos, x)),
                        ("remez", flt.lfilter(taps_pm, 1.0, x)),
                        ("kaiser", flt.lfilter(taps_k, 1.0, x))]:
            out[f"y_{name}"] = y
            yh = y.detach().cpu().numpy()
            Y = np.fft.rfft(yh * np.hanning(yh.shape[-1]))
            f = np.fft.rfftfreq(yh.shape[-1], 1 / fs)
            leak = np.abs(Y[np.argmin(np.abs(f - 640))])
            keep = np.abs(Y[np.argmin(np.abs(f - 50))])
            say(f"  {name:6s}: 640 Hz suppressed {20 * np.log10(leak / keep):7.1f} dB"
                f" relative to the 50 Hz passband tone")

        # --- 3. a plant: mass-spring-damper  x'' + 0.4 x' + 4 x = u
        A = np.array([[0.0, 1.0], [-4.0, -0.4]])
        B = np.array([[0.0], [1.0]])
        C = np.array([[1.0, 0.0]])
        D = np.array([[0.0]])
        plant = lts.lti(A, B, C, D)
        w, mag, phase = plant.bode(n=64)
        out.update(w=w, mag=mag, phase=phase)
        say(f"plant resonance ~{w[np.argmax(mag)]:.2f} rad/s ({np.max(mag):.1f} dB peak)")

        # open-loop step (the device state-space recurrence under the hood)
        T = np.linspace(0, 20, 600)
        _, y_open = plant.step(T=T)
        out["y_open"] = y_open
        say(f"open-loop step: overshoot {np.max(y_open) / 0.25:.2f}x of the dc gain")

        # --- 4. full-state feedback: place the closed-loop poles
        fsf = lts.place_poles(A, B, [-2.0 + 1.0j, -2.0 - 1.0j])
        K = fsf.gain_matrix
        Acl = A - B @ K
        out.update(K=K, computed_poles=fsf.computed_poles)
        say(f"placed poles: {np.sort_complex(fsf.computed_poles)} "
            f"(rtol {fsf.rtol:.1e}), K = {K.ravel()}")
        _, y_closed = lts.lti(Acl, B, C, D).step(T=T)
        out["y_closed"] = y_closed
        say(f"closed-loop step settles to {float(y_closed[-1]):.4f} "
            f"with max {float(np.max(y_closed)):.4f}")

        # --- 5. discretize and simulate a noisy digital loop at 50 Hz
        dsys = lts.lti(Acl, B, C, D).to_discrete(0.02, method="zoh").to_ss()
        u = np.ones(300) + 0.05 * rng.standard_normal(300)
        td, yd, xd = lts.dlsim((dsys.A, dsys.B, dsys.C, dsys.D, dsys.dt), u)
        out.update(yd=yd, xd=xd)
        say(f"digital loop: {yd.shape[0]} steps, final output {float(yd[-1, 0]):.4f}")
    say("control_toolkit example OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args().device)
