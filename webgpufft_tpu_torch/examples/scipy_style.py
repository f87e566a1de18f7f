"""numpy/scipy-style use of the port through its functional facade.

Port of ``examples/scipy_style.py``: numpy norm conventions, packed real
spectra, a frequency-domain low-pass, orthonormal DCT, scipy.signal-style
FFT convolution and short-time analysis, each call a cached plan on the
facade's device.

    python -m webgpufft_tpu_torch.examples.scipy_style            # on the card
    python -m webgpufft_tpu_torch.examples.scipy_style --device cpu

``run(device)`` returns every result by the name the JAX script gives it
(the globals ``runpy.run_path`` returns for that script).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import fftapi as wfft
from ..fftapi import _to_numpy as host


def run(device="cuda", verbose: bool = True) -> dict:
    say = print if verbose else (lambda *a, **k: None)
    rng = np.random.default_rng(0)
    with wfft.default_device(device):
        # --- complex spectra: numpy norm conventions
        z = rng.standard_normal((8, 1024)) + 1j * rng.standard_normal((8, 1024))
        Y = wfft.fft(z, norm="ortho")                 # interleaved (..., 2) out
        back = wfft.ascomplex(wfft.ifft(Y, norm="ortho"))
        say("fft/ifft ortho roundtrip err:", np.max(np.abs(back - z)))

        # --- real transforms: packed half-spectra
        x = rng.standard_normal((4, 256, 256)).astype(np.float32)
        spec = wfft.rfft2(x)                          # (..., 256, 129, 2)
        x2 = wfft.irfft2(spec)
        say("rfft2/irfft2 roundtrip err:", np.max(np.abs(host(x2) - x)))

        # --- low-pass filter in the frequency domain (the mask on the
        # spectrum's device)
        keep = 24
        mask = np.zeros((256, 129), np.float32)
        mask[:keep, :keep] = 1
        mask[-keep:, :keep] = 1
        filtered = wfft.irfft2(spec * torch.from_numpy(mask).to(spec.device)[..., None])
        say("low-pass output shape:", tuple(filtered.shape))

        # --- scipy.fft DCT with orthonormal weights
        c = wfft.dct(x, type=2, norm="ortho", axis=-1)
        x3 = wfft.idct(c, type=2, norm="ortho", axis=-1)
        say("dct-II ortho roundtrip err:", np.max(np.abs(host(x3) - x)))

        # --- scipy.signal-style FFT convolution
        sig = rng.standard_normal((16, 4096)).astype(np.float32)
        kern = np.blackman(129).astype(np.float32)[None, :]
        sm = wfft.fftconvolve(sig, kern, mode="same", axes=(1,))
        say("fftconvolve same output:", tuple(sm.shape))

        say("next_fast_len(1000) ->", wfft.next_fast_len(1000))

        # --- short-time Fourier analysis (scipy.signal semantics)
        tone = (np.sin(2 * np.pi * 440 * np.arange(16000) / 8000)
                + 0.05 * rng.standard_normal(16000)).astype(np.float32)
        f, t, Z = wfft.stft(tone, fs=8000.0, nperseg=512, noverlap=384)
        peak = f[np.argmax(np.mean(np.abs(wfft.ascomplex(Z)), axis=1))]
        _, back = wfft.istft(Z, fs=8000.0, nperseg=512, noverlap=384)
        say(f"stft grid {tuple(Z.shape[:-1])}, dominant bin {peak:.0f} Hz, "
            f"istft roundtrip err {np.max(np.abs(host(back)[:16000] - tone)):.2e}")
    return {"z": z, "Y": Y, "back": back, "x": x, "spec": spec, "x2": x2, "keep": keep,
            "mask": mask, "filtered": filtered, "c": c, "x3": x3, "sig": sig,
            "kern": kern, "sm": sm, "tone": tone, "f": f, "t": t, "Z": Z, "peak": peak}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
