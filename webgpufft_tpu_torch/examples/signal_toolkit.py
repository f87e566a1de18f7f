"""Signal-analysis workflow on the port's scipy.signal facade.

Port of ``examples/signal_toolkit.py``: a linear chirp buried in noise,
located with a spectrogram, its noise floor estimated with Welch, a narrow
band inspected with ``zoom_fft``, its envelope measured with ``hilbert``,
and denoised by stft -> threshold -> istft.  The transforms run on the
facade's device; the host steps between them are the JAX script's own.

    python -m webgpufft_tpu_torch.examples.signal_toolkit            # on the card
    python -m webgpufft_tpu_torch.examples.signal_toolkit --device cpu

``run(device)`` returns every result by the name the JAX script gives it.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import fftapi as wfft
from ..fftapi import _to_numpy as host


def run(device="cuda", verbose: bool = True) -> dict:
    say = print if verbose else (lambda *a, **k: None)
    fs = 8000.0
    t = np.arange(4 * int(fs)) / fs
    chirp = np.sin(2 * np.pi * (300 + 200 * t / t[-1]) * t)   # inst. freq 300 -> 700 Hz
    rng = np.random.default_rng(0)
    x = (chirp + 0.8 * rng.standard_normal(t.size)).astype(np.float32)
    with wfft.default_device(device):
        # 1. where is the energy? (per-segment PSD)
        f, tt, S = wfft.spectrogram(x, fs=fs, nperseg=512)
        S = host(S)
        ridge = f[np.argmax(S, axis=0)]
        say(f"spectrogram: {S.shape[1]} frames; ridge {ridge[2]:.0f} Hz -> "
            f"{ridge[-3]:.0f} Hz (chirp 300 -> ~700)")

        # 2. average spectrum + noise floor
        f, P = wfft.welch(x, fs=fs, nperseg=1024)
        P = host(P)
        say(f"welch: peak at {f[np.argmax(P)]:.0f} Hz, floor {np.median(P):.2e} V^2/Hz")

        # 3. zoom into the band of interest with m dense bins
        zf = wfft.ascomplex(wfft.zoom_fft(x[:8192], [250 / (fs / 2), 750 / (fs / 2)], m=256))
        say(f"zoom_fft: 256 bins over 250-750 Hz, peak |X| {np.abs(zf).max():.1f}")

        # 4. envelope via the analytic signal
        env = host(wfft.hilbert(x[:4096]))
        amp = np.sqrt(env[..., 0] ** 2 + env[..., 1] ** 2)
        say(f"hilbert envelope mean {amp.mean():.2f} (signal+noise RMS)")

        # 5. denoise: stft -> magnitude threshold -> istft
        f, tt, Z = wfft.stft(x, fs=fs, nperseg=512, noverlap=384)
        Z = host(Z)
        mag = np.sqrt(Z[..., 0] ** 2 + Z[..., 1] ** 2)
        gate = (mag > 3 * np.median(mag))[..., None]
        _, clean = wfft.istft(Z * gate, fs=fs, nperseg=512, noverlap=384)
        clean = host(clean)[: x.size]
    noise_in = np.mean((x - chirp) ** 2)
    noise_out = np.mean((clean - chirp) ** 2)
    say(f"stft denoise: residual noise power {noise_in:.3f} -> {noise_out:.3f} "
        f"({10 * np.log10(noise_in / noise_out):.1f} dB gain)")
    return {"fs": fs, "t": t, "chirp": chirp, "x": x, "f": f, "tt": tt, "S": S,
            "ridge": ridge, "P": P, "zf": zf, "env": env, "amp": amp, "Z": Z,
            "mag": mag, "gate": gate, "clean": clean, "noise_in": noise_in,
            "noise_out": noise_out}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
