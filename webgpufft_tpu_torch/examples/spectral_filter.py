"""Frequency-domain low-pass filtering with r2c -> mask -> c2r plans.

Port of ``examples/spectral_filter.py``: a slow tone under high-frequency
noise, its half spectrum masked above bin 20 on the plans' device, and the
filtered signal back through the c2r plan.

    python -m webgpufft_tpu_torch.examples.spectral_filter            # on the card
    python -m webgpufft_tpu_torch.examples.spectral_filter --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import create_plan


def make_filter(n: int, batch: int, cutoff: int, device="cuda"):
    """``lowpass(x)``: (batch, n) real -> (batch, n) with every bin above
    ``cutoff`` zeroed, through one r2c plan, a mask on the plans' device and
    one c2r plan (backward-normalized)."""
    fwd = create_plan({"type": "r2c", "shape": [n], "direction": "forward",
                       "batch": batch}, device=device)
    inv = create_plan({"type": "c2r", "shape": [n], "direction": "inverse",
                       "normalize": "backward", "batch": batch}, device=device)
    mask = (torch.arange(n // 2 + 1, device=fwd.device) <= cutoff).float()[None, :, None]

    def lowpass(x):
        return inv(fwd(x) * mask)
    return lowpass


def run(device="cuda", n: int = 1024, batch: int = 8, verbose: bool = True) -> dict:
    """The JAX example on ``device``; returns its signal, filtered output
    and the residual noise before and after."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, n, endpoint=False)
    tone = np.sin(2 * np.pi * 5 * t)
    x = (tone[None, :] + 0.5 * rng.standard_normal((batch, n))).astype(np.float32)
    lowpass = make_filter(n, batch, 20, device)
    filtered = lowpass(torch.from_numpy(x).to(device))
    noise_before = float(np.std(x - tone))
    noise_after = float(np.std(filtered.cpu().numpy() - tone))
    if verbose:
        print(f"residual noise: before={noise_before:.3f} after={noise_after:.3f}")
    assert noise_after < noise_before / 3
    return {"x": x, "filtered": filtered, "noise_before": noise_before,
            "noise_after": noise_after}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
