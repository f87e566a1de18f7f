"""2-D Gaussian blur through the fftconv plan (``linear-same`` boundary).

Port of ``examples/image_blur_fftconv.py``: a random 128 x 128 image and a
9 x 9 Gaussian, interleaved on the host (``interleave``) and moved onto the
plan's device.

    python -m webgpufft_tpu_torch.examples.image_blur_fftconv            # on the card
    python -m webgpufft_tpu_torch.examples.image_blur_fftconv --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import create_plan, interleave, uninterleave


def gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    ax = np.arange(k) - (k - 1) / 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def run(device="cuda", h: int = 128, w: int = 128, k: int = 9,
        verbose: bool = True) -> dict:
    """The JAX example on ``device``; returns the image, kernel, the plan's
    interleaved output and the blurred image (numpy)."""
    rng = np.random.default_rng(0)
    img = rng.random((1, h, w)).astype(np.float32)
    plan = create_plan({"type": "fftconv", "shape": [h, w], "batch": 1,
                        "fftConv": {"boundary": "linear-same", "kernelShape": [k, k]}},
                       device=device)
    kern = gaussian_kernel(k, 2.0)
    out = plan.exec(torch.from_numpy(interleave(img.astype(np.complex64))).to(plan.device),
                    kernel=torch.from_numpy(interleave(kern.astype(np.complex64))).to(plan.device))
    blurred = uninterleave(out.cpu().numpy()).real[0]
    assert blurred.shape == (h, w)
    assert blurred.std() < img[0].std()  # blurring reduces variance
    if verbose:
        print(f"std before={img[0].std():.4f} after={blurred.std():.4f}")
    return {"img": img, "kern": kern, "out": out, "blurred": blurred}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
