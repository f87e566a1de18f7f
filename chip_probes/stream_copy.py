"""Probe: what a copy that stages through shared memory reaches on the card.

    python3 chip_probes/stream_copy.py      (from the repository root)

Times ``webgpufft_tpu_torch.probes.stream_copy`` (``csrc/probes/stream_copy.cu``)
on a 128 MB array (16384, 2048) and on the headline array (4096, 2048) of f32:
the direct copy at several tile sizes, the ``cp.async`` pipeline and the bulk
copy at 2 and 4 stages and several stage sizes, plain and times a scalar, each
checked bit for bit against ``x.clone()`` / ``x * scale`` first.  Beside them,
in the same process: ``Tensor.copy_``, the elementwise ceiling
``profile.measured_copy_ceiling_gbps`` and the bound at the data sheet's
3.35 TB/s.  The counterpart of ``benches/r12_pallas_dma.py`` and of the copy
experiments of ``benches/r2_perf_experiments.py``.  Needs a GPU.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from webgpufft_tpu_torch.probes import stream  # noqa: E402
from webgpufft_tpu_torch.runtime import profile  # noqa: E402

SHAPES = [(16384, 2048), (4096, 2048)]
SCALE = 1.000001
DIRECT_TILES = [4096, 16384, 65536]
STAGE_BYTES = [8192, 16384, 32768, 49152]


def device_ms(fn):
    return profile.median(profile.time_queued(fn))


def variants():
    for tile in DIRECT_TILES:
        yield dict(mode="direct", stage_bytes=tile)
    for mode in ("cp_async", "bulk"):
        for stages in stream.STAGE_COUNTS:
            for stage_bytes in STAGE_BYTES:
                yield dict(mode=mode, stages=stages, stage_bytes=stage_bytes)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("stream_copy: needs an NVIDIA GPU")
    card = profile.card_line()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in SHAPES:
        x = torch.randn(*shape, device="cuda", generator=gen)
        y = torch.empty_like(x)
        nbytes = 2 * x.numel() * 4
        bound = profile.bound_ms(nbytes, 0.0)[0]
        copy_ms = device_ms(lambda: y.copy_(x))
        mul_ms = device_ms(lambda: torch.mul(x, SCALE, out=y))
        ceiling = profile.measured_copy_ceiling_gbps(x)
        print(f"array {shape} f32, {nbytes / 2e6:.1f} MB each way: bound {bound:.4f} ms, "
              f"Tensor.copy_ {copy_ms:.4f} ms ({nbytes / copy_ms / 1e6:.0f} GB/s), "
              f"torch.mul(x, s, out=y) {mul_ms:.4f} ms, measured_copy_ceiling "
              f"{ceiling:.0f} GB/s [{card}]")
        for kw in variants():
            for scale in (None, SCALE):
                got = stream.stream_copy(x, scale, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, stream.stream_copy_reference(x, scale)):
                    raise AssertionError(f"stream_copy {kw} scale={scale}: not bit-equal")
                del got
                ms = device_ms(lambda: stream.stream_copy(x, scale, **kw))
                what = " ".join(f"{k}={v}" for k, v in kw.items())
                print(f"    {what}{' scaled' if scale else ''}: {ms:.4f} ms "
                      f"({nbytes / ms / 1e6:.0f} GB/s, share of the bound {bound / ms:.2f}, "
                      f"Tensor.copy_ over it {copy_ms / ms:.2f}) [{card}]")


if __name__ == "__main__":
    main()
