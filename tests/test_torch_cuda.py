"""GPU-only tests of the PyTorch port: the CUDA kernels against their plain
torch versions, and c2c plans on the card against ``torch.fft``.

This file imports torch only (no JAX), so it runs where the JAX package is
absent.  On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Elsewhere every test skips (see torch_port_support.cuda_device).
Tolerance: 1e-5 * max|expected|.
"""

import math

import pytest
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.core import fused, fused_cols
from torch_port_support import assert_close, cuda_device  # noqa: F401 (fixture)

pytestmark = pytest.mark.cuda


def _dev_tables(consts, device):
    return {k.rsplit("/", 1)[1]: torch.as_tensor(v, device=device)
            for k, v in consts.items()}


@pytest.mark.parametrize("n,lines,direction", [
    (1024, 512, "forward"), (2048, 64, "inverse"), (360, 64, "forward"),
    (1000, 33, "inverse"), (2310, 16, "forward"), (16384, 3, "inverse"), (4, 9, "forward")])
def test_fused_lines_kernel_matches_plain(n, lines, direction, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 1
    assert_close(y.cpu(), fused.fused_lines_reference(x, t).cpu(), label=f"K1 n={n}")


@pytest.mark.parametrize("pre,h,lanes", [
    (4, 256, 512), (1, 256, 8192), (3, 360, 130), (2, 7, 128), (2, 16, 6),
    (2, 16384, 4), (2, 2048, 66)])
def test_fused_cols_kernel_matches_plain(pre, h, lanes, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    t = _dev_tables(fused_cols.cols_consts(h, "inverse", 1.0 / h, "p"), cuda_device)
    x = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    before = fused_cols.fused_cols.launches
    y = fused_cols.fused_cols(x, t)
    torch.cuda.synchronize()
    assert fused_cols.fused_cols.launches == before + 1
    assert_close(y.cpu(), fused_cols.fused_cols_reference(x, t).cpu(),
                 label=f"K2 ({pre}, {h}, {lanes})")


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    lt = _dev_tables(fused.lines_consts(256, "forward", 1.0, "p"), cuda_device)
    ct = _dev_tables(fused_cols.cols_consts(256, "forward", 1.0, "p"), cuda_device)
    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    bad_lines = [
        torch.zeros(8, 2, 256, device=cuda_device).transpose(1, 2),  # not contiguous
        torch.zeros(8, 256, 2, device=cuda_device, dtype=torch.float64),
        torch.zeros(8, 128, 2, device=cuda_device),                   # wrong N
    ]
    for x in bad_lines:
        with pytest.raises(ValueError):
            fused.fused_lines(x, lt)
    with pytest.raises(ValueError, match="table"):
        fused.fused_lines(torch.zeros(8, 256, 2, device=cuda_device),
                          {**lt, "f1re": lt["f1re"].cpu()})
    with pytest.raises(ValueError):
        fused_cols.fused_cols(torch.zeros(2, 256, 7, device=cuda_device), ct)  # odd L
    assert (fused.fused_lines.launches, fused_cols.fused_cols.launches) == before


@pytest.mark.parametrize("shape,batch,mode", [
    ([1024], 16, "pallas-fused"), ([256, 256], 2, "pallas-fused"),
    ([16, 256, 256], 1, "pallas-mixed"), ([12, 18], 3, "xla")])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_plan_on_gpu_matches_cpu_plan_and_torch_fft(shape, batch, mode, direction,
                                                   cuda_device):
    opts = {"type": "c2c", "shape": shape, "batch": batch, "direction": direction,
            "normalize": "unitary"}
    plan = T.create_plan(opts, device=cuda_device, cache=T.PlanCache())
    assert plan.route.mode == mode, plan.route.reasons
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(batch, *shape, 2, device=cuda_device, generator=gen)
    y = plan(x)
    assert y.device == x.device and y.dtype == torch.float32
    dims = tuple(range(1, 1 + len(shape)))
    z = torch.view_as_complex(x)
    want = (torch.fft.fftn(z, dim=dims, norm="ortho") if direction == "forward"
            else torch.fft.ifftn(z, dim=dims, norm="ortho"))
    assert_close(y.cpu(), torch.view_as_real(want).cpu(), label=f"{shape} vs torch.fft")
    cpu_plan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert_close(y.cpu(), cpu_plan(x.cpu()), label=f"{shape} cuda vs cpu")


def test_plan_rejects_input_on_another_device(cuda_device):
    plan = T.create_plan({"type": "c2c", "shape": [64], "batch": 8},
                         device=cuda_device, cache=T.PlanCache())
    with pytest.raises(T.PlanError, match="plan is on"):
        plan(torch.zeros(8, 64, 2))
