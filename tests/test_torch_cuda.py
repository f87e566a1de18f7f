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
    (1000, 33, "inverse"), (2310, 16, "forward"), (16384, 3, "inverse"), (4, 9, "forward"),
    # the radix chain's corners: every odd radix, 13 * 13 * 8, all-16 and
    # all-3 chains, one- and two-butterfly lines, a ragged last CTA, chains
    # that need the 1024-thread kernel, and the small digits 8 * 8 and 8 * 16
    # at the line counts of a rank > 1 plan
    (4096, 5, "inverse"), (1352, 11, "forward"), (16, 1001, "forward"), (6, 77, "inverse"),
    (121, 50, "forward"), (14641, 2, "forward"), (15360, 2, "inverse"), (6561, 3, "forward"),
    (8192, 3, "inverse"), (256, 1537, "forward"), (64, 8192, "forward"), (128, 8192, "inverse")])
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
    (2, 16384, 4), (2, 2048, 66),
    # tall tiles at the shared-memory limit, ragged column counts (33, 65),
    # every odd radix, one-butterfly heights, and the small-digit views
    # 8 * 16 and 8 * 8 inside rank > 1 geometry
    (8, 16384, 64), (3, 2310, 66), (2, 1352, 130), (5, 121, 256), (3, 14641, 2),
    (2, 13, 70), (3, 16, 512), (2, 4096, 66), (384, 128, 512), (64, 64, 128)])
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
                          {**lt, "cw": lt["cw"].cpu()})
    with pytest.raises(ValueError, match="table"):
        fused_cols.fused_cols(torch.zeros(2, 256, 8, device=cuda_device),
                              {**ct, "cp": ct["cp"][:1]})
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


def _rfft_dims(rank):
    """torch.fft.rfftn halves the last dim it is given: list logical axis 0
    (array dim 1) last to pack it as the plans do."""
    return tuple(range(2, 1 + rank)) + (1,)


@pytest.mark.parametrize("shape,kernels", [
    ([64, 64, 64], False),      # digits 8 x 8: the rank > 1 rule keeps every axis off K1/K2
    ([64, 256, 256], True),     # body and Nyquist axis 1 on K2, axis 2 on K1
    ([9, 256, 256], True),      # odd n0: the widened plan
])
def test_real_plans_on_gpu_match_torch_fft(shape, kernels, cuda_device):
    batch, dims = 3, _rfft_dims(len(shape))
    fwd = T.create_plan({"type": "r2c", "shape": shape, "batch": batch},
                        device=cuda_device, cache=T.PlanCache())
    inv = T.create_plan({"type": "c2r", "shape": shape, "batch": batch,
                         "direction": "inverse", "normalize": "backward"},
                        device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(batch, *shape, device=cuda_device, generator=gen)
    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    y = fwd(x)
    back = inv(y)
    torch.cuda.synchronize()
    launched = (fused.fused_lines.launches - before[0], fused_cols.fused_cols.launches - before[1])
    assert (min(launched) > 0) == kernels, (launched, fwd.route.reasons)
    want = torch.fft.rfftn(x, dim=dims)
    assert_close(y.cpu(), torch.view_as_real(want).cpu(), label=f"r2c {shape}")
    assert_close(back.cpu(), x.cpu(), label=f"c2r(r2c) {shape}")
    assert_close(inv(torch.view_as_real(want).contiguous()).cpu(),
                 torch.fft.irfftn(want, s=shape[1:] + shape[:1], dim=dims).cpu(),
                 label=f"c2r {shape}")


@pytest.mark.parametrize("shape,batch,tuning,kind", [
    ([4093], 4, {}, "rader"), ([101, 256], 2, {}, "rader"),
    ([4099], 4, {}, "bluestein"), ([323], 8, {}, "bluestein"),
    ([65536], 2, {}, "four-step"), ([8192], 2, {"fourStepMinN": 4096}, "four-step"),
    ([4096, 4], 1, {"fourStepMinN": 4096}, "four-step")])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_axis_kinds_on_gpu_match_torch_fft(shape, batch, tuning, kind, direction,
                                           cuda_device):
    plan = T.create_plan({"type": "c2c", "shape": shape, "batch": batch,
                          "direction": direction, "normalize": "backward",
                          "tuning": tuning}, device=cuda_device, cache=T.PlanCache())
    assert kind in plan.route.axis_kinds or plan.route.mode == "four-step-hbm"
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(batch, *shape, 2, device=cuda_device, generator=gen)
    y = plan(x)
    dims = tuple(range(1, 1 + len(shape)))
    z = torch.view_as_complex(x)
    want = torch.fft.fftn(z, dim=dims) if direction == "forward" else torch.fft.ifftn(z, dim=dims)
    assert_close(y.cpu(), torch.view_as_real(want).cpu(), label=f"{kind} {shape}")


def test_ns3d_step_on_gpu_matches_torch_fft_step(cuda_device):
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    n, nu, dt = 64, 2e-2, 1e-2
    step, to_s, to_p = ns.make_stepper3(n, nu, dt, device=cuda_device)
    fstep, _, _ = ns.make_torch_fft_stepper3(n, nu, dt, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    u_hat = to_s(0.1 * torch.randn(3, n, n, n, device=cuda_device, generator=gen))
    assert_close(step(u_hat).cpu(), fstep(u_hat).cpu(), label="NS-3D step 64^3")
    tg = ns.taylor_green_embedded(n, 0.0, nu, device=cuda_device)
    got = ns.run3(tg, n, nu, dt, 4, device=cuda_device)
    assert_close(got.cpu(), ns.taylor_green_embedded(n, 4 * dt, nu, device=cuda_device).cpu(),
                 label="Taylor-Green 64^3")
