"""GPU-only tests of the PyTorch port: the CUDA kernels against their plain
torch versions, and every plan type and the staging pipeline on the card
against ``torch.fft`` or float64 torch.

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
from webgpufft_tpu_torch import probes
from webgpufft_tpu_torch.core import fused, fused_cols
from torch_port_support import (assert_close, cuda_device,  # noqa: F401 (fixture)
                                torch_fft_stepper3)

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
    (8192, 3, "inverse"), (256, 1537, "forward"), (64, 8192, "forward"), (128, 8192, "inverse"),
    # what the dct, fftconv and overlap-save paths give K1, and the one-butterfly
    # last axes of small rank > 1 plans
    (512, 4096, "forward"), (1024, 8192, "inverse"), (8192, 131, "forward"),
    (256, 8, "inverse"), (8, 16, "forward"), (15, 8, "inverse"), (12, 6, "forward")])
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
    (2, 13, 70), (3, 16, 512), (2, 4096, 66), (384, 128, 512), (64, 64, 128),
    # the views of the dct and fftconv paths, axis 0 of a 256^3 r2c plan, and
    # the short heights a small axis 0 gives now that no digit rule holds
    (8, 512, 1024), (1, 1024, 2048), (3, 128, 131072), (8, 3, 512), (8, 9, 512),
    (4, 6, 202), (2, 4, 128)])
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


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


LINE_COUNTS = {"one": lambda g: 1, "sms-1": lambda g: g - 1, "sms+1": lambda g: g + 1,
               "2sms+7": lambda g: 2 * g + 7}


@pytest.mark.parametrize("count", sorted(LINE_COUNTS))
@pytest.mark.parametrize("n", [2048, 2079, 4096, 8192, 16384])
def test_long_lines_forward_adjoint_in_place(n, count, cuda_device):
    """K1 from N = 2048 on (2079 = 3^3 * 7 * 11 is odd: its odd lines are not
    16-byte aligned; from 6144 on one CTA fills an SM), at line counts
    around the SM count: one line, an SM count but one, an SM count and
    one, two and a ragged seven."""
    lines = LINE_COUNTS[count](_sms())
    gen = torch.Generator(device=cuda_device).manual_seed(n + lines)
    t = _dev_tables(fused.lines_consts(n, "forward", 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    before = fused.fused_lines.launches
    y = fused.fused_lines(x, t)
    ya = fused.fused_lines(x, t, adjoint=True)
    z = probes.lines_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 3
    want = fused.fused_lines_reference(x, t).cpu()
    assert_close(y.cpu(), want, label=f"K1 n={n} lines={lines}")
    assert_close(ya.cpu(), fused.fused_lines_reference(x, t, adjoint=True).cpu(),
                 label=f"K1 n={n} lines={lines} adjoint")
    assert_close(z.cpu(), want, label=f"K1 n={n} lines={lines} in place")


@pytest.mark.parametrize("view", ["odd columns", "narrow", "one pre"])
@pytest.mark.parametrize("h", [512, 1024, 2048])
def test_tall_tiles_forward_adjoint_in_place(h, view, cuda_device):
    """K2 at heights whose tiles reach 8192 points, in the design its entry
    point takes: 33 columns (a 264-byte row pitch, not 16-byte aligned: the
    8-byte copies, and a ragged last tile) over two grids and a ragged seven
    of tiles, 5 columns (a tile narrower than 16), and one pre index."""
    cols = {"odd columns": 33, "narrow": 5, "one pre": 1024}[view]
    grid, tile = fused_cols.launch_shape(h, cols)
    assert grid > 0 or view == "narrow", (h, cols)   # 5 columns: the direct tile
    tiles = -(-cols // tile)
    pre = 1 if view == "one pre" else -(-(2 * (grid or _sms()) + 7) // tiles)
    gen = torch.Generator(device=cuda_device).manual_seed(h + cols)
    t = _dev_tables(fused_cols.cols_consts(h, "inverse", 1.0 / h, "p"), cuda_device)
    x = torch.randn(pre, h, 2 * cols, device=cuda_device, generator=gen)
    before = fused_cols.fused_cols.launches
    y = fused_cols.fused_cols(x, t)
    ya = fused_cols.fused_cols(x, t, adjoint=True)
    z = probes.cols_inplace(x.clone(), t)
    torch.cuda.synchronize()
    assert fused_cols.fused_cols.launches == before + 3
    want = fused_cols.fused_cols_reference(x, t).cpu()
    assert_close(y.cpu(), want, label=f"K2 ({pre}, {h}, {2 * cols})")
    assert_close(ya.cpu(), fused_cols.fused_cols_reference(x, t, adjoint=True).cpu(),
                 label=f"K2 ({pre}, {h}, {2 * cols}) adjoint")
    assert_close(z.cpu(), want, label=f"K2 ({pre}, {h}, {2 * cols}) in place")


def test_ring_launches_after_a_smaller_stage_of_the_same_kernel(cuda_device):
    """H = 768 and 640 (16 * 16 * 3, 16 * 8 * 5) run the same ring kernel
    with stages of 12,288 and 10,240 points: the launch after the smaller
    one still has the shared memory its larger stages need."""
    for h in (768, 640, 768):
        gen = torch.Generator(device=cuda_device).manual_seed(h)
        t = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0, "p"), cuda_device)
        x = torch.randn(3, h, 66, device=cuda_device, generator=gen)
        assert fused_cols.launch_shape(h, 33)[0] > 0, h
        assert_close(fused_cols.fused_cols(x, t).cpu(),
                     fused_cols.fused_cols_reference(x, t).cpu(), label=f"K2 ring H={h}")


@pytest.mark.parametrize("design", ["direct", "ring", "ring-async"])
@pytest.mark.parametrize("pre,h,lanes", [(8, 1024, 2048), (3, 2048, 64), (5, 512, 1024)])
def test_every_cols_design_matches_plain(pre, h, lanes, design, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    t = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0, "p"), cuda_device)
    x = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    for adjoint in (False, True):
        y = probes.cols_variant(x, t, design, adjoint=adjoint)
        assert_close(y.cpu(), fused_cols.fused_cols_reference(x, t, adjoint).cpu(),
                     label=f"K2 {design} ({pre}, {h}, {lanes}) adjoint={adjoint}")


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
    ([16, 256, 256], 1, "pallas-fused"), ([12, 18], 3, "pallas-mixed"),
    ([4, 4, 4], 2, "pallas-mixed"), ([6, 101], 2, "pallas-mixed"), ([7, 9], 1, "xla")])
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
    ([64, 64, 64], True),       # digits 8 x 8 and 4 x 8 (the half axis 0): all on K1/K2
    ([64, 256, 256], True),     # body and Nyquist axis 1 on K2, axis 2 on K1
    ([9, 256, 256], True),      # odd n0: the widened plan
    ([6, 256], True),           # half axis 0 of 3: a one-butterfly K2
    ([34, 6], False),           # half axis 0 of 17 and 2 Nyquist lines: K1 only
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
    assert kind in plan.route.axis_kinds or any("xla-four-step" in r for r in plan.route.reasons)
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
    fstep, _, _ = torch_fft_stepper3(n, nu, dt, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    u_hat = to_s(0.1 * torch.randn(3, n, n, n, device=cuda_device, generator=gen))
    assert_close(step(u_hat).cpu(), fstep(u_hat).cpu(), label="NS-3D step 64^3")
    tg = ns.taylor_green_embedded(n, 0.0, nu, device=cuda_device)
    got = ns.run3(tg, n, nu, dt, 4, device=cuda_device)
    assert_close(got.cpu(), ns.taylor_green_embedded(n, 4 * dt, nu, device=cuda_device).cpu(),
                 label="Taylor-Green 64^3")


# ---------------------------------------------------------------------------
# DCT/DST, fftconv, conv2d and the staging pipeline on the card
# ---------------------------------------------------------------------------

def _launched(fn):
    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, (fused.fused_lines.launches - before[0],
                 fused_cols.fused_cols.launches - before[1])


def _trig_oracle(x, shape, kind, direction):
    """Dense trig matrices in float64 on the card."""
    from webgpufft_tpu_torch.utils import mathref
    y = x.double()
    for d, n in enumerate(shape):
        mdir = "forward" if kind[-1] in "14" else direction
        m = torch.as_tensor(mathref.trig_matrix(kind, n, mdir), device=x.device)
        y = torch.movedim(torch.movedim(y, 1 + d, -1) @ m.T, -1, 1 + d)
    return y


@pytest.mark.parametrize("kind", ["dct1", "dct2", "dct3", "dct4", "dst1", "dst2", "dst3", "dst4"])
@pytest.mark.parametrize("shape,batch,want", [
    ((512, 512), 2, (1, 1)),        # K2 on (2, m, 2 * 512), K1 on 1024 lines of m
    ((16, 512, 64), 1, (0, 1)),     # a mid axis on K2, matmul axes around it
    ((8, 8), 64, (0, 0)),           # the matmul route
])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_dct_on_gpu_matches_float64(kind, shape, batch, want, direction, cuda_device):
    plan = T.create_plan({"type": kind, "shape": list(shape), "batch": batch,
                          "direction": direction}, device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(batch, *shape, device=cuda_device, generator=gen)
    y, made = _launched(lambda: plan(x))
    if kind in ("dct1", "dst1") and 512 in shape:
        # work lengths 1022 = 2 * 7 * 73 and 1026 = 2 * 3^3 * 19: Bluestein
        assert made == (0, 0), (made, plan.route.reasons)
    else:
        assert made == want, (made, plan.route.reasons)
    assert_close(y.cpu(), _trig_oracle(x, shape, kind, direction).cpu(),
                 label=f"{kind}{shape} {direction}")


def _torch_fft_conv(x, k, shape, kshape, boundary, mode="convolution"):
    from webgpufft_tpu_torch.utils import mathref
    fft_shape, out_shape, out_off = mathref.fftconv_out_shape(shape, kshape, boundary)
    dims = tuple(range(1, x.ndim))
    kf = torch.fft.fftn(k.to(torch.complex128), s=fft_shape)
    if mode == "correlation":
        kf = kf.conj()
    y = torch.fft.ifftn(torch.fft.fftn(x.to(torch.complex128), s=fft_shape, dim=dims) * kf,
                        dim=dims)
    return y[(slice(None),) + tuple(slice(o, o + n) for o, n in zip(out_off, out_shape))]


@pytest.mark.parametrize("shape,kshape,batch,boundary,mode,want", [
    ([1000, 1000], [25, 25], 2, "linear-same", "convolution", (3, 3)),
    ([1000, 1000], [25, 25], 2, "linear-full", "correlation", (3, 3)),
    ([60, 250], [5, 7], 8, "linear-full", "convolution", (3, 3)),      # fft shape (64, 256)
    ([256], [9], 8, "circular", "convolution", (2, 0)),                 # the lone kernel: einsum
    ([12, 10], [3, 3], 2, "linear-valid", "convolution", (3, 0)),       # 20 lanes: no K2
])
def test_fftconv_on_gpu_matches_torch_fft(shape, kshape, batch, boundary, mode, want,
                                          cuda_device):
    plan = T.create_plan({"type": "fftconv", "shape": shape, "batch": batch,
                          "fftConv": {"kernelShape": kshape, "boundary": boundary,
                                      "mode": mode}}, device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(batch, *shape, 2, device=cuda_device, generator=gen)
    k = torch.randn(*kshape, 2, device=cuda_device, generator=gen)
    y, made = _launched(lambda: plan(x, kernel=k))
    assert made == want, (made, plan.route.reasons)
    ref = _torch_fft_conv(torch.view_as_complex(x), torch.view_as_complex(k), shape, kshape,
                          boundary, mode)
    assert_close(y.cpu(), torch.view_as_real(ref).cpu(), label=f"fftconv {shape} {boundary}")


def test_fftconv_multi_kernel_lanes_on_gpu(cuda_device):
    """Channel-lane gather and scatter with index tensors on the card, and
    ``out=`` merged in place."""
    preset = T.create_fftconv_batch_major_channel_lane_preset({
        "shape": [256], "batch": 4, "kernelCount": 2,
        "input": {"channels": 3, "channelIndex": 1},
        "output": {"channels": 4, "channelIndex": 1, "kernelStepChannels": 2}})
    plan = T.create_plan({"type": "fftconv", **preset}, device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    lanes = torch.randn(4, 3, 256, 2, device=cuda_device, generator=gen)
    k = torch.randn(2, 256, 2, device=cuda_device, generator=gen)
    out = torch.full((4 * 4 * 256, 2), 7.5, device=cuda_device)
    y = plan(lanes.reshape(-1, 2), kernel=k, out=out)
    assert y is out
    got = out.reshape(4, 4, 256, 2)
    for kk in range(2):
        ref = _torch_fft_conv(torch.view_as_complex(lanes[:, 1]), torch.view_as_complex(k[kk]),
                              [256], [256], "circular")
        assert_close(got[:, 1 + 2 * kk].cpu(), torch.view_as_real(ref).cpu(), label=f"lane {kk}")
    assert bool((got[:, 0] == 7.5).all() and (got[:, 2] == 7.5).all())


@pytest.mark.parametrize("n,taps,batch,boundary,block", [
    (1 << 16, 129, 2, "circular", None),          # block 8192 = 64 * 128 on K1
    (1 << 16, 129, 1, "linear-same", None),
    (5000, 33, 3, "linear-full", 360),            # a non-power-of-two block
    (777, 9, 2, "linear-valid", 60),
])
def test_overlap_save_on_gpu_matches_torch_fft(n, taps, batch, boundary, block, cuda_device):
    tuning = {"overlapSave": "on", **({"overlapBlock": block} if block else {})}
    plan = T.create_plan({"type": "fftconv", "shape": [n], "batch": batch,
                          "fftConv": {"kernelShape": [taps], "boundary": boundary,
                                      "tuning": tuning}}, device=cuda_device,
                         cache=T.PlanCache())
    assert plan.route.mode == "overlap-save"
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(batch, n, 2, device=cuda_device, generator=gen)
    k = torch.randn(taps, 2, device=cuda_device, generator=gen)
    y, made = _launched(lambda: plan(x, kernel=k))
    assert made == (2, 0), (made, plan.route.reasons)
    ref = _torch_fft_conv(torch.view_as_complex(x), torch.view_as_complex(k), [n], [taps],
                          boundary)
    assert_close(y.cpu(), torch.view_as_real(ref).cpu(), label=f"overlap-save {n} {boundary}")


@pytest.mark.parametrize("ktype,data", [("real", "real"), ("real", "complex"),
                                        ("complex", "complex")])
def test_conv2d_on_gpu_runs_without_tf32(ktype, data, cuda_device):
    """With cuDNN's TF32 flag ON for the process, on data whose low mantissa
    bits TF32 drops (1 + m * 2^-12), the plan still meets 1e-5: it scopes the
    flag off around its own convolution, and restores it."""
    k, shape, batch = 3, [256, 320], 4
    plan = T.create_plan({"type": "conv2d", "shape": shape, "batch": batch,
                          "conv": {"kernelSize": k, "padding": "same", "kernelType": ktype}},
                         device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    tail = (2,) if data == "complex" else ()
    x = 1.0 + torch.randint(0, 4096, (batch, *plan.in_shape, *tail), device=cuda_device,
                            generator=gen).float() / 4096.0
    w = torch.randn(k, k, *((2,) if ktype == "complex" else ()), device=cuda_device,
                    generator=gen)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y = plan(x, kernel=w)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = was
    xc = torch.view_as_complex(x).to(torch.complex128) if data == "complex" else x.double()
    wc = torch.view_as_complex(w).to(torch.complex128) if ktype == "complex" else w.double()
    xp = torch.nn.functional.pad(xc, (1, 1, 1, 1))
    ref = sum(xp[:, i:i + shape[0], j:j + shape[1]] * wc[i, j]
              for i in range(k) for j in range(k))
    ref = torch.view_as_real(ref) if data == "complex" else ref
    assert_close(y.cpu(), ref.cpu(), label=f"conv2d {data}/{ktype}")


def test_staging_on_gpu_out_and_in_place_alias(cuda_device):
    """Strided gather and scatter with index tensors on the card; ``out=``
    and inPlace write the caller's tensors; offsets are Python ints."""
    n, batch = 1024, 64
    opts = {"type": "c2c", "shape": [n], "batch": batch, "normalize": "unitary"}
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(batch, n, 2, device=cuda_device, generator=gen)
    ref = torch.view_as_real(torch.fft.fft(torch.view_as_complex(x), norm="ortho"))

    plan = T.create_plan({**opts, "layout": {"inputStrides": [2], "outputStrides": [3]}},
                         device=cuda_device, cache=T.PlanCache())
    span_in, span_out = 2 * (n - 1) + 1, 3 * (n - 1) + 1
    flat = torch.zeros(span_in * batch + 5, 2, device=cuda_device)
    flat[5:].reshape(batch, span_in, 2)[:, ::2] = x
    out = torch.full((span_out * batch + 7, 2), 7.5, device=cuda_device)
    (y, made) = _launched(lambda: plan(flat, out=out, input_offset_elements=5,
                                       output_offset_elements=7))
    assert y is out and made == (1, 0)
    got = out[7:].reshape(batch, span_out, 2)
    assert_close(got[:, ::3].cpu(), ref.cpu(), label="strided in/out with offsets")
    assert bool((got[:, 1::3] == 7.5).all() and (out[:7] == 7.5).all())

    plan = T.create_plan({**opts, "ioView": {"output": {"shape": [n + 8], "offset": [-4]}}},
                         device=cuda_device, cache=T.PlanCache())
    out = torch.full((batch, n + 8, 2), 7.5, device=cuda_device)
    assert plan(x, out=out) is out
    assert_close(out[:, 4:n + 4].cpu(), ref.cpu(), label="keep-outside merge")
    assert bool((out[:, :4] == 7.5).all() and (out[:, n + 4:] == 7.5).all())

    plan = T.create_plan({**opts, "inPlace": True}, device=cuda_device, cache=T.PlanCache())
    xin = x.clone()
    assert plan(xin) is xin
    assert_close(xin.cpu(), ref.cpu(), label="inPlace")


def test_bf16_storage_on_gpu(cuda_device):
    n, batch = 1024, 64
    plan = T.create_plan({"type": "c2c", "shape": [n], "batch": batch,
                          "precision": "bf16-storage"}, device=cuda_device, cache=T.PlanCache())
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = (0.5 * torch.randn(batch, n, 2, device=cuda_device, generator=gen)).to(torch.bfloat16)
    y, made = _launched(lambda: plan(x))
    assert y.dtype == torch.bfloat16 and made == (0, 0)
    ref = torch.view_as_real(torch.fft.fft(torch.view_as_complex(x.float())))
    assert_close(y.float().cpu(), ref.cpu(), atol_scale=3e-2, label="bf16-storage c2c")


def test_ns3d_bf16_storage_step_on_gpu(cuda_device):
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    n, nu, dt = 64, 2e-2, 1e-2
    step, to_s, _ = ns.make_stepper3(n, nu, dt, device=cuda_device)
    step_b, _, _ = ns.make_stepper3(n, nu, dt, device=cuda_device, precision="bf16-storage")
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    u_hat = to_s(0.1 * torch.randn(3, n, n, n, device=cuda_device, generator=gen))
    assert_close(step_b(u_hat).cpu(), step(u_hat).cpu(), atol_scale=1e-3,
                 label="bf16-storage step 64^3")


# ---------------------------------------------------------------------------
# autodiff: the kernels' adjoint launch and gradients through the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,lines,direction", [
    (1024, 512, "forward"), (2048, 64, "inverse"), (360, 64, "forward"),
    (2310, 16, "forward"), (8192, 3, "inverse"), (16384, 3, "forward"), (16, 1001, "inverse"),
    (6, 77, "forward"), (1352, 11, "inverse"), (256, 1537, "forward")])
def test_fused_lines_adjoint_launch(n, lines, direction, cuda_device):
    """The adjoint launch against the plain adjoint, and the backward of the
    Function (one more launch) against autograd through the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    u = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    assert_close(fused.fused_lines(u, t, adjoint=True).cpu(),
                 fused.fused_lines_reference(u, t, adjoint=True).cpu(), label="adjoint")
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad((fused.fused_lines_reference(xr, t) * u).sum(), xr)
    xk = x.clone().requires_grad_()
    before = fused.fused_lines.launches
    got, = torch.autograd.grad((fused.fused_lines(xk, t) * u).sum(), xk)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches == before + 2      # forward + backward
    assert_close(got.cpu(), want.cpu(), label="backward")


@pytest.mark.parametrize("pre,h,lanes", [
    (4, 256, 512), (3, 360, 130), (2, 7, 128), (2, 16384, 4), (3, 2310, 66), (2, 13, 70),
    (1, 1024, 2048), (3, 128, 8192), (8, 3, 512), (2, 1352, 130)])
def test_fused_cols_adjoint_launch(pre, h, lanes, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    t = _dev_tables(fused_cols.cols_consts(h, "forward", 1.0 / math.sqrt(h), "p"), cuda_device)
    x = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    u = torch.randn(pre, h, lanes, device=cuda_device, generator=gen)
    assert_close(fused_cols.fused_cols(u, t, adjoint=True).cpu(),
                 fused_cols.fused_cols_reference(u, t, adjoint=True).cpu(), label="adjoint")
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad((fused_cols.fused_cols_reference(xr, t) * u).sum(), xr)
    xk = x.clone().requires_grad_()
    before = fused_cols.fused_cols.launches
    got, = torch.autograd.grad((fused_cols.fused_cols(xk, t) * u).sum(), xk)
    torch.cuda.synchronize()
    assert fused_cols.fused_cols.launches == before + 2
    assert_close(got.cpu(), want.cpu(), label="backward")


def test_function_rules_launch_the_kernel_on_gpu(cuda_device):
    """jvp, vmap and double backward through the Function on CUDA tensors:
    every rule launches the kernel, and an untracked call makes no node."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    t = _dev_tables(fused.lines_consts(256, "forward", 1.0, "p"), cuda_device)
    x = torch.randn(16, 256, 2, device=cuda_device, generator=gen)
    u = torch.randn(16, 256, 2, device=cuda_device, generator=gen)
    assert fused.fused_lines(x, t).grad_fn is None
    before = fused.fused_lines.launches
    _, tang = torch.func.jvp(lambda a: fused.fused_lines(a, t), (x,), (u,))
    assert fused.fused_lines.launches == before + 2      # primal + tangent
    assert_close(tang.cpu(), fused.fused_lines_reference(u, t).cpu(), label="jvp")
    before = fused.fused_lines.launches
    y = torch.func.vmap(lambda a: fused.fused_lines(a, t))(torch.stack([x, u]))
    assert fused.fused_lines.launches == before + 1      # the batch folds into lines
    assert_close(y[1].cpu(), fused.fused_lines_reference(u, t).cpu(), label="vmap")

    def second(fn):
        a = x.clone().requires_grad_()
        g, = torch.autograd.grad(fn(a, t).pow(2).sum(), a, create_graph=True)
        return torch.autograd.grad(g.pow(3).sum(), a)[0]

    assert_close(second(fused.fused_lines).cpu(), second(fused.fused_lines_reference).cpu(),
                 label="double backward")


@pytest.mark.parametrize("opts,kshape", [
    ({"type": "c2c", "shape": [1024], "batch": 64, "normalize": "unitary"}, None),
    ({"type": "c2c", "shape": [16, 8, 256], "batch": 2, "direction": "inverse"}, None),
    ({"type": "c2c", "shape": [4093], "batch": 4}, None),
    ({"type": "r2c", "shape": [32, 16, 64], "batch": 3}, None),
    ({"type": "c2r", "shape": [32, 16, 64], "batch": 3, "direction": "inverse",
      "normalize": "backward"}, None),
    ({"type": "dct2", "shape": [64, 512], "batch": 4, "normalize": "unitary"}, None),
    ({"type": "dst3", "shape": [512], "batch": 16}, None),
    ({"type": "fftconv", "shape": [60, 250], "batch": 8,
      "fftConv": {"kernelShape": [5, 7], "boundary": "linear-same"}}, (5, 7, 2)),
    ({"type": "fftconv", "shape": [1 << 15], "batch": 2,
      "fftConv": {"kernelShape": [33], "boundary": "circular"}}, (33, 2)),
    ({"type": "conv2d", "shape": [64, 64], "batch": 2,
      "conv": {"kernelSize": 3, "kernelType": "complex"}}, (3, 3, 2)),
], ids=["c2c1d", "c2c3d", "rader", "r2c", "c2r", "dct2", "dst3", "fftconv2d", "overlap-save",
        "conv2d"])
def test_plan_gradients_on_gpu_match_cpu_plan(opts, kshape, cuda_device):
    """The gradient through the plan on the card (kernel passes: adjoint
    launches) equals the gradient through the same plan on the CPU (plain
    versions), for the input and the kernel payload."""
    gplan = T.create_plan(opts, device=cuda_device, cache=T.PlanCache())
    cplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    gen = torch.Generator().manual_seed(11)
    shape = gplan.input_shape or (opts["batch"], *gplan.in_shape, 2)
    x = torch.randn(tuple(shape), generator=gen)
    k = torch.randn(kshape, generator=gen) if kshape else None
    grads = []
    for plan, dev in ((gplan, cuda_device), (cplan, "cpu")):
        args = [x.to(dev).requires_grad_()]
        kw = {}
        if k is not None:
            args.append(k.to(dev).requires_grad_())
            kw["kernel"] = args[1]
        y = plan(args[0], **kw)
        w = torch.randn(tuple(y.shape), generator=torch.Generator().manual_seed(12)).to(dev)
        grads.append([g.cpu() for g in torch.autograd.grad((w * y).sum(), args)])
    for got, want in zip(*grads):
        assert_close(got, want, label=f"{opts['type']} gradient")


def test_measured_planner_and_snapshot_on_gpu(cuda_device):
    from webgpufft_tpu_torch.runtime import measure
    cache = T.PlanCache()
    opts = {"type": "c2c", "shape": [1024], "batch": 512, "tuning": {"rigor": "measure"}}
    plan = T.create_plan(opts, device=cuda_device, cache=cache)
    (key, rec), = cache.measured.items()
    assert key.startswith(f"cuda/{torch.cuda.get_device_name(0)}|")
    assert any(r.startswith("measured-winner:") for r in plan.route.reasons)
    assert {"as-requested", "impl=xla"} <= set(rec["trials_ms"])
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(T.export_plan_cache_snapshot(cache), cache=fresh, build=False)
    timer, measure._call_time = measure._call_time, None
    try:
        again = T.create_plan(opts, device=cuda_device, cache=fresh)
    finally:
        measure._call_time = timer
    assert f"measured-cached:{rec['winner']}" in again.route.reasons


def test_golden_corpus_selftest_export_and_trace_on_gpu(cuda_device, tmp_path):
    import os
    from webgpufft_tpu_torch import selftest
    from webgpufft_tpu_torch.runtime import golden, profile, trace
    corpus = os.path.join(os.path.dirname(__file__), "golden_corpus.json")
    for art in golden.load_artifacts(corpus):
        res = golden.compare_golden(art, atol_scale=1e-4, device=cuda_device)
        assert res["ok"], res
    assert selftest.run(device=cuda_device)
    plan = T.create_plan({"type": "c2c", "shape": [1024], "batch": 64}, device=cuda_device)
    x = torch.randn(64, 1024, 2, device=cuda_device)
    loaded = T.load_exported_plan(T.export_plan(plan), device=cuda_device)
    assert torch.equal(loaded(x), plan(x))
    with trace.trace(str(tmp_path)) as prof:
        plan(x)
    text = open(prof.trace_path).read()
    assert "wgfft:c2c" in text and "fused_lines_kernel" in text
    stats = trace.plan_stats(plan, x)
    assert stats["fused_lines_launches"] == 1 and stats["device_kernels"] >= 1
    assert profile.device_hbm_gbps(cuda_device) > 0
    ms = profile.time_queued(plan, x, runs=3, device=cuda_device)
    assert len(ms) == 3 and all(0 < t < 50 for t in ms)
    r = profile.bench_transform(lambda v: plan(v), x, 1024, 64, iters=5)
    assert r.avg_ms > 0 and r.eff_gbps > 0


# ---- the probe kernels (webgpufft_tpu_torch.probes) -----------------------

@pytest.mark.parametrize("scale", [None, 1.000001])
@pytest.mark.parametrize("shape", [(4096, 2048), (1000, 36), (1, 4)])
@pytest.mark.parametrize("kw", [
    {"mode": "direct"}, {"mode": "direct", "stage_bytes": 4096},
    {"mode": "cp_async", "stages": 2}, {"mode": "cp_async", "stages": 4, "stage_bytes": 8192},
    {"mode": "cp_async", "stages": 4, "stage_bytes": 49152},
    {"mode": "bulk", "stages": 2}, {"mode": "bulk", "stages": 4, "stage_bytes": 8192},
    {"mode": "bulk", "stages": 2, "stage_bytes": 116160}])
def test_stream_copy_kernel_is_bit_equal(kw, shape, scale, cuda_device):
    """Every mode, ragged last tiles (1000 * 36 * 4 bytes is no multiple of a
    stage) and an array smaller than one tile."""
    from webgpufft_tpu_torch import probes
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0])
    x = torch.randn(*shape, device=cuda_device, generator=gen)
    before = probes.stream_copy.launches
    y = probes.stream_copy(x, scale, **kw)
    torch.cuda.synchronize()
    assert probes.stream_copy.launches == before + 1
    assert torch.equal(y, probes.stream_copy_reference(x, scale))


@pytest.mark.parametrize("n,lines", [(1024, 512), (2048, 64), (360, 65), (2310, 16), (16384, 3),
                                     (16, 1001), (6, 77), (256, 1537), (64, 8192), (1352, 11),
                                     (8192, 131), (4096, 5)])
def test_lines_stages_kernel_matches_plain_at_every_stop(n, lines, cuda_device):
    from webgpufft_tpu_torch import probes
    from webgpufft_tpu_torch.core import radix
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, "forward", 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    count = len(radix.radix_chain(n))
    for stop in range(count + 1):
        before = probes.lines_stages.launches
        y = probes.lines_stages(x, t, stop)
        torch.cuda.synchronize()
        assert probes.lines_stages.launches == before + 1
        assert_close(y.cpu(), probes.lines_stages_reference(x, t, stop).cpu(),
                     label=f"P2 n={n} stop={stop}")
    assert torch.equal(probes.lines_stages(x, t, 0), x)
    assert_close(y.cpu(), fused.fused_lines(x, t).cpu(), label=f"P2 n={n} vs K1")


@pytest.mark.parametrize("n,lines,direction", [
    (1024, 512, "forward"), (2048, 64, "inverse"), (360, 65, "forward"), (2310, 16, "inverse"),
    (16384, 3, "forward"), (16, 1001, "inverse"), (6, 77, "forward"), (256, 1537, "forward"),
    (1352, 11, "inverse"), (8192, 131, "forward")])
def test_lines_planes_and_in_place_match_k1(n, lines, direction, cuda_device):
    from webgpufft_tpu_torch import _build, probes
    from webgpufft_tpu_torch.core import radix
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = _dev_tables(fused.lines_consts(n, direction, 1.0 / math.sqrt(n), "p"), cuda_device)
    x = torch.randn(lines, n, 2, device=cuda_device, generator=gen)
    xp = torch.stack(x.unbind(-1), dim=1).contiguous()
    k1 = fused.fused_lines(x, t)
    before = probes.lines_planes.launches
    yp = probes.lines_planes(xp, t)
    torch.cuda.synchronize()
    assert probes.lines_planes.launches == before + 1
    assert_close(yp.cpu(), probes.lines_planes_reference(xp, t).cpu(), label=f"P3 n={n}")
    assert_close(torch.stack(yp.unbind(1), dim=-1).cpu(), k1.cpu(), label=f"P3 n={n} vs K1")
    chain = radix.radix_chain(n)
    if len(chain) > 1:
        work = x.clone()
        before = fused.fused_lines.launches
        assert probes.lines_inplace(work, t) is work
        assert fused.fused_lines.launches == before + 1
        assert torch.equal(work, k1)
    else:
        with pytest.raises(ValueError, match="one-pass"):
            probes.lines_inplace(x.clone(), t)
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), x.data_ptr(), t["cw"].data_ptr(), t["cp"].data_ptr(), lines, n,
            *_build.chain_arg(chain), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 1   # cudaErrorInvalidValue


def test_probe_wrappers_raise_on_the_card_for_what_the_kernels_refuse(cuda_device):
    from webgpufft_tpu_torch import probes
    t = _dev_tables(fused.lines_consts(64, "forward", 1.0, "p"), cuda_device)
    with pytest.raises(ValueError):
        probes.lines_stages(torch.zeros(4, 64, 2, device=cuda_device), t, 3)
    with pytest.raises(ValueError):
        probes.stream_copy(torch.zeros(4100, device=cuda_device)[1:4097])
    with pytest.raises(ValueError, match="table"):
        probes.lines_planes(torch.zeros(4, 2, 128, device=cuda_device), t)


# ---------------------------------------------------------------------------
# the functional facade and its bridges on the card
# ---------------------------------------------------------------------------

def _launches():
    return fused.fused_lines.launches, fused_cols.fused_cols.launches


def test_facade_device_rule_on_the_card(cuda_device):
    """A CUDA tensor runs on its device through the kernels; numpy input goes
    to the default device, which is the card; a CPU tensor stays on the CPU;
    tensors on two devices raise."""
    import numpy as np
    from webgpufft_tpu_torch import fft as wfft
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    z = torch.randn(512, 1024, dtype=torch.complex64, device=cuda_device, generator=gen)
    before = _launches()
    y = wfft.fft(z)
    assert y.device == cuda_device and y.dtype == torch.float32
    assert _launches() == (before[0] + 1, before[1])
    assert_close(y.cpu(), torch.view_as_real(torch.fft.fft(z)).cpu(), label="facade fft")
    zn = z.cpu().numpy()
    before = _launches()
    yn = wfft.fft(zn.astype(np.complex128))              # numpy, float64: card, float32
    assert yn.device == cuda_device and yn.dtype == torch.float32
    assert _launches() == (before[0] + 1, before[1])
    assert_close(yn.cpu(), y.cpu(), label="numpy in")
    before = _launches()
    yc = wfft.fft(z.cpu())
    assert yc.device.type == "cpu" and _launches() == before
    with pytest.raises(T.PlanError, match="different devices"):
        wfft.fftconvolve(torch.zeros(4, 64, device=cuda_device), torch.zeros(1, 5), axes=(1,))
    with wfft.default_device("cpu"):
        assert wfft.fft(zn).device.type == "cpu"
        assert wfft.fft(z).device == cuda_device         # tensors are never moved


@pytest.mark.parametrize("name,kw", [
    ("rfftn", {}), ("dctn", {"norm": "ortho"}), ("hilbert", {}),
    ("resample", {"num": 3000}), ("welch", {"nperseg": 256}),
])
def test_facade_functions_on_the_card_match_the_cpu(name, kw, cuda_device):
    from webgpufft_tpu_torch import fft as wfft
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(16, 4096, device=cuda_device, generator=gen)
    before = _launches()
    got = getattr(wfft, name)(x, **kw)
    assert sum(_launches()) > sum(before), f"{name}: no kernel launched"
    want = getattr(wfft, name)(x.cpu(), **kw)
    got, want = (got[-1], want[-1]) if isinstance(got, tuple) else (got, want)
    assert got.device == cuda_device
    assert_close(got.cpu(), want, label=name)


def test_facade_stft_istft_on_the_card(cuda_device):
    from webgpufft_tpu_torch import fft as wfft
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(4, 1 << 16, device=cuda_device, generator=gen)
    win = torch.as_tensor(wfft.get_window("hann", 512), device=cuda_device)
    _, _, Z = wfft.stft(x, nperseg=512)
    want = torch.stft(x, n_fft=512, hop_length=256, window=win, center=True,
                      pad_mode="constant", return_complex=True) / win.sum()
    assert_close(Z.cpu(), torch.view_as_real(want).cpu(), label="stft vs torch.stft")
    _, back = wfft.istft(Z, nperseg=512)
    assert_close(back[:, :1 << 16].cpu(), x.cpu(), label="istft(stft(x))")


def test_native_torch_namespace_gradients_on_the_card(cuda_device):
    from webgpufft_tpu_torch import torch_fft
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    z = torch.randn(8, 256, 512, dtype=torch.complex64, device=cuda_device, generator=gen)
    za, zb = z.clone().requires_grad_(True), z.clone().requires_grad_(True)
    before = _launches()
    ya, yb = torch_fft.fft2(za), torch.fft.fft2(zb)
    ga, = torch.autograd.grad(torch.view_as_real(ya).pow(2).sum(), za)
    gb, = torch.autograd.grad(torch.view_as_real(yb).pow(2).sum(), zb)
    after = _launches()
    assert after[0] > before[0] and after[1] > before[1]      # forward and adjoint launches
    assert ya.device == cuda_device and ga.device == cuda_device
    assert_close(torch.view_as_real(ya.detach()).cpu(), torch.view_as_real(yb.detach()).cpu(),
                 label="fft2")
    assert_close(torch.view_as_real(ga).cpu(), torch.view_as_real(gb).cpu(), label="grad fft2")


def test_bridges_run_on_the_card_with_numpy_in_and_out(cuda_device):
    import numpy as np
    import scipy.fft
    from webgpufft_tpu_torch import fftpack, pyfftw
    rng = np.random.default_rng(5)
    z = (rng.standard_normal((256, 1024)) + 1j * rng.standard_normal((256, 1024))
         ).astype(np.complex64)
    want = np.fft.fft(z.astype(np.complex128))
    before = _launches()
    with scipy.fft.set_backend(T.scipy_fft_backend()):
        got = scipy.fft.fft(z)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    assert _launches()[0] == before[0] + 1
    assert_close(np.stack([got.real, got.imag], -1), np.stack([want.real, want.imag], -1),
                 label="scipy backend")
    out = np.zeros_like(z)
    got = pyfftw.FFTW(z, out)()
    assert got is out
    assert_close(np.stack([got.real, got.imag], -1), np.stack([want.real, want.imag], -1),
                 label="pyfftw")
    import scipy.fftpack
    pk = fftpack.rfft(z.real.copy())
    assert pk.device == cuda_device
    assert_close(pk.cpu(), scipy.fftpack.rfft(z.real.astype(np.float64)), label="fftpack.rfft")


def test_wrappers_log_what_they_launched_while_a_log_is_set(cuda_device):
    """``fused_lines.seen`` / ``fused_cols.seen``: a caller's dict gets the
    tables of every launch under its shape, and nothing is kept once it is
    unset (``chip_smoke.py`` reads the paths' shapes from it)."""
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.core import fused, fused_cols
    plan = T.create_plan(type="c2c", shape=[64, 256], batch=4, device=cuda_device)
    x = torch.randn(4, 64, 256, 2, device=cuda_device)
    fused.fused_lines.seen, fused_cols.fused_cols.seen = k1, k2 = {}, {}
    try:
        plan(x)
        plan(x)
    finally:
        fused.fused_lines.seen = fused_cols.fused_cols.seen = None
    plan(x)
    assert [key[:3] for key in k1] == [(256, 4 * 64, False)]
    assert [key[:4] for key in k2] == [(4, 64, 512, False)]
    (tables,) = k1.values()
    y = fused.fused_lines(x.reshape(256, 256, 2), tables)
    ref = fused.fused_lines_reference(x.reshape(256, 256, 2), tables)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())



# ---------------------------------------------------------------------------
# the dispatcher ops, the exported pipeline, NUFFT and linalg on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,shape,n", [("fused_lines", (64, 1024, 2), 1024),
                                            ("fused_cols", (4, 256, 512), 256)])
@pytest.mark.parametrize("adjoint", [False, True])
def test_kernel_ops_opcheck_on_the_card(kernel, shape, n, adjoint, cuda_device):
    """``torch.library.opcheck`` of the CUDA implementations (schema, fake
    implementation, autograd, AOT dispatch), then each against its plain
    version on the same input, and the op counting its launch."""
    mod = fused if kernel == "fused_lines" else fused_cols
    consts = (fused.lines_consts(n, "forward", 1.0, "p") if mod is fused
              else fused_cols.cols_consts(n, "forward", 1.0, "p"))
    named = _dev_tables(consts, cuda_device)
    tables = mod.table_list(named)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(*shape, device=cuda_device, generator=gen)
    torch.library.opcheck(getattr(mod, f"{kernel}_op"), (x.clone().requires_grad_(), tables,
                                                         adjoint))
    before = getattr(mod, kernel).launches
    y = getattr(torch.ops.wgfft, kernel)(x, tables, adjoint)
    torch.cuda.synchronize()
    assert getattr(mod, kernel).launches == before + 1
    plain = fused.fused_lines_reference if mod is fused else fused_cols.fused_cols_reference
    assert_close(y.cpu(), plain(x, named, adjoint).cpu())


def test_exported_pipeline_counts_its_launches_on_the_card(cuda_device):
    """A pipeline exported on the card and loaded back launches K1 through
    the op at every call, counted there, and equals the eager call."""
    x = torch.randn(8, 1 << 14, device=cuda_device)

    def pipe_fn(sig):
        _, _, z = T.fft.stft(sig, nperseg=1024, noverlap=512)
        z = z * ((z[..., 0] ** 2 + z[..., 1] ** 2) > 1e-3)[..., None]
        return T.fft.istft(z, nperseg=1024, noverlap=512)[1]

    pipe = T.load_exported_pipeline(T.export_pipeline(pipe_fn, x))
    assert pipe.platforms == ("cuda",)
    before = fused.fused_lines.launches
    got = pipe(x)
    torch.cuda.synchronize()
    assert fused.fused_lines.launches > before
    assert_close(got.cpu(), pipe_fn(x).cpu(), 1e-6)


def test_nufft2d1_on_the_card_matches_the_cpu(cuda_device):
    import numpy as np
    rng = np.random.default_rng(5)
    m, n = 2000, (24, 32)
    x, y = rng.uniform(0, 2 * np.pi, m), rng.uniform(0, 2 * np.pi, m)
    c = rng.standard_normal((3, m, 2)).astype(np.float32)
    before = (fused.fused_lines.launches, fused_cols.fused_cols.launches)
    got = T.nufft.nufft2d1(x, y, torch.from_numpy(c).to(cuda_device), n)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert fused.fused_lines.launches > before[0] and fused_cols.fused_cols.launches > before[1]
    want = T.nufft.nufft2d1(x, y, torch.from_numpy(c), n)
    assert_close(got.cpu(), want)


def test_solve_toeplitz_on_the_card_matches_scipy(cuda_device):
    import numpy as np
    import scipy.linalg as sla
    c = 0.5 ** np.arange(512)
    b = np.random.default_rng(6).standard_normal((512, 4))
    got = T.linalg.solve_toeplitz(c, torch.from_numpy(b).to(cuda_device))
    assert got.device.type == "cuda"
    assert_close(got.cpu(), sla.solve_toeplitz(c, b), 5e-4)


# ---------------------------------------------------------------- DSP toolboxes

def test_toolboxes_take_numpy_to_the_card(cuda_device):
    """numpy in: the filters, the splines and the Fourier filters run on
    the card (the facade's default device); lsim's recurrence too, numpy
    out as from the JAX package."""
    import numpy as np
    import scipy.signal as ss
    x = np.random.default_rng(7).standard_normal((2, 300))
    b, a = ss.butter(3, 0.2)
    im = np.random.default_rng(7).standard_normal((32, 40))
    for y in (T.filtering.lfilter(b, a, x), T.filtering.sosfilt(ss.butter(4, 0.2, output="sos"), x),
              T.filtering.savgol_filter(x, 11, 3), T.splines.cspline2d(im),
              T.ndimage.fourier_gaussian(x, 1.5)):
        assert y.device.type == "cuda" and y.dtype == torch.float32
    _, yl, xl = T.ltisys.lsim(ss.butter(2, 4, analog=True), np.ones(100), np.linspace(0, 2, 100))
    assert isinstance(yl, np.ndarray) and isinstance(xl, np.ndarray)
    _, ye, _ = ss.lsim(ss.butter(2, 4, analog=True), np.ones(100), np.linspace(0, 2, 100))
    assert_close(yl, ye, 2e-4)


@pytest.mark.parametrize("K", [2, 4])
def test_iir_gate_on_the_card_picks_the_route_and_both_agree(K, cuda_device, monkeypatch):
    """Above the CUDA threshold the parallel prefix runs, below it the
    sequential loop; the two give the same result within 1e-5."""
    import numpy as np
    import scipy.signal as ss
    F = T.filtering
    b, a = ss.butter(K, 0.2)
    gate = F.IIR_ASSOC_MIN_N_CUDA
    assert gate is not None
    n = max(2 * gate, 512)
    x = torch.from_numpy(np.random.default_rng(K).standard_normal((8, n)).astype(np.float32))
    x = x.to(cuda_device)
    routes = []
    real_assoc, real_seq = F._iir_assoc, F._iir_seq
    monkeypatch.setattr(F, "_iir_assoc", lambda *v: routes.append("assoc") or real_assoc(*v))
    monkeypatch.setattr(F, "_iir_seq", lambda *v: routes.append("seq") or real_seq(*v))
    y_above = F.lfilter(b, a, x)
    short = F.lfilter(b, a, x[:, :gate - 1]) if gate > 1 else None
    assert routes[0] == "assoc" and (short is None or routes[1] == "seq"), routes
    z0 = torch.zeros(8, K, device=cuda_device)
    bp, ap = b / a[0], a / a[0]
    y_seq, _ = real_seq(bp, ap, x, z0)
    assert_close(y_above.cpu(), y_seq.cpu(), 1e-5)
    assert_close(y_above.cpu(), ss.lfilter(b, a, x.cpu().numpy().astype(np.float64)), 2e-4)


def test_tf32_scope_holds_on_the_card(cuda_device):
    """With TF32 switched on by the caller, the parallel prefix, lsim and
    savgol (its edge rule, and the plan layer's einsum transform of its
    taps) stay at full float32 against scipy (the JAX tests' bars), and the
    caller's setting is back afterwards."""
    import numpy as np
    import scipy.signal as ss
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 4096)).astype(np.float32)
    b, a = ss.butter(4, 0.2)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        xt = torch.from_numpy(x).to(cuda_device)
        y, _ = T.filtering._iir_assoc(b, a, xt, torch.zeros(4, 4, device=cuda_device))
        sg = T.filtering.savgol_filter(xt, 101, 3)
        T_ = np.linspace(0, 5, 2000)
        _, yl, _ = T.ltisys.lsim(ss.butter(3, 4, analog=True), np.sin(T_), T_)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert_close(y.cpu(), ss.lfilter(b, a, x.astype(np.float64)), 1e-5)
    assert_close(sg.cpu(), ss.savgol_filter(x.astype(np.float64), 101, 3), 1e-4)
    _, ye, _ = ss.lsim(ss.butter(3, 4, analog=True), np.sin(T_), T_)
    assert_close(yl, ye, 2e-4)


def test_fir_lfilter_launches_k1(cuda_device):
    """FIR lfilter is the plan layer's convolution: it launches K1, and
    agrees with scipy."""
    import numpy as np
    import scipy.signal as ss
    x = np.random.default_rng(9).standard_normal((8, 1 << 16)).astype(np.float32)
    h = ss.firwin(129, 0.2)
    before = fused.fused_lines.launches
    y = T.filtering.lfilter(h, 1.0, torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert fused.fused_lines.launches > before
    assert_close(y.cpu(), ss.lfilter(h, 1.0, x.astype(np.float64)), 1e-5)


def test_einsum_route_gradient_holds_full_f32_with_tf32_on(cuda_device):
    """The einsum route's backward products run in full float32 as its
    forward does: with the caller's TF32 flag on, the gradient of an
    einsum-route plan equals (to 1e-5) the gradient with it off, on data
    whose low mantissa bits TF32 would drop."""
    import numpy as np
    rng = np.random.default_rng(11)
    plan = T.create_plan({"type": "c2c", "shape": [1000], "batch": 64,
                          "tuning": {"impl": "xla"}}, device=cuda_device,
                         cache=T.PlanCache())
    x0 = torch.from_numpy((1.0 + rng.standard_normal((64, 1000, 2)) * 1e-3)
                          .astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.standard_normal((64, 1000, 2)).astype(np.float32)).to(cuda_device)

    def grad():
        x = x0.clone().requires_grad_()
        g, = torch.autograd.grad((plan(x) * w).sum(), x)
        return g

    m = torch.backends.cuda.matmul
    saved = m.fp32_precision
    try:
        m.allow_tf32 = False
        g_off = grad()
        m.allow_tf32 = True
        g_on = grad()
        assert m.fp32_precision == "tf32"
    finally:
        if saved == "none":
            m.fp32_precision = "none"
        else:
            m.allow_tf32 = saved == "tf32"
    assert_close(g_on.cpu(), g_off.cpu(), 1e-5)


def test_distributed_export_round_trip_on_the_card(cuda_device):
    """export_distributed_plan -> load_exported_plan -> ep(x, mesh=) in a
    one-rank NCCL world: the served output equals the live plan's, on the
    card, for the four-step c2c and the halo fftconv routes."""
    import datetime
    import torch.distributed as dist
    from webgpufft_tpu_torch.parallel import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=cuda_device, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh({"sp": 1}, device="cuda")
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        for opts, kshape in [({"type": "c2c", "shape": [1 << 16], "batch": 4}, None),
                             ({"type": "fftconv", "shape": [1 << 16], "batch": 4,
                               "fftConv": {"boundary": "linear-same",
                                           "kernelShape": [33]}}, (33, 2))]:
            plan = T.create_distributed_plan(opts, mesh=mesh, seq_axis="sp")
            ep = T.load_exported_plan(T.export_distributed_plan(plan))
            x = torch.randn(4, 1 << 16, 2, device=cuda_device, generator=gen)
            args = [x] if kshape is None else [x, torch.randn(kshape, device=cuda_device,
                                                              generator=gen)]
            y = ep(*args, mesh=mesh)
            assert y.device.type == "cuda" and ep.distributed["nr_devices"] == 1
            live = plan(x, **({} if kshape is None else {"kernel": args[1]}))
            assert torch.equal(y.full_tensor(), live.full_tensor())
    finally:
        dist.destroy_process_group()


def test_training_step_kernel_gradient_on_the_card(cuda_device):
    """One step of the system-identification example: the loss's gradient
    with respect to the kernel through the fftconv plan on the card (K1
    forward, then its adjoint launch) against autograd through the plain
    versions (the same model on the CPU).  n + klen - 1 = 4096 puts the
    convolution on K1 (the example's own 544 runs Bluestein einsums)."""
    from webgpufft_tpu_torch.examples import system_identification as ex
    n, klen, batch = 4064, 33, 8
    x, k_true, eps = ex.make_problem(n, klen, batch, 1e-3)
    y = ex.observations(x, k_true, eps)
    k0 = torch.linspace(-0.1, 0.2, klen)
    grads = []
    for dev in (cuda_device, "cpu"):
        model, _ = ex.make_model(n, klen, batch, device=dev)
        xt = torch.from_numpy(x).to(dev)
        k = k0.to(dev).requires_grad_()
        before = fused.fused_lines.launches
        loss = ((model(k, torch.stack([xt, torch.zeros_like(xt)], -1))
                 - torch.from_numpy(y).to(dev)) ** 2).mean()
        g, = torch.autograd.grad(loss, k)
        if dev != "cpu":
            assert fused.fused_lines.launches - before >= 2     # forward and adjoint
        grads.append(g.cpu())
    assert_close(grads[0], grads[1], label="d loss / d kernel")
