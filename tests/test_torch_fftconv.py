"""fftconv: the JAX package against the PyTorch port (``device="cpu"``).

Every case of ``tests/test_fftconv.py`` under ``impl`` "auto" and "xla": the
same numpy data and kernels through both plans, outputs within
1e-5 * max|expected|, and under "xla" equal route metadata.  The port does
not carry the JAX package's batch chunking and overlap-save block groups
(they bound TPU einsum operands); the cases that assert those reasons there
compare outputs here and check that the port records no chunk reason.
"""

import math

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.core.cplx import interleave, uninterleave
from webgpufft_tpu_torch.utils import mathref as TR

from torch_port_support import run_both, same_route

IMPLS = ["auto", "xla"]
BOUNDARIES = ["circular", "linear-full", "linear-same", "linear-valid"]


def rand_c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _parity(opts, x, kernel, impl, assert_close, label, same=True, **kw):
    jplan, tplan, jy, ty = run_both({"type": "fftconv", **opts}, x, impl=impl,
                                    kernel=kernel, **kw)
    assert ty.dtype == np.float32 and ty.shape == jy.shape, (ty.shape, jy.shape)
    assert_close(ty, jy, label=label)
    if impl == "xla" and same:
        same_route(jplan, tplan)
    return jplan, tplan, uninterleave(ty)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("mode", ["convolution", "correlation"])
def test_boundaries_and_modes(boundary, mode, impl, rng, assert_close):
    x, k = rand_c(rng, (2, 16)), rand_c(rng, (5,))
    opts = {"shape": [16], "batch": 2,
            "fftConv": {"boundary": boundary, "mode": mode, "kernelShape": [5]}}
    _, tplan, y = _parity(opts, interleave(x), interleave(k), impl, assert_close,
                          f"{boundary}/{mode}")
    ref = TR.fftconv(x, k, [16], batch=2, mode=mode, boundary=boundary, kernel_shape=[5])
    assert_close(y, ref, label=f"{boundary}/{mode} vs numpy")
    assert tplan.out_shape == ref.shape[1:]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape,kshape", [
    ([12, 10], [3, 3]), ([8, 6, 4], [3, 2, 2]), ([16, 8, 4], [16, 8, 4]),
])
def test_nd_fftconv(shape, kshape, impl, rng, assert_close):
    x, k = rand_c(rng, (2, *shape)), rand_c(rng, tuple(kshape))
    opts = {"shape": shape, "batch": 2,
            "fftConv": {"boundary": "linear-same", "kernelShape": kshape}}
    _, _, y = _parity(opts, interleave(x), interleave(k), impl, assert_close, "nd")
    ref = TR.fftconv(x, k, shape, batch=2, boundary="linear-same", kernel_shape=kshape)
    assert_close(y, ref, label="nd vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("output_layout", ["kernel-major", "batch-major"])
def test_multi_kernel(output_layout, impl, rng, assert_close):
    shape, kshape, kc, b = [16, 8, 4], [3, 3, 3], 3, 2
    x = rand_c(rng, (b, *shape))
    ks = [rand_c(rng, tuple(kshape)) for _ in range(kc)]
    opts = {"shape": shape, "batch": b,
            "fftConv": {"kernelCount": kc, "kernelShape": kshape,
                        "boundary": "linear-same", "outputLayout": output_layout}}
    _, _, y = _parity(opts, interleave(x), [interleave(k) for k in ks], impl, assert_close,
                      f"multi.{output_layout}")
    ref = np.stack([TR.fftconv(x, k, shape, batch=b, boundary="linear-same",
                               kernel_shape=kshape) for k in ks])
    if output_layout == "batch-major":
        ref = np.moveaxis(ref, 0, 1)
    assert_close(y, ref, label=f"multi.{output_layout} vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("form", ["stacked", "packed", "flat", "list", "tensor"])
def test_kernel_payload_forms(form, impl, rng, assert_close):
    """(kc, *kshape, 2), packed (kc*prod(kshape), 2), flat reals, a list of
    per-kernel payloads, and (the port only) a torch tensor."""
    kc = 2
    x, ks = rand_c(rng, (1, 8)), rand_c(rng, (kc, 3))
    payload = {"stacked": interleave(ks), "packed": interleave(ks.reshape(-1)),
               "flat": interleave(ks).reshape(-1), "list": [interleave(k) for k in ks],
               "tensor": interleave(ks)}[form]
    opts = {"shape": [8], "batch": 1, "fftConv": {"kernelCount": kc, "kernelShape": [3]}}
    _, tplan, y = _parity(opts, interleave(x), payload, impl, assert_close, form)
    ref = np.stack([TR.fftconv(x, ks[i], [8], batch=1, kernel_shape=[3]) for i in range(kc)])
    assert_close(y, ref, label=f"{form} vs numpy")
    if form == "tensor":
        got = tplan.exec(torch.from_numpy(interleave(x)), kernel=torch.from_numpy(payload))
        assert_close(uninterleave(got.numpy()), ref, label="tensor payload")


def test_single_kernel_payload_without_kernel_dim(rng, assert_close):
    x, k = rand_c(rng, (1, 8)), rand_c(rng, (3,))
    opts = {"shape": [8], "batch": 1, "fftConv": {"kernelShape": [3]}}
    for payload in (interleave(k), interleave(k)[None]):
        _parity(opts, interleave(x), payload, "auto", assert_close, "kc=1")
    plan = T.create_plan({"type": "fftconv", **opts}, device="cpu")
    with pytest.raises(T.PlanError, match="not understood"):
        plan.exec(torch.zeros(1, 8, 2), kernel=np.zeros((4, 2), np.float32))
    with pytest.raises(T.PlanError, match="entries"):
        plan.exec(torch.zeros(1, 8, 2), kernel=[np.zeros((3, 2), np.float32)] * 2)


@pytest.mark.parametrize("impl", IMPLS)
def test_kernel_defaults_to_shape(impl, rng, assert_close):
    x, k = rand_c(rng, (1, 12)), rand_c(rng, (12,))
    _, _, y = _parity({"shape": [12], "batch": 1}, interleave(x), interleave(k), impl,
                      assert_close, "default kshape")
    assert_close(y, TR.fftconv(x, k, [12], batch=1), label="default kshape vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("zero_pad", [
    {"read": {"start": [2], "end": [18]}},
    {"write": {"start": [3], "end": [17]}},
    {"read": {"start": [1], "end": [19]}, "write": {"start": [0], "end": [12]}},
])
def test_zero_pad_stages(zero_pad, impl, rng, assert_close):
    """zeroPad.read/write act in the FFT logical domain (length 20 here)."""
    x, k = rand_c(rng, (1, 16)), rand_c(rng, (5,))
    opts = {"shape": [16], "batch": 1, "zeroPad": zero_pad,
            "fftConv": {"boundary": "linear-same", "kernelShape": [5]}}
    _, _, y = _parity(opts, interleave(x), interleave(k), impl, assert_close, "zeroPad")
    if "write" not in zero_pad:
        xz = x.copy()
        xz[:, :2] = 0
        ref = TR.fftconv(xz, k, [16], batch=1, boundary="linear-same", kernel_shape=[5])
        assert_close(y, ref, label="zeroPad.read vs numpy")


def _lane_case(rng, preset_fn, shape=(8,), b=2, kc=2, cin=2, cout=4, step=2):
    n = math.prod(shape)
    preset = preset_fn({
        "shape": list(shape), "batch": b, "kernelCount": kc,
        "input": {"channels": cin, "channelIndex": 1},
        "output": {"channels": cout, "channelIndex": 0, "kernelStepChannels": step},
    })
    lanes = rand_c(rng, (b, cin, n))
    return preset, lanes, rand_c(rng, (kc, *shape))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("preset_name", [
    "create_fftconv_channel_lane_preset",
    "create_fftconv_kernel_major_channel_lane_preset",
    "create_fftconv_batch_major_channel_lane_preset"])
def test_channel_lane_preset_roundtrip(preset_name, impl, rng, assert_close):
    """Two input channels, multi-kernel strided output lanes: kernel k
    writes lane channelIndex + k * kernelStepChannels."""
    preset, lanes, k = _lane_case(rng, getattr(T, preset_name))
    assert preset == getattr(W, preset_name)({
        "shape": [8], "batch": 2, "kernelCount": 2,
        "input": {"channels": 2, "channelIndex": 1},
        "output": {"channels": 4, "channelIndex": 0, "kernelStepChannels": 2}})
    flat_in = interleave(lanes.reshape(-1))
    _, tplan, y = _parity(preset, flat_in, interleave(k), impl, assert_close, "lanes")
    assert tplan.input_shape == (None,) and tplan.accepts_out
    out = y.reshape(2, 4, 8)
    for kk in range(2):
        ref = TR.fftconv(lanes[:, 1, :], k[kk], [8], batch=2)
        assert_close(out[:, kk * 2, :], ref, label=f"lane{kk * 2}")
    assert np.all(out[:, 1, :] == 0) and np.all(out[:, 3, :] == 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_channel_lane_out_merge_keeps_other_lanes(impl, rng, assert_close):
    """``out=`` on the channel-lane scatter writes the kernels' lanes into the
    caller's tensor, returns it, and leaves every other element alone."""
    preset, lanes, k = _lane_case(rng, T.create_fftconv_channel_lane_preset)
    flat_in = interleave(lanes.reshape(-1))
    sentinel = np.full((2 * 4 * 8, 2), 7.5, np.float32)
    _, tplan, y = _parity(preset, flat_in, interleave(k), impl, assert_close, "lanes out=",
                          out=sentinel)
    out = y.reshape(2, 4, 8)
    assert np.all(out[:, 1, :] == 7.5 + 7.5j) and np.all(out[:, 3, :] == 7.5 + 7.5j)
    assert_close(out[:, 2, :], TR.fftconv(lanes[:, 1, :], k[1], [8], batch=2), label="lane 2")
    buf = torch.full((2 * 4 * 8, 2), 7.5)
    got = tplan.exec(torch.from_numpy(flat_in), kernel=interleave(k), out=buf)
    assert got is buf
    with pytest.raises(T.PlanError, match="flat"):
        tplan.exec(torch.from_numpy(flat_in), kernel=interleave(k), out=torch.zeros(10, 2))


@pytest.mark.parametrize("impl", IMPLS)
def test_output_kernel_stride_elements(impl, rng, assert_close):
    x, ks = rand_c(rng, (1, 8)), rand_c(rng, (2, 8))
    opts = {"shape": [8], "batch": 1,
            "fftConv": {"kernelCount": 2, "outputKernelStrideElements": 16}}
    _, _, y = _parity(opts, interleave(x), interleave(ks), impl, assert_close, "kstride")
    assert y.shape == (32,)
    for kk in range(2):
        ref = TR.fftconv(x, ks[kk], [8], batch=1)[0]
        assert_close(y[kk * 16: kk * 16 + 8], ref, label=f"k{kk}")
        assert np.all(y[kk * 16 + 8: (kk + 1) * 16] == 0)


def test_validation_errors():
    with pytest.raises(T.PlanError, match="circular"):
        T.create_plan(type="fftconv", shape=[8], fftConv={"kernelShape": [9]}, device="cpu")
    with pytest.raises(T.PlanError, match="linear-valid"):
        T.create_plan(type="fftconv", shape=[4], device="cpu",
                      fftConv={"boundary": "linear-valid", "kernelShape": [5]})
    with pytest.raises(T.PlanError, match="ioView"):
        T.create_plan(type="fftconv", shape=[16], ioView={"input": {"shape": [8]}},
                      device="cpu")
    plan = T.create_plan(type="fftconv", shape=[8], device="cpu")
    with pytest.raises(T.PlanError, match="kernel"):
        plan.exec(torch.zeros(1, 8, 2))
    with pytest.raises(T.PlanError, match="out="):
        plan.exec(torch.zeros(1, 8, 2), kernel=np.zeros((8, 2), np.float32),
                  out=torch.zeros(8, 2))
    with pytest.raises(T.PlanError, match="exec offsets"):
        plan.exec(torch.zeros(1, 8, 2), kernel=np.zeros((8, 2), np.float32),
                  input_offset_elements=1)


def _no_chunk_reasons(tplan):
    assert not any("chunk(" in r or "chunk-elems" in r for r in tplan.route.reasons), \
        tplan.route.reasons


def test_fftconv_large_batch_chunk(rng, assert_close):
    """Where the JAX package chunks the batch for its operand bound, the
    port runs the whole batch and records the knob as ignored."""
    kc, batch = 2, 64
    opts = {"shape": [64], "batch": batch, "fftConv": {"kernelCount": kc},
            "tuning": {"chunkElements": 1 << 12}}
    x, ks = rand_c(rng, (batch, 64)), rand_c(rng, (kc, 64))
    jplan, tplan, _ = _parity(opts, interleave(x), interleave(ks), "auto", assert_close,
                              "large batch")
    assert any("large-batch-chunk" in r for r in jplan.route.reasons), jplan.route.reasons
    assert "ignored-tpu-knob:chunkElements" in tplan.route.reasons
    _no_chunk_reasons(tplan)


# ---------------------------------------------------------------------------
# overlap-save
# ---------------------------------------------------------------------------

def _os_opts(n, k, block, batch, boundary, **tuning):
    return {"shape": [n], "batch": batch, "tuning": tuning,
            "fftConv": {"boundary": boundary, "kernelShape": [k],
                        "tuning": {"overlapSave": "on", "overlapBlock": block}}}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_overlap_save_all_boundaries(boundary, impl, rng, assert_close):
    n, k, batch = 777, 9, 2
    z, kk = rand_c(rng, (batch, n)), rand_c(rng, (k,))
    _, tplan, y = _parity(_os_opts(n, k, 60, batch, boundary), interleave(z), interleave(kk),
                          impl, assert_close, f"os {boundary}")
    assert tplan.route.mode == "overlap-save"
    assert any(r.startswith("os-block") for r in tplan.route.reasons)
    ref = TR.fftconv(z, kk, [n], batch=batch, boundary=boundary, kernel_shape=[k])
    assert_close(y, ref, label=f"os {boundary} vs numpy")


@pytest.mark.parametrize("shape,batch,fc,want", [
    ([1 << 18], 1, {}, True),
    ([1 << 18], 1, {"tuning": {"overlapSave": "off"}}, False),
    ([1 << 18], 1, {"mode": "correlation"}, False),
    ([1 << 15], 1, {}, True),
    ([1 << 14], 4, {}, True),
    ([1 << 14], 1, {}, False),
    ([1 << 20], 1, {}, True),
    ([4096], 1, {}, False),
])
def test_overlap_save_auto_selection(shape, batch, fc, want):
    """The inherited thresholds pick overlap-save as the JAX package does
    wherever its block-group count does not enter."""
    opts = {"type": "fftconv", "shape": shape, "batch": batch,
            "fftConv": {"boundary": "linear-same", "kernelShape": [129], **fc}}
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert (tplan.route.mode == "overlap-save") == want
    assert (jplan.route.mode == "overlap-save") == want
    if want:
        assert "os-block(8192)" in tplan.route.reasons


def test_overlap_save_has_no_group_limit():
    """The JAX package leaves overlap-save when its blocks would need more
    than four serialized groups; the port has no groups and stays."""
    opts = {"type": "fftconv", "shape": [1 << 20], "batch": 4,
            "fftConv": {"boundary": "linear-same", "kernelShape": [129]}}
    assert W.create_plan(opts, cache=W.PlanCache()).route.mode != "overlap-save"
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert tplan.route.mode == "overlap-save"
    _no_chunk_reasons(tplan)
    with pytest.raises(T.PlanError, match="overlapSave"):
        T.create_plan(type="fftconv", shape=[64, 64], device="cpu",
                      fftConv={"tuning": {"overlapSave": "on"}})


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("tuning", [{}, {"chunkElements": 1 << 12}])
def test_overlap_save_block_chunking(tuning, impl, rng, assert_close):
    """Many blocks (171 of length 16); with the operand bound lowered the
    JAX package streams block groups, the port runs all blocks at once."""
    n, k, batch = 2048, 5, 3
    z, kk = rand_c(rng, (batch, n)), rand_c(rng, (k,))
    jplan, tplan, y = _parity(_os_opts(n, k, 16, batch, "linear-full", **tuning),
                              interleave(z), interleave(kk), impl, assert_close, "os grouped",
                              same=not tuning)
    ref = TR.fftconv(z, kk, [n], batch=batch, boundary="linear-full", kernel_shape=[k])
    assert_close(y, ref, label="os grouped vs numpy")
    _no_chunk_reasons(tplan)
    if tuning:
        assert any(r.startswith("os-block-chunk") for r in jplan.route.reasons)
        assert "ignored-tpu-knob:chunkElements" in tplan.route.reasons


# ---------------------------------------------------------------------------
# the transforms on the kernels (their plain versions here)
# ---------------------------------------------------------------------------

def test_fftconv_passes_on_the_kernels(rng, assert_close):
    """fft shape (64, 256), batch 8: K2 on axis 0 (512 lanes) and K1 on
    axis 1 for the data and the product; the lone kernel's last axis has 64
    lines and takes K1 too."""
    shape, kshape, b = [60, 250], [5, 7], 8
    x, k = rand_c(rng, (b, *shape)), rand_c(rng, tuple(kshape))
    opts = {"shape": shape, "batch": b,
            "fftConv": {"boundary": "linear-full", "kernelShape": kshape}}
    _, tplan, y = _parity(opts, interleave(x), interleave(k), "auto", assert_close, "kernels")
    assert tplan.fft_shape == (64, 256)
    assert tplan.route.mode == "pallas-fused", tplan.route.reasons
    for want in ("fftconv-axis0-fused-cols", "fftconv-axis1-fused-lines"):
        assert want in tplan.route.reasons, tplan.route.reasons
    ref = TR.fftconv(x, k, shape, batch=b, boundary="linear-full", kernel_shape=kshape)
    assert_close(y, ref, label="kernels vs numpy")


def test_fftconv_kernel_side_stays_on_einsum_below_the_line_floor(rng, assert_close):
    """1-D, batch 8: the data has 8 lines (K1), the lone kernel 1 (einsum)."""
    x, k = rand_c(rng, (8, 256)), rand_c(rng, (9,))
    opts = {"shape": [256], "batch": 8, "fftConv": {"kernelShape": [9]}}
    _, tplan, _ = _parity(opts, interleave(x), interleave(k), "auto", assert_close, "1-D")
    assert "fftconv-axis0-fused-lines" in tplan.route.reasons
    assert "fftconv-kernel-axis0-xla" in tplan.route.reasons
    assert tplan.route.mode == "pallas-mixed"


def test_overlap_save_blocks_on_the_line_kernel(rng, assert_close):
    """Default block 8192 = 64 * 128: the first unevenly split length K1
    gets from this path; 9 blocks forward and inverse, the kernel's one
    line on the einsum route."""
    n, k = 1 << 16, 129
    z, kk = rand_c(rng, (1, n)), rand_c(rng, (k,))
    opts = {"shape": [n], "batch": 1, "fftConv": {"boundary": "circular", "kernelShape": [k]}}
    _, tplan, y = _parity(opts, interleave(z), interleave(kk), "auto", assert_close, "os K1")
    assert tplan.route.mode == "overlap-save"
    assert "fftconv-axis0-fused-lines" in tplan.route.reasons
    assert "fftconv-kernel-axis0-xla" in tplan.route.reasons
    assert "os-block(8192)" in tplan.route.reasons
    ref = np.fft.ifft(np.fft.fft(z) * np.fft.fft(kk, n))
    assert_close(y, ref, label="os K1 vs numpy")


# ---------------------------------------------------------------------------
# tables carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    {"shape": [12, 10], "batch": 2,
     "fftConv": {"boundary": "linear-same", "kernelShape": [3, 3]}},       # f/ax*, i/ax*
    {"shape": [17], "batch": 2, "fftConv": {}},                             # Rader tables
    _os_opts(777, 9, 60, 2, "circular"),                                    # os/f, os/i
])
def test_fftconv_runs_on_the_jax_tables(opts, rng):
    kshape = opts["fftConv"].get("kernelShape", opts["shape"])
    x = interleave(rand_c(rng, (2, *opts["shape"])))
    k = interleave(rand_c(rng, tuple(kshape)))
    jplan, tplan, _, own = run_both({"type": "fftconv", **opts}, x, impl="xla", kernel=k)
    tables = T.tables_from_reference({n: np.array(v) for n, v in jplan._consts.items()}, "cpu")
    assert {n: v.dtype for n, v in tables.items()} == \
        {n: v.dtype for n, v in tplan.consts.items()}
    got = tplan.load_consts(tables).exec(torch.from_numpy(x), kernel=k).numpy()
    assert np.array_equal(got, own)
