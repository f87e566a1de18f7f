"""Layout / ioView / zeroPad / bf16-storage / exec offsets / out= / inPlace:
the JAX package against the PyTorch port (``device="cpu"``).

Every case of ``tests/test_layout.py`` under ``impl`` "auto" and "xla": the
same numpy buffers through both plans, outputs within 1e-5 * max|expected|
(bf16-storage plans at that file's bf16 limits), and under "xla" equal
route metadata.  Where the JAX package returns a new array from ``out=``,
the port writes into the caller's tensor and returns it; the returned
values are compared, and the aliasing is checked on the port alone.
"""

import numpy as np
import pytest
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.core.cplx import interleave, uninterleave
from webgpufft_tpu_torch.plans import stages
from webgpufft_tpu_torch.utils import mathref as TR

from torch_port_support import run_both, same_route

IMPLS = ["auto", "xla"]


def rand_c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _parity(opts, x, impl, assert_close, label, tol=1e-5, **kw):
    jplan, tplan, jy, ty = run_both(opts, x, impl=impl, **kw)
    assert ty.shape == jy.shape, (ty.shape, jy.shape)
    assert_close(ty, jy, atol_scale=tol, label=label)
    if impl == "xla":
        same_route(jplan, tplan)
    return tplan, ty


def _c2c(shape, batch, **extra):
    return {"type": "c2c", "shape": list(shape), "batch": batch, "direction": "forward",
            **extra}


# ---------------------------------------------------------------------------
# strided / offset / batch-stride layouts (flat buffers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_c2c_strided_input(impl, rng, assert_close):
    n, batch, stride, offset, bstride = 8, 2, 3, 5, 40
    L = offset + bstride * (batch - 1) + (n - 1) * stride + 1
    z = rand_c(rng, (L,))
    opts = _c2c([n], batch, layout={"inputStrides": [stride], "inputOffsetElements": offset,
                                    "inputBatchStrideElements": bstride})
    tplan, y = _parity(opts, interleave(z), impl, assert_close, "strided-in")
    assert tplan.input_shape == (None,) and tplan.output_shape == (batch, n, 2)
    gathered = np.stack([z[offset + b * bstride: offset + b * bstride + n * stride: stride]
                         for b in range(batch)])
    assert_close(uninterleave(y), TR.fft_nd(gathered, [n], "forward"), label="vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_c2c_strided_output(impl, rng, assert_close):
    n, batch, stride = 4, 2, 2
    z = rand_c(rng, (batch, n))
    tplan, y = _parity(_c2c([n], batch, layout={"outputStrides": [stride]}), interleave(z),
                       impl, assert_close, "strided-out")
    flat, ref = uninterleave(y), TR.fft_nd(z, [n], "forward")
    span = (n - 1) * stride + 1
    for b in range(batch):
        assert_close(flat[b * span: b * span + n * stride: stride], ref[b], label=f"b{b}")
    assert flat[1] == 0                      # gaps stay zero
    assert tplan.output_shape == (None,) and tplan.accepts_out


@pytest.mark.parametrize("impl", IMPLS)
def test_c2c_strided_roundtrip_2d(impl, rng, assert_close):
    shape, batch, strides = (4, 6), 2, (12, 2)
    span = 1 + 3 * 12 + 5 * 2
    z = rand_c(rng, (batch * span,))
    _, y = _parity(_c2c(shape, batch, layout={"strides": list(strides)}), interleave(z), impl,
                   assert_close, "strided-2d")
    idx = (np.arange(4)[:, None] * 12 + np.arange(6)[None, :] * 2).reshape(-1)
    gathered = np.stack([z[b * span:][idx].reshape(shape) for b in range(batch)])
    got = np.stack([uninterleave(y)[b * span:][idx].reshape(shape) for b in range(batch)])
    assert_close(got, TR.fft_nd(gathered, shape, "forward"), label="strided-2d vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_whdcn_channel_lane(impl, rng, assert_close):
    n, batch, C = 8, 2, 3
    lanes = rand_c(rng, (batch, C, n))
    _, y = _parity(_c2c([n], batch, layout={"whdcn": {"channels": C, "channelIndex": 2}}),
                   interleave(lanes.reshape(-1)), impl, assert_close, "whdcn")
    out = uninterleave(y).reshape(batch, C, n)
    assert_close(out[:, 2, :], TR.fft_nd(lanes[:, 2, :], [n], "forward"), label="whdcn lane")
    assert np.all(out[:, 0, :] == 0) and np.all(out[:, 1, :] == 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_r2c_strided_real_input(impl, rng, assert_close):
    n, batch, stride = 8, 2, 3
    span = (n - 1) * stride + 1
    x = rng.standard_normal(batch * span).astype(np.float32)
    opts = {"type": "r2c", "shape": [n], "direction": "forward", "batch": batch,
            "layout": {"inputStrides": [stride]}}
    _, y = _parity(opts, x, impl, assert_close, "r2c strided")
    gathered = np.stack([x[b * span: b * span + n * stride: stride] for b in range(batch)])
    assert_close(uninterleave(y), TR.r2c_packed(gathered.astype(np.float64), [n]),
                 label="r2c strided vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_c2r_strided_real_output(impl, rng, assert_close):
    n, batch, stride = 8, 2, 2
    x = rng.standard_normal((batch, n))
    opts = {"type": "c2r", "shape": [n], "direction": "inverse", "batch": batch,
            "normalize": "backward", "layout": {"outputStrides": [stride]}}
    _, y = _parity(opts, interleave(TR.r2c_packed(x, [n])), impl, assert_close, "c2r strided")
    span = (n - 1) * stride + 1
    got = np.stack([y[b * span: b * span + n * stride: stride] for b in range(batch)])
    assert_close(got, x, label="c2r strided round trip")


def test_layout_misuse():
    with pytest.raises(T.PlanError, match="f32"):
        T.create_plan(type="c2c", shape=[8], precision="bf16-storage",
                      layout={"strides": [2]}, device="cpu")
    plan = T.create_plan(type="c2c", shape=[8], batch=2, layout={"inputStrides": [4]},
                         device="cpu")
    with pytest.raises(T.PlanError, match="too small"):
        plan(torch.zeros(10, 2))
    with pytest.raises(T.PlanError, match="flat buffer"):
        plan(torch.zeros(2, 8, 2))
    with pytest.raises(T.PlanError, match="whdcn and explicit strides"):
        stages.resolve_side_layout((8,), (2,), 0, None, _lane())


def _lane():
    from webgpufft_tpu_torch.spec import normalize_spec
    return normalize_spec({"type": "c2c", "shape": [8],
                           "layout": {"whdcn": {"channels": 2}}}).layout.whdcn_input


# ---------------------------------------------------------------------------
# ioView
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("view,lo", [({"shape": [6]}, 0),
                                     ({"shape": [4], "placement": "center"}, 3),
                                     ({"shape": [6], "offset": [-2]}, None),
                                     ({"shape": [3], "offset": [20]}, None)])
def test_ioview_input(view, lo, impl, rng, assert_close):
    """A view smaller than the logical domain reads zero outside; offsets
    may be negative or push the view out of the domain altogether."""
    v = view["shape"][0]
    z = rand_c(rng, (2, v))
    _, y = _parity(_c2c([10], 2, ioView={"input": view}), interleave(z), impl, assert_close,
                   f"ioview-in {view}")
    if lo is not None:
        padded = np.zeros((2, 10), complex)
        padded[:, lo:lo + v] = z
        assert_close(uninterleave(y), TR.fft_nd(padded, [10], "forward"), label="vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_ioview_output_crop_and_embed(impl, rng, assert_close):
    z = rand_c(rng, (1, 8))
    ref = TR.fft_nd(z, [8], "forward")
    _, y = _parity(_c2c([8], 1, ioView={"output": {"shape": [5], "offset": [2]}}),
                   interleave(z), impl, assert_close, "ioview-crop")
    assert y.shape == (1, 5, 2)
    assert_close(uninterleave(y), ref[:, 2:7], label="ioview-crop vs numpy")
    _, y = _parity(_c2c([8], 1, ioView={"output": {"shape": [12], "offset": [-2],
                                                   "clearOutside": True}}),
                   interleave(z), impl, assert_close, "ioview-embed")
    y = uninterleave(y)
    assert_close(y[:, 2:10], ref, label="ioview-embed vs numpy")
    assert np.all(y[:, :2] == 0) and np.all(y[:, 10:] == 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_ioview_rank4(impl, rng, assert_close):
    shape, vshape = (4, 3, 2, 5), (3, 3, 2, 4)
    z = rand_c(rng, (1, *vshape))
    _, y = _parity(_c2c(shape, 1, ioView={"input": {"shape": list(vshape)}}), interleave(z),
                   impl, assert_close, "ioview-rank4")
    padded = np.zeros((1, *shape), complex)
    padded[:, :3, :, :, :4] = z
    assert_close(uninterleave(y), TR.fft_nd(padded, shape, "forward"), label="vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_ioview_2d_both_sides(impl, rng, assert_close):
    """Input and output views at once, with offsets on both axes."""
    z = rand_c(rng, (2, 3, 5))
    opts = _c2c((6, 8), 2, ioView={"input": {"shape": [3, 5], "offset": [1, -1]},
                                   "output": {"shape": [4, 10], "offset": [2, -1],
                                              "clearOutside": True}})
    _, y = _parity(opts, interleave(z), impl, assert_close, "ioview 2-D")
    padded = np.zeros((2, 6, 8), complex)
    padded[:, 1:4, 0:4] = z[:, :, 1:]
    ref = TR.fft_nd(padded, (6, 8), "forward")
    want = np.zeros((2, 4, 10), complex)
    want[:, :, 1:9] = ref[:, 2:6, :]
    assert_close(uninterleave(y), want, label="ioview 2-D vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_r2c_ioview_on_packed_output(impl, rng, assert_close):
    x = rng.standard_normal((1, 16)).astype(np.float32)
    opts = {"type": "r2c", "shape": [16], "direction": "forward", "batch": 1,
            "ioView": {"output": {"shape": [4]}}}
    _, y = _parity(opts, x, impl, assert_close, "r2c packed ioview")
    assert_close(uninterleave(y), TR.r2c_packed(x.astype(np.float64), [16])[:, :4],
                 label="r2c packed ioview vs numpy")


# ---------------------------------------------------------------------------
# zeroPad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_zeropad_read_write(impl, rng, assert_close):
    z = rand_c(rng, (2, 12))
    opts = _c2c([12], 2, zeroPad={"read": {"start": [2], "end": [10]},
                                  "write": {"start": [1], "end": [11]}})
    _, y = _parity(opts, interleave(z), impl, assert_close, "zeropad")
    zin = z.copy()
    zin[:, :2] = 0
    zin[:, 10:] = 0
    ref = TR.fft_nd(zin, [12], "forward")
    ref[:, :1] = 0
    ref[:, 11:] = 0
    assert_close(uninterleave(y), ref, label="zeropad vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_zeropad_2d(impl, rng, assert_close):
    z = rand_c(rng, (1, 6, 8))
    opts = _c2c((6, 8), 1, zeroPad={"read": {"start": [1, 0], "end": [5, 6]}})
    _, y = _parity(opts, interleave(z), impl, assert_close, "zeropad 2-D")
    zin = np.zeros_like(z)
    zin[:, 1:5, 0:6] = z[:, 1:5, 0:6]
    assert_close(uninterleave(y), TR.fft_nd(zin, (6, 8), "forward"), label="vs numpy")


def test_zeropad_validation():
    with pytest.raises(T.PlanError, match="start"):
        T.create_plan(type="c2c", shape=[8], zeroPad={"read": {"start": [5], "end": [3]}},
                      device="cpu")
    with pytest.raises(T.PlanError, match="rank"):
        T.create_plan(type="c2c", shape=[8, 8], zeroPad={"read": {"start": [1]}},
                      device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
def test_zeropad_r2c_write_packed_domain(impl, rng, assert_close):
    x = rng.standard_normal((1, 16)).astype(np.float32)
    opts = {"type": "r2c", "shape": [16], "direction": "forward", "batch": 1,
            "zeroPad": {"write": {"start": [0], "end": [3]}}}
    _, y = _parity(opts, x, impl, assert_close, "r2c zeroWrite")
    ref = TR.r2c_packed(x.astype(np.float64), [16])
    ref[:, 3:] = 0
    assert_close(uninterleave(y), ref, label="r2c zeroWrite vs numpy")


# ---------------------------------------------------------------------------
# bf16-storage: the port computes in f32 between the bf16 load and store, the
# JAX package runs one bf16 matmul pass; both are held to the JAX tests'
# limits against numpy on the bf16-rounded input
# ---------------------------------------------------------------------------

def _bf16_round(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_storage_c2c(impl, rng):
    z = rand_c(rng, (2, 64)) * 0.5
    opts = _c2c([64], 2, precision="f16-storage")       # normalized to bf16-storage
    jplan, tplan, jy, ty = run_both(opts, interleave(z), impl=impl)
    assert tplan.spec.precision == "bf16-storage"
    assert not any("fused-l" in r or "fused-c" in r for r in tplan.route.reasons)
    if impl == "xla":
        # the route equals the JAX package's but for its one-pass bf16
        # contraction, which the port (f32 between load and store) has not;
        # the precision-dependent default of matmulPrecision is no knob the
        # caller set, and is not recorded as ignored
        assert "mxu-precision:default" in jplan.route.reasons
        assert tplan.route.reasons == tuple(
            r for r in jplan.route.reasons if r != "mxu-precision:default")
    else:
        assert "fused-requires-f32" in tplan.route.reasons
    ref = TR.fft_nd(z, [64], "forward")
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(uninterleave(ty) - ref)) / scale < 3e-2
    assert np.max(np.abs(ty - jy)) / scale < 3e-2


def test_bf16_storage_dtype_enforced():
    plan = T.create_plan(type="c2c", shape=[8], batch=1, precision="bf16-storage",
                         device="cpu")
    y = plan(torch.zeros((1, 8, 2), dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    with pytest.raises(T.PlanError, match="dtype"):
        plan(torch.zeros((1, 8, 2), dtype=torch.float32))
    f32 = T.create_plan(type="c2c", shape=[8], batch=1, device="cpu")
    with pytest.raises(T.PlanError, match="dtype"):
        f32(torch.zeros((1, 8, 2), dtype=torch.bfloat16))


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_storage_with_ioview(impl, rng):
    z = rand_c(rng, (2, 6)) * 0.5
    opts = _c2c([8], 2, precision="bf16-storage", ioView={"input": {"shape": [6]}})
    _, _, jy, ty = run_both(opts, interleave(z), impl=impl)
    padded = np.zeros((2, 8), complex)
    padded[:, :6] = uninterleave(_bf16_round(interleave(z)))
    ref = TR.fft_nd(padded, [8], "forward")
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(uninterleave(ty) - ref)) / scale < 2e-2
    assert np.max(np.abs(ty - jy)) / scale < 2e-2


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_storage_ioview_keep_outside(impl, rng):
    z = rand_c(rng, (1, 6)) * 0.5
    opts = _c2c([8], 1, precision="bf16-storage",
                ioView={"input": {"shape": [6]}, "output": {"shape": [12], "offset": [-2]}})
    sent = np.full((1, 12, 2), 7.5, np.float32)
    _, _, jy, ty = run_both(opts, interleave(z), impl=impl, out=sent)
    assert np.all(ty[:, :2] == 7.5) and np.all(ty[:, 10:] == 7.5)
    pad = np.zeros((1, 8), complex)
    pad[:, :6] = uninterleave(_bf16_round(interleave(z)))
    ref = TR.fft_nd(pad, [8], "forward")
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(uninterleave(ty[:, 2:10]) - ref)) / scale < 2e-2
    assert np.max(np.abs(ty - jy)) / scale < 2e-2


@pytest.mark.parametrize("kind", ["r2c", "dct2"])
def test_bf16_storage_real_plans(kind, rng):
    x = (rng.standard_normal((2, 32)) * 0.5).astype(np.float32)
    opts = {"type": kind, "shape": [32], "batch": 2, "direction": "forward",
            "precision": "bf16-storage"}
    _, tplan, jy, ty = run_both(opts, x)
    xr = _bf16_round(x).astype(np.float64)
    ref = (interleave(TR.r2c_packed(xr, [32])) if kind == "r2c"
           else TR.dct_nd(xr, (32,), "dct2", "forward"))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(ty - ref)) / scale < 2e-2
    assert np.max(np.abs(ty - jy)) / scale < 3e-2


# ---------------------------------------------------------------------------
# exec-time offsets, out=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", [{"inputStrides": [1], "outputStrides": [1]}, None])
def test_exec_time_offsets(layout, impl, rng, assert_close):
    """Runtime input/output offsets on flat-layout sides, and on shaped
    sides (which lower to a contiguous flat view)."""
    n, batch = 8, 2
    z = rand_c(rng, (40,))
    opts = _c2c([n], batch, **({"layout": layout} if layout else {}))
    ref = TR.fft_nd(z[3:3 + batch * n].reshape(batch, n), [n], "forward")
    tplan, y = _parity(opts, interleave(z), impl, assert_close, "in_off",
                       input_offset_elements=3)
    assert_close(uninterleave(y).reshape(-1)[:batch * n].reshape(batch, n), ref,
                 label="in_off vs numpy")
    out = np.full((40, 2), 7.5, np.float32)
    _, y2 = _parity(opts, interleave(z), impl, assert_close, "out_off", out=out,
                    input_offset_elements=3, output_offset_elements=4)
    y2 = uninterleave(y2)
    assert np.all(y2[:4] == 7.5 + 7.5j) and np.all(y2[4 + batch * n:] == 7.5 + 7.5j)
    assert_close(y2[4:4 + batch * n].reshape(batch, n), ref, label="out_off vs numpy")
    if layout is None:
        with pytest.raises(T.PlanError, match="flat buffer"):
            tplan(torch.zeros(batch, n, 2), input_offset_elements=2)


@pytest.mark.parametrize("impl", IMPLS)
def test_exec_output_offset_with_keep_outside_crop(impl, rng, assert_close):
    """Shaped output side + exec-time offset + a keep-outside view: the
    write is a scatter restricted to the view/logical overlap."""
    z = rand_c(rng, (2, 8))
    opts = _c2c([8], 2, ioView={"output": {"shape": [12], "offset": [-2]}})
    out = np.full((40, 2), 7.5, np.float32)
    _, y = _parity(opts, interleave(z), impl, assert_close, "offset + keep-outside", out=out,
                   output_offset_elements=5)
    y, ref = uninterleave(y), TR.fft_nd(z, [8], "forward")
    for b in range(2):
        cells = y[5 + 12 * b: 5 + 12 * (b + 1)]
        assert_close(cells[2:10], ref[b], label=f"b{b}")
        assert np.all(cells[:2] == 7.5 + 7.5j) and np.all(cells[10:] == 7.5 + 7.5j)
    assert np.all(y[:5] == 7.5 + 7.5j) and np.all(y[29:] == 7.5 + 7.5j)


def test_exec_offset_eager_validation():
    n, batch = 8, 2
    plan = T.create_plan(_c2c([n], batch, layout={"inputStrides": [1], "outputStrides": [1]}),
                         device="cpu")
    x = torch.zeros(batch * n, 2)
    with pytest.raises(T.PlanError, match="too small"):
        plan(torch.zeros(batch * n + 1, 2), input_offset_elements=2)
    with pytest.raises(T.PlanError, match="requires out="):
        plan(x, output_offset_elements=4)
    with pytest.raises(T.PlanError, match="too small"):
        plan(x, out=torch.zeros(batch * n, 2), output_offset_elements=1)
    with pytest.raises(T.PlanError, match=">= 0"):
        plan(x, input_offset_elements=-1)
    with pytest.raises(T.PlanError, match=">= 0"):
        plan(x, out=torch.zeros(40, 2), output_offset_elements=-1)


def test_out_requires_mergeable_output():
    plan = T.create_plan(type="c2c", shape=[8], batch=1, device="cpu")
    with pytest.raises(T.PlanError, match="out="):
        plan(torch.zeros(1, 8, 2), out=torch.zeros(8, 2))
    with pytest.raises(T.PlanError, match="does not take kernel"):
        plan(torch.zeros(1, 8, 2), kernel=np.zeros(3, np.float32))
    with pytest.raises(T.PlanError, match="torch.Tensor"):
        plan(np.zeros((1, 8, 2), np.float32))
    # a tensor that requires grad runs and carries the graph
    x = torch.ones(1, 8, 2, requires_grad=True)
    g, = torch.autograd.grad(plan(x).pow(2).sum(), x)
    assert torch.allclose(g, 2 * 8 * x.detach(), atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_strided_output_merge_preserves_existing(impl, rng, assert_close):
    n, stride = 6, 3
    x = rng.standard_normal((1, n)).astype(np.float32)
    opts = {"type": "dct2", "shape": [n], "direction": "forward", "batch": 1,
            "layout": {"outputStrides": [stride]}}
    sentinel = np.full(((n - 1) * stride + 1,), 7.5, np.float32)
    _, y = _parity(opts, x, impl, assert_close, "merged strided out", out=sentinel)
    assert_close(y[::stride], TR.dct_nd(x, (n,), "dct2", "forward")[0], label="vs numpy")
    assert np.all(y[1::stride] == 7.5) and np.all(y[2::stride] == 7.5)


@pytest.mark.parametrize("impl", IMPLS)
def test_ioview_keep_outside_contiguous_out(impl, rng, assert_close):
    z = rand_c(rng, (1, 8))
    ref = TR.fft_nd(z, [8], "forward")
    sentinel = np.full((1, 12, 2), 7.5, np.float32)
    _, y = _parity(_c2c([8], 1, ioView={"output": {"shape": [12], "offset": [-2]}}),
                   interleave(z), impl, assert_close, "keep-outside", out=sentinel)
    y = uninterleave(y)
    assert_close(y[:, 2:10], ref, label="keep-outside overlap")
    assert np.all(y[:, :2] == 7.5 + 7.5j) and np.all(y[:, 10:] == 7.5 + 7.5j)
    # clearOutside=true zeroes the rest even with out= given
    _, y2 = _parity(_c2c([8], 1, ioView={"output": {"shape": [12], "offset": [-2],
                                                    "clearOutside": True}}),
                    interleave(z), impl, assert_close, "clear-outside", out=sentinel)
    y2 = uninterleave(y2)
    assert np.all(y2[:, :2] == 0) and np.all(y2[:, 10:] == 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_ioview_keep_outside_strided_out(impl, rng, assert_close):
    z = rand_c(rng, (1, 8))
    ref = TR.fft_nd(z, [8], "forward")
    stride = 2
    opts = _c2c([8], 1, ioView={"output": {"shape": [12], "offset": [-2]}},
                layout={"outputStrides": [stride]})
    sentinel = np.full(((12 - 1) * stride + 1, 2), 7.5, np.float32)
    _, y = _parity(opts, interleave(z), impl, assert_close, "strided keep", out=sentinel)
    y = uninterleave(y)
    strided = y[::stride]
    assert_close(strided[2:10], ref[0], label="strided keep vs numpy")
    assert np.all(strided[:2] == 7.5 + 7.5j) and np.all(strided[10:] == 7.5 + 7.5j)
    assert np.all(y[1::stride] == 7.5 + 7.5j)


@pytest.mark.parametrize("impl", IMPLS)
def test_ioview_keep_outside_empty_overlap(impl, assert_close):
    """A view wholly outside the logical domain writes nothing."""
    opts = _c2c([8], 1, ioView={"output": {"shape": [4], "offset": [20]}},
                layout={"outputStrides": [1]})
    sentinel = np.full((4, 2), 7.5, np.float32)
    _, y = _parity(opts, np.ones((1, 8, 2), np.float32), impl, assert_close, "empty overlap",
                   out=sentinel)
    assert np.all(y == 7.5)


@pytest.mark.parametrize("opts,x_shape,out_shape", [
    (_c2c([8], 1, layout={"outputStrides": [2]}), (1, 8, 2), (15, 2)),
    (_c2c([8], 1, ioView={"output": {"shape": [12], "offset": [-2]}}), (1, 8, 2), (1, 12, 2)),
    (_c2c([8], 1, ioView={"output": {"shape": [12], "offset": [-2], "clearOutside": True}}),
     (1, 8, 2), (1, 12, 2)),
    (_c2c([8], 1), (8, 2), (20, 2)),
])
def test_out_is_written_in_place_and_returned(opts, x_shape, out_shape):
    """torch's idiom for ``out=``: the caller's tensor is written and is the
    returned object."""
    plan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    out = torch.full(out_shape, 7.5)
    kw = {"input_offset_elements": 0, "output_offset_elements": 3} if x_shape == (8, 2) else {}
    y = plan(torch.ones(x_shape), out=out, **kw)
    assert y is out
    assert not torch.all(out == 7.5)
    if "ioView" in opts:
        with pytest.raises(T.PlanError, match="out= has shape"):
            plan(torch.ones(x_shape), out=torch.zeros(1, 11, 2))


# ---------------------------------------------------------------------------
# inPlace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_in_place_with_input_offset_bluestein(impl, rng, assert_close):
    """inPlace + a non-zero input offset on a Bluestein length: layout mode
    declines the in-place write and the combination still computes."""
    n, off = 34, 5
    z = rand_c(rng, (off + n,))
    opts = _c2c([n], 1, inPlace=True,
                layout={"inputStrides": [1], "inputOffsetElements": off, "outputStrides": [1]})
    tplan, y = _parity(opts, interleave(z), impl, assert_close, "inplace+offset")
    assert not tplan.in_place
    assert_close(uninterleave(y)[:n], TR.fft_nd(z[off:off + n][None], [n], "forward")[0],
                 label="inplace+offset vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(16,), (4, 6), (34,)])
def test_in_place_writes_the_callers_tensor(shape, impl, rng, assert_close):
    z = rand_c(rng, (2, *shape))
    tplan, y = _parity(_c2c(shape, 2, inPlace=True), interleave(z), impl, assert_close,
                       "inPlace")
    assert tplan.in_place
    x = torch.from_numpy(interleave(z))
    got = tplan(x)
    assert got is x
    assert_close(x.numpy(), y, label="inPlace result in the input tensor")
    fresh = T.create_plan(_c2c(shape, 2), device="cpu", cache=T.PlanCache())
    x2 = torch.from_numpy(interleave(z))
    assert fresh(x2) is not x2 and np.array_equal(x2.numpy(), interleave(z))


# ---------------------------------------------------------------------------
# accepted no-op knobs, forced axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_webgpu_tuning_knobs_ignored(impl, rng, assert_close):
    z = rand_c(rng, (2, 16))
    knobs = {"workgroupSizeX": 256, "maxStorageBufferBindingSize": 1 << 20,
             "transposeMinElements": 4096, "disableTranspose": False,
             "largeChunkMaxBatches": 4, "raderMaxPrime": 4096}
    tplan, y = _parity(_c2c([16], 2, tuning=knobs), interleave(z), impl, assert_close, "knobs")
    assert_close(uninterleave(y), TR.fft_nd(z, [16], "forward"), label="knobs vs numpy")
    for key in list(knobs)[:5]:
        assert f"ignored-webgpu-knob:{key}" in tplan.route.reasons, tplan.route.reasons
    with pytest.raises(T.PlanError, match="unknown tuning key"):
        T.create_plan(type="c2c", shape=[16], tuning={"definitelyNotAKnob": 1}, device="cpu")


def test_forced_rader_respects_max_prime():
    with pytest.raises(T.PlanError, match="raderMaxPrime"):
        T.create_plan(type="c2c", shape=[5003], batch=1, device="cpu",
                      tuning={"forceRaderAxes": [0], "raderMaxPrime": 4096})


# ---------------------------------------------------------------------------
# the stage functions on their own
# ---------------------------------------------------------------------------

def test_flat_layout_indices_are_built_once_with_python_offsets():
    lay = stages.FlatLayout((3, 2), (4, 1), 1, 20, 2, True, torch.device("cpu"))
    assert lay.idx.dtype == torch.int64 and tuple(lay.idx.shape) == (2, 3, 2)
    assert lay.need == 1 + 20 + 2 * 4 + 1 + 1
    assert lay.idx[1, 2, 1].item() == 1 + 20 + 8 + 1
    flat = torch.arange(80, dtype=torch.float32).reshape(40, 2)
    got = stages.gather_flat(flat, lay, extra_offset=2)
    assert got[1, 2, 1, 0].item() == 2 * (1 + 20 + 8 + 1 + 2)
    out = torch.zeros(40, 2)
    assert stages.scatter_flat(got, lay, out=out, extra_offset=2) is out
    assert torch.equal(out[lay.idx.reshape(-1) + 2], got.reshape(-1, 2))
    with pytest.raises(T.PlanError, match="too small"):
        stages.scatter_flat(got, lay, out=torch.zeros(10, 2))


def test_plan_introspection():
    plan = T.create_plan(_c2c([8, 8], 4), device="cpu", cache=T.PlanCache())
    assert plan.get_workspace_size_bytes() == 2 * 4 * 64 * 8
    assert plan.large_route_mode == plan.route.mode
    plan.destroy()
    assert plan.consts == {}
