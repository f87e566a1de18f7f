"""BufferView: the JAX package against the PyTorch port (``device="cpu"``).

Every case of ``tests/test_bufferview.py`` (the host upload helpers apart,
which the port has no counterpart of): segments in and out of a plan, the
logical range, and the misuse checks.
"""

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.core.cplx import interleave, uninterleave
from webgpufft_tpu_torch.utils import mathref as TR
from webgpufft_tpu_torch.utils.bufferview import resolve_flat_input

from torch_port_support import run_both


def _segs(rng, lengths):
    return [interleave(rng.standard_normal(n) + 1j * rng.standard_normal(n)) for n in lengths]


@pytest.mark.parametrize("lengths", [(3, 5, 2), (7,), (1, 1, 1, 1)])
def test_bufferview_pack_unpack(lengths, rng):
    segs = _segs(rng, lengths)
    tv, jv = T.BufferView(segs), W.BufferView(segs)
    flat = tv.pack()
    assert isinstance(flat, torch.Tensor) and tuple(flat.shape) == (sum(lengths), 2)
    assert np.array_equal(flat.numpy(), np.asarray(jv.pack()))
    assert tv.interleaved and tv.segment_lengths == list(lengths)
    for got, want, jgot in zip(tv.unpack(flat), segs, jv.unpack(jv.pack())):
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), np.asarray(jgot))


@pytest.mark.parametrize("offset,length", [(2, 8), (0, 12), (5, None), (12, 0)])
def test_bufferview_offset_range(offset, length, rng):
    segs = [rng.standard_normal(5).astype(np.float32), rng.standard_normal(7).astype(np.float32)]
    tv = T.BufferView(segs, logical_offset=offset, length=length)
    jv = W.BufferView(segs, logical_offset=offset, length=length)
    assert not tv.interleaved
    assert np.array_equal(tv.pack().numpy(), np.asarray(jv.pack()))
    back = tv.unpack(tv.pack() + 1.0)
    jback = jv.unpack(jv.pack() + 1.0)
    for got, want in zip(back, jback):
        assert np.array_equal(got.numpy(), np.asarray(want))     # zero outside the view


def test_bufferview_from_array_and_resolve(rng):
    seg = torch.from_numpy(_segs(rng, (6,))[0])
    v = T.BufferView.from_array(seg, 1, 4)
    assert torch.equal(resolve_flat_input(v), seg[1:5])
    assert resolve_flat_input(seg) is seg
    assert v.pack().data_ptr() == seg[1:].data_ptr()      # one segment: a view, no copy


def test_bufferview_validation():
    with pytest.raises(ValueError, match="segment"):
        T.BufferView([])
    with pytest.raises(ValueError, match="rank"):
        T.BufferView([np.zeros((2, 2, 2), np.float32)])
    with pytest.raises(ValueError, match="rank"):
        T.BufferView([np.zeros((2, 2), np.float32), np.zeros(2, np.float32)])
    with pytest.raises(ValueError, match="n, 2"):
        T.BufferView([np.zeros((4, 3), np.float32)])
    with pytest.raises(ValueError, match="exceeds"):
        T.BufferView([np.zeros((12, 2), np.float32)], logical_offset=8, length=8)
    with pytest.raises(ValueError, match="out of range"):
        T.BufferView([np.zeros((12, 2), np.float32)], logical_offset=13)
    with pytest.raises(ValueError, match="expected"):
        T.BufferView([np.zeros((12, 2), np.float32)]).unpack(torch.zeros(3, 2))


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_exec_with_segmented_input(impl, rng, assert_close):
    """A strided-layout plan accepts a BufferView input."""
    n, batch = 8, 2
    z = rng.standard_normal(batch * n) + 1j * rng.standard_normal(batch * n)
    flat = interleave(z)
    opts = {"type": "c2c", "shape": [n], "batch": batch, "direction": "forward",
            "layout": {"inputStrides": [1]}}
    _, _, jy, ty = run_both(opts, [flat[:5], flat[5:9], flat[9:]], impl=impl)
    assert_close(ty, jy, label="segmented in")
    ref = TR.fft_nd(z.reshape(batch, n), [n], "forward")
    assert_close(uninterleave(ty).reshape(batch, n), ref, label="segmented in vs numpy")


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_exec_with_segmented_output(impl, rng, assert_close):
    n = 8
    z = rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
    opts = {"type": "c2c", "shape": [n], "batch": 1, "direction": "forward",
            "layout": {"outputStrides": [1]}}
    out = [np.zeros((3, 2), np.float32), np.zeros((5, 2), np.float32)]
    _, _, jy, ty = run_both(opts, interleave(z), impl=impl, out=out)
    assert [p.shape for p in ty] == [(3, 2), (5, 2)]
    for got, want in zip(ty, jy):
        assert_close(got, want, label="segmented out")
    assert_close(uninterleave(np.concatenate(ty)), TR.fft_nd(z, [n], "forward")[0],
                 label="segmented out vs numpy")


def test_exec_with_segmented_real_input_and_range(rng, assert_close):
    """Real segments with a logical range, on an r2c plan."""
    n, batch = 8, 2
    x = rng.standard_normal(3 + batch * n + 2).astype(np.float32)
    opts = {"type": "r2c", "shape": [n], "batch": batch, "direction": "forward",
            "layout": {"inputStrides": [1]}}
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    view = T.BufferView([x[:7], x[7:]], logical_offset=3, length=batch * n)
    got = tplan(view).numpy()
    ref = TR.r2c_packed(x[3:3 + batch * n].reshape(batch, n).astype(np.float64), [n])
    assert_close(uninterleave(got), ref, label="real segments")
