"""conv2d: the JAX package against the PyTorch port (``device="cpu"``).

Every case of ``tests/test_conv2d.py``: the same numpy data and kernel
through both plans and through the numpy oracle (cross-correlation
indexing, zero boundary, stride 1), within 1e-5 * max|expected|, with equal
route metadata.  ``impl`` does not enter: neither package runs a kernel of
its own here.
"""

import numpy as np
import pytest
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu.utils import mathref as R
from webgpufft_tpu_torch.core.cplx import interleave, uninterleave
from webgpufft_tpu_torch.utils import mathref as TR

from torch_port_support import run_both, same_route


def _parity(conv, shape, batch, make, impl, assert_close, label):
    """``make(hin, win)`` -> (data, kernel) as the plans take them."""
    opts = {"type": "conv2d", "shape": list(shape), "batch": batch, "conv": conv}
    probe = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    x, w = make(*probe.in_shape)
    jplan, tplan, jy, ty = run_both(opts, x, impl=impl, kernel=w)
    assert (tplan.in_shape, tuple(tplan.pad)) == (jplan.in_shape, tuple(jplan.pad))
    assert ty.dtype == np.float32 and ty.shape == jy.shape
    assert_close(ty, jy, label=label)
    same_route(jplan, tplan)
    return tplan, x, w, ty


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("padding", ["same", "valid"])
def test_real_conv(k, padding, impl, rng, assert_close):
    def make(hin, win):
        return (rng.standard_normal((2, hin, win)).astype(np.float32),
                rng.standard_normal((k, k)).astype(np.float32))

    plan, x, w, y = _parity({"kernelSize": k, "padding": padding}, (8, 6), 2, make, impl,
                            assert_close, f"real k={k} {padding}")
    assert y.shape == (2, 8, 6)
    assert_close(y, TR.conv2d_direct(x, w, pad=plan.pad), label="vs numpy")


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("ktype", ["real", "complex"])
def test_complex_data(ktype, k, impl, rng, assert_close):
    held = {}

    def make(hin, win):
        held["x"] = rng.standard_normal((2, hin, win)) + 1j * rng.standard_normal((2, hin, win))
        if ktype == "real":
            held["w"] = rng.standard_normal((k, k))
            return interleave(held["x"]), held["w"].astype(np.float32)
        held["w"] = rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
        return interleave(held["x"]), interleave(held["w"])

    plan, _, _, y = _parity({"kernelSize": k, "padding": "same", "kernelType": ktype},
                            (6, 7), 2, make, impl, assert_close, f"cplx/{ktype}")
    ref = TR.conv2d_direct(held["x"], held["w"], pad=plan.pad)
    assert_close(uninterleave(y), ref, label=f"cplx/{ktype} vs numpy")


@pytest.mark.parametrize("pad", [(2, 0, 1, 0), (0, 1, 0, 2), (1, 1, 1, 1)])
def test_explicit_padding(pad, rng, assert_close):
    def make(hin, win):
        return (rng.standard_normal((1, hin, win)).astype(np.float32),
                rng.standard_normal((3, 3)).astype(np.float32))

    plan, x, w, y = _parity({"kernelSize": 3, "padding": "explicit", "pad": list(pad)},
                            (8, 8), 1, make, "auto", assert_close, "explicit pad")
    assert plan.in_shape == (8 + 2 - pad[0] - pad[1], 8 + 2 - pad[2] - pad[3])
    assert_close(y, TR.conv2d_direct(x, w, pad=pad), label="explicit pad vs numpy")


def test_validation():
    with pytest.raises(T.PlanError, match="kernelSize"):
        T.create_plan(type="conv2d", shape=[8, 8], conv={"kernelSize": 5}, device="cpu")
    with pytest.raises(T.PlanError, match="conv"):
        T.create_plan(type="conv2d", shape=[8, 8], device="cpu")
    with pytest.raises(T.PlanError, match="H, W"):
        T.create_plan(type="conv2d", shape=[8], conv={"kernelSize": 3}, device="cpu")
    with pytest.raises(T.PlanError, match="boundary"):
        T.create_plan(type="conv2d", shape=[8, 8], device="cpu",
                      conv={"kernelSize": 3, "boundary": "wrap"})
    plan = T.create_plan(type="conv2d", shape=[8, 8], conv={"kernelSize": 3}, device="cpu")
    with pytest.raises(T.PlanError, match="taps"):
        plan.exec(torch.zeros(1, 8, 8), kernel=np.zeros(4, np.float32))
    with pytest.raises(T.PlanError, match="kernel="):
        plan.exec(torch.zeros(1, 8, 8))
    cplan = T.create_plan(type="conv2d", shape=[8, 8], device="cpu",
                          conv={"kernelSize": 3, "kernelType": "complex"})
    with pytest.raises(T.PlanError, match="complex kernel"):
        cplan.exec(torch.zeros(1, 8, 8), kernel=np.zeros((3, 3, 2), np.float32))


@pytest.mark.parametrize("flag", [True, False])
def test_conv_runs_with_tf32_scoped_off(flag, monkeypatch):
    """The plan switches cuDNN's TF32 off for its own convolution call only:
    inside the call the flag reads False whatever the process has set, and
    afterwards the process's setting (and its other cuDNN flags) is back."""
    from webgpufft_tpu_torch.plans import conv2d as mod
    seen = []
    real = mod.F.conv2d

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled,
                     torch.backends.cudnn.benchmark))
        return real(*args, **kw)

    monkeypatch.setattr(mod.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    plan = T.create_plan(type="conv2d", shape=[8, 8], conv={"kernelSize": 3}, device="cpu",
                         cache=T.PlanCache())
    plan.exec(torch.ones(1, 8, 8), kernel=np.ones((3, 3), np.float32))
    assert seen == [(False, torch.backends.cudnn.enabled, True)]
    assert torch.backends.cudnn.allow_tf32 is flag and torch.backends.cudnn.benchmark is True


def test_mathref_conv2d_copy_matches(rng):
    x = rng.standard_normal((2, 5, 6)) + 1j * rng.standard_normal((2, 5, 6))
    w = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    assert np.array_equal(TR.conv2d_direct(x, w, pad=(1, 1, 1, 1)),
                          R.conv2d_direct(x, w, pad=(1, 1, 1, 1)))
