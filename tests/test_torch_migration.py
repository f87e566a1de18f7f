"""The plan-API rows of ``tests/test_migration.py`` through the port.

Each claim of the migration table that concerns the plan layer is executed
on the port (CPU device) beside the JAX package: the reference-style options
dict, the exec surface, ``BufferView`` input, upload/download, inPlace and
f16-storage, snapshots and plan methods, the default stride order, the dct2
half-amplitude roundtrip, a plan pipeline composed in one function, and the
preset builders.  Outputs at 1e-5 * max|expected|.  The JAX rows about
``jax.jit`` composition become a plain function (PyTorch runs eagerly) that
is also differentiated.
"""

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from torch_port_support import run_both
from webgpufft_tpu.core.cplx import interleave, uninterleave
from webgpufft_tpu.utils import mathref as R


def test_reference_style_options_dict(rng, assert_close):
    opts = {"type": "c2c", "shape": [64], "direction": "forward", "batch": 2,
            "normalize": "none", "inPlace": False, "precision": "f32",
            "tuning": {"workgroupSizeX": 256, "raderMaxPrime": 4096,
                       "maxStorageBufferBindingSize": 1 << 27, "largeRoute": "auto",
                       "transposeMinElements": 4096, "disableTranspose": False}}
    z = rng.standard_normal((2, 64)) + 1j * rng.standard_normal((2, 64))
    jplan, tplan, jy, ty = run_both(opts, interleave(z))
    knobs = [r for r in jplan.route.reasons if r.startswith("ignored-webgpu-knob")]
    assert knobs and knobs == [r for r in tplan.route.reasons
                               if r.startswith("ignored-webgpu-knob")]
    assert_close(ty, jy, label="options dict port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, [64], "forward"), label="options dict")


def test_exec_surface(rng, assert_close):
    """plan(x), plan.exec(x, kernel=), plan.exec(x, out=)."""
    plan = T.create_plan({"type": "c2c", "shape": [16], "batch": 1}, device="cpu")
    x = interleave(rng.standard_normal(16) + 0j).reshape(1, 16, 2)
    xt = torch.from_numpy(x)
    assert torch.equal(plan(xt), plan.exec(xt))
    k = interleave(rng.standard_normal(16) + 0j)
    _, _, jy, ty = run_both({"type": "fftconv", "shape": [16], "batch": 1}, x, kernel=k)
    assert_close(ty, jy, label="exec kernel= port vs JAX")
    flat = interleave(rng.standard_normal(15) + 0j)
    _, tplan, jy, ty = run_both({"type": "c2c", "shape": [8], "batch": 1,
                                 "layout": {"strides": [2]}}, flat,
                                out=np.zeros((16, 2), np.float32))
    assert ty.shape == (16, 2)
    assert_close(ty, jy, label="exec out= port vs JAX")


def test_bufferview_flat_input(rng, assert_close):
    z = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    flat = interleave(z)
    opts = {"type": "c2c", "shape": [16], "batch": 1, "layout": {"strides": [1]}}
    _, _, jy, ty = run_both(opts, [flat[:10], flat[10:]])
    assert_close(ty, jy, label="BufferView port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z[None], [16], "forward")[0], label="BufferView")
    plan = T.create_plan(opts, device="cpu")
    view = T.BufferView([torch.from_numpy(flat[:10]), torch.from_numpy(flat[10:])], 0, 16)
    assert_close(plan(view).numpy(), jy, label="BufferView(segs, 0, 16)")


def test_upload_download_roundtrip(rng):
    z = rng.standard_normal((2, 8)) + 1j * rng.standard_normal((2, 8))
    x = T.upload_complex(z, device="cpu")
    assert tuple(x.shape) == (2, 8, 2) and x.dtype == torch.float32
    assert np.array_equal(x.numpy(), np.asarray(W.upload_complex(z)))
    back = T.download_complex(x)
    assert np.allclose(back, z, atol=1e-6)
    assert np.array_equal(back, W.download_complex(np.asarray(W.upload_complex(z))))


def test_inplace_and_f16_storage(rng, assert_close):
    p = T.create_plan({"type": "c2c", "shape": [16], "batch": 1, "inPlace": True}, device="cpu")
    assert p.spec.in_place
    x = torch.from_numpy(rng.standard_normal((1, 16, 2)).astype(np.float32))
    want = np.fft.fft(x.numpy()[..., 0] + 1j * x.numpy()[..., 1], axis=-1)
    y = p(x)
    assert y is x   # the port's inPlace writes the caller's tensor
    assert_close(uninterleave(y.numpy()), want, label="inPlace")
    p2 = T.create_plan({"type": "c2c", "shape": [16], "batch": 1,
                        "precision": "f16-storage"}, device="cpu")
    assert p2.spec.precision == "bf16-storage"


def test_snapshot_and_plan_methods():
    cache = T.PlanCache()
    plan = T.create_plan({"type": "c2c", "shape": [16], "batch": 2}, device="cpu", cache=cache)
    snap = T.export_plan_cache_snapshot(cache)
    assert T.import_plan_cache_snapshot(snap, cache=T.PlanCache(), device="cpu") == 1
    jplan = W.create_plan(type="c2c", shape=[16], batch=2, cache=W.PlanCache())
    assert plan.get_workspace_size_bytes() > 0
    psnap = plan.get_pipeline_cache_snapshot()
    assert psnap["schema"].startswith("webgpufft")
    assert set(psnap) == set(jplan.get_pipeline_cache_snapshot())
    plan.destroy()


def test_default_stride_order_claim(rng, assert_close):
    """Layout active with strides omitted means C order: the flat result
    equals the shaped one flattened."""
    shape = (4, 6)
    z = rng.standard_normal(24) + 1j * rng.standard_normal(24)
    buf = np.concatenate([[0.0 + 0j], z])
    _, _, jf, tf = run_both({"type": "c2c", "shape": list(shape), "batch": 1,
                             "layout": {"offsetElements": 1}}, interleave(buf))
    _, _, js, ts = run_both({"type": "c2c", "shape": list(shape), "batch": 1},
                            interleave(z.reshape(1, *shape)))
    assert_close(tf, jf, label="flat port vs JAX")
    assert_close(ts, js, label="shaped port vs JAX")
    assert np.max(np.abs(uninterleave(tf)[1:] - uninterleave(ts).reshape(-1))) < 1e-5


def test_dct2_backward_roundtrip_claim(rng, assert_close):
    """dct2 none-forward then backward-inverse recovers x / 2."""
    x = rng.standard_normal((2, 16)).astype(np.float32)
    _, _, jy, ty = run_both({"type": "dct2", "shape": [16], "batch": 2, "normalize": "none"}, x)
    assert_close(ty, jy, label="dct2 forward port vs JAX")
    _, _, jb, tb = run_both({"type": "dct2", "shape": [16], "batch": 2, "direction": "inverse",
                             "normalize": "backward"}, ty)
    assert_close(tb, jb, label="dct2 inverse port vs JAX")
    assert np.max(np.abs(tb * 2.0 - x)) < 1e-4


def test_pipeline_composes_in_one_function(rng, assert_close):
    """r2c -> pointwise -> c2r in one function: the JAX row composes it under
    one ``jax.jit``; the port runs eagerly and differentiates through it."""
    import jax
    import jax.numpy as jnp
    n = 64
    h = np.exp(-np.arange(n // 2 + 1) / 8.0).astype(np.float32)[None, :, None]
    jr2c = W.create_plan(type="r2c", shape=[n], batch=1)
    jc2r = W.create_plan(type="c2r", shape=[n], batch=1, direction="inverse",
                         normalize="backward")
    tr2c = T.create_plan({"type": "r2c", "shape": [n], "batch": 1}, device="cpu")
    tc2r = T.create_plan({"type": "c2r", "shape": [n], "batch": 1, "direction": "inverse",
                          "normalize": "backward"}, device="cpu")
    x = rng.standard_normal((1, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jc2r(jr2c(v) * jnp.asarray(h)))(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tc2r(tr2c(xt) * torch.from_numpy(h))
    assert tuple(y.shape) == (1, n) and bool(torch.isfinite(y).all())
    assert_close(y.detach().numpy(), want, label="lowpass port vs JAX")
    g, = torch.autograd.grad(y.sum(), xt)
    gw = np.asarray(jax.grad(lambda v: jc2r(jr2c(v) * jnp.asarray(h)).sum())(jnp.asarray(x)))
    assert_close(g.numpy(), gw, label="lowpass gradient port vs JAX")


def test_presets_row():
    frag = {"shape": [16], "batch": 1, "kernelCount": 2,
            "input": {"channels": 2, "channelIndex": 0},
            "output": {"channels": 4, "channelIndex": 0, "kernelStepChannels": 2}}
    preset = T.create_fftconv_kernel_major_channel_lane_preset(frag)
    assert preset == W.create_fftconv_kernel_major_channel_lane_preset(frag)
    plan = T.create_plan({"type": "fftconv", **preset}, device="cpu")
    jplan = W.create_plan({"type": "fftconv", **preset})
    assert plan.route.mode in ("xla", "overlap-save", "pallas-fused", "pallas-mixed")
    assert plan.route.axis_kinds == jplan.route.axis_kinds
