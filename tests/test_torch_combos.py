"""The case list of ``tests/test_combos.py`` through both packages.

Every case builds the JAX plan and the port's CPU plan from one options
dict (``torch_port_support.run_both``), runs both on the same numpy input
(from the ``rng`` seed) and holds the port's output to
1e-5 * max|expected| against the JAX package's and against the numpy oracle
the JAX test uses.  The JAX cases build under the default ``impl: "auto"``,
which is the einsum route there; the port routes ``auto`` to its kernels
(their plain versions on the CPU), so every case runs under ``auto`` (routes
differ by design, outputs must not) and under ``xla`` (routes equal field
for field).
"""

import numpy as np
import pytest

from torch_port_support import run_both, same_route
from webgpufft_tpu.core.cplx import interleave, uninterleave
from webgpufft_tpu.utils import mathref as R

IMPLS = ["auto", "xla"]


def rand_c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def both(opts, x, impl, assert_close, label, **kw):
    """Run both packages; the port's result against the JAX package's, the
    routes equal under "xla".  Returns the port's plan and result."""
    jplan, tplan, jy, ty = run_both(opts, x, impl=impl, **kw)
    assert_close(ty, jy, label=f"{label} port vs JAX ({impl})")
    assert tplan.route.axis_kinds == jplan.route.axis_kinds
    if impl == "xla":
        same_route(jplan, tplan)
    return tplan, ty


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(96, 105), (24, 25, 27), (8, 17, 6)])
def test_c2c_nd_mixed_sizes(shape, impl, rng, assert_close):
    z = rand_c(rng, (2, *shape))
    opts = {"type": "c2c", "shape": list(shape), "batch": 2, "direction": "forward"}
    _, y = both(opts, interleave(z), impl, assert_close, f"nd{shape}")
    assert_close(uninterleave(y), R.fft_nd(z, shape, "forward"), label=f"nd{shape} vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_c2c_strides_ioview_zeropad_combo(impl, rng, assert_close):
    logical, vshape, stride, batch = (12,), (8,), 3, 2
    span = (vshape[0] - 1) * stride + 1
    flat = rand_c(rng, (batch * span,))
    opts = {"type": "c2c", "shape": list(logical), "batch": batch, "direction": "forward",
            "layout": {"inputStrides": [stride]},
            "ioView": {"input": {"shape": list(vshape), "placement": "center"}},
            "zeroPad": {"read": {"start": [1], "end": [11]}}}
    _, y = both(opts, interleave(flat), impl, assert_close, "combo")
    gathered = np.stack([flat[b * span: b * span + vshape[0] * stride: stride]
                         for b in range(batch)])
    emb = np.zeros((batch, 12), complex)
    emb[:, 2:10] = gathered              # center: floor((12-8)/2) = 2
    emb[:, :1] = 0
    emb[:, 11:] = 0
    assert_close(uninterleave(y), R.fft_nd(emb, logical, "forward"), label="combo vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_r2c_packed_output_strides(impl, rng, assert_close):
    n, batch, stride = 17, 2, 2
    x = rng.standard_normal((batch, n)).astype(np.float32)
    opts = {"type": "r2c", "shape": [n], "direction": "forward", "batch": batch,
            "layout": {"outputStrides": [stride]}}
    _, y = both(opts, x, impl, assert_close, "r2c-out-strided")
    flat = uninterleave(y)
    ref = R.r2c_packed(x.astype(np.float64), [n])
    p0 = n // 2 + 1
    span = (p0 - 1) * stride + 1
    for b in range(batch):
        assert_close(flat[b * span: b * span + p0 * stride: stride], ref[b],
                     label=f"r2c-out-strided b{b}")


@pytest.mark.parametrize("impl", IMPLS)
def test_c2r_packed_input_strides(impl, rng, assert_close):
    n, batch, stride = 17, 2, 3
    x = rng.standard_normal((batch, n))
    packed = R.r2c_packed(x, [n])
    p0 = n // 2 + 1
    span = (p0 - 1) * stride + 1
    flat = np.zeros((batch * span,), complex)
    for b in range(batch):
        flat[b * span: b * span + p0 * stride: stride] = packed[b]
    opts = {"type": "c2r", "shape": [n], "direction": "inverse", "normalize": "backward",
            "batch": batch, "layout": {"inputStrides": [stride]}}
    _, y = both(opts, interleave(flat), impl, assert_close, "c2r strided packed in")
    assert_close(y, x, label="c2r strided packed in vs input")


@pytest.mark.parametrize("impl", IMPLS)
def test_dct2_strides_ioview_zeropad_combo(impl, rng, assert_close):
    logical, vshape, stride, batch = (10,), (6,), 2, 2
    span = (vshape[0] - 1) * stride + 1
    flat = rng.standard_normal((batch * span,)).astype(np.float32)
    opts = {"type": "dct2", "shape": list(logical), "batch": batch, "direction": "forward",
            "layout": {"inputStrides": [stride]},
            "ioView": {"input": {"shape": list(vshape)}},
            "zeroPad": {"write": {"start": [0], "end": [8]}}}
    _, y = both(opts, flat, impl, assert_close, "dct combo")
    gathered = np.stack([flat[b * span: b * span + vshape[0] * stride: stride]
                         for b in range(batch)])
    emb = np.zeros((batch, 10))
    emb[:, :6] = gathered
    ref = R.dct_nd(emb, logical, "dct2", "forward")
    ref[:, 8:] = 0
    assert_close(y, ref, label="dct combo vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,mode", [(17, "convolution"), (29, "correlation")])
def test_fftconv_prime_lengths(n, mode, impl, rng, assert_close):
    x, k = rand_c(rng, (2, n)), rand_c(rng, (n,))
    opts = {"type": "fftconv", "shape": [n], "batch": 2, "fftConv": {"mode": mode}}
    plan, y = both(opts, interleave(x), impl, assert_close, f"fftconv p{n}",
                   kernel=interleave(k))
    assert_close(uninterleave(y), R.fftconv(x, k, [n], batch=2, mode=mode),
                 label=f"fftconv p{n} vs numpy")
    assert "rader" in plan.route.axis_kinds


@pytest.mark.parametrize("impl", IMPLS)
def test_fftconv_2d_odd(impl, rng, assert_close):
    shape, kshape = [8, 9], [3, 2]
    x, k = rand_c(rng, (2, 8, 9)), rand_c(rng, (3, 2))
    opts = {"type": "fftconv", "shape": shape, "batch": 2,
            "fftConv": {"boundary": "linear-full", "kernelShape": kshape}}
    _, y = both(opts, interleave(x), impl, assert_close, "fftconv2d", kernel=interleave(k))
    ref = R.fftconv(x, k, shape, batch=2, boundary="linear-full", kernel_shape=kshape)
    assert_close(uninterleave(y), ref, label="fftconv2d vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
def test_c2c_roundtrip_n210(impl, rng, assert_close):
    n = 210
    z = rand_c(rng, (2, n))
    _, y = both({"type": "c2c", "shape": [n], "batch": 2, "direction": "forward"},
                interleave(z), impl, assert_close, "n210 forward")
    _, back = both({"type": "c2c", "shape": [n], "batch": 2, "direction": "inverse",
                    "normalize": "backward"}, y, impl, assert_close, "n210 inverse")
    assert_close(uninterleave(back), z, label="n210 roundtrip")
