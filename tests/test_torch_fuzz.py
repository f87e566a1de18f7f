"""The local lanes of ``tests/test_fuzz.py`` through both packages.

The same seeded random specs (the JAX file's generators, copied: a seed gives
the same shape, batch, direction, normalize, family and staging in both
files) run through the JAX plan and the port's CPU plan from one options
dict; the port is held to the JAX package's output and to the numpy oracle
at the JAX file's tolerances (1e-5 * max|expected| for c2c and r2c/c2r,
5e-5 for dct/dst and fftconv).  Under ``impl: "auto"`` the JAX package takes
its einsum route and the port its kernels' plain versions, so the routes
differ by design; under ``xla`` they are equal field for field.  The
distributed, facade and DSP lanes of the JAX file wait for those modules.
"""

import numpy as np
import pytest

from torch_port_support import run_both, same_route
from webgpufft_tpu.core.cplx import interleave, uninterleave
from webgpufft_tpu.utils import mathref as R

AXIS_POOL = [2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 15, 16, 17, 20, 23, 30]
IMPLS = ["auto", "xla"]


def _rand_spec(rng):
    rank = int(rng.integers(1, 5))
    shape = [int(rng.choice(AXIS_POOL)) for _ in range(rank)]
    while np.prod(shape) > 4096:
        shape[int(rng.integers(0, rank))] = 2
    batch = int(rng.choice([1, 2, 3, 5]))
    direction = str(rng.choice(["forward", "inverse"]))
    normalize = str(rng.choice(["none", "backward", "unitary"]))
    return shape, batch, direction, normalize


def both(opts, x, impl, assert_close, label, tol=1e-5, **kw):
    jplan, tplan, jy, ty = run_both(opts, x, impl=impl, **kw)
    assert_close(ty, jy, atol_scale=tol, label=f"{label} port vs JAX ({impl})")
    assert tplan.route.axis_kinds == jplan.route.axis_kinds
    if impl == "xla":
        same_route(jplan, tplan)
    return ty


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(24))
def test_fuzz_c2c(seed, impl, assert_close):
    rng = np.random.default_rng(1000 + seed)
    shape, batch, direction, normalize = _rand_spec(rng)
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    label = f"fuzz c2c seed={seed} {shape} b{batch} {direction}/{normalize}"
    y = both({"type": "c2c", "shape": shape, "batch": batch, "direction": direction,
              "normalize": normalize}, interleave(z), impl, assert_close, label)
    assert_close(uninterleave(y), R.fft_nd(z, shape, direction, normalize), label=label)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(12))
def test_fuzz_r2c_c2r_roundtrip(seed, impl, assert_close):
    rng = np.random.default_rng(2000 + seed)
    shape, batch, _, _ = _rand_spec(rng)
    shape[0] = int(rng.choice([4, 6, 8, 9, 12, 16, 17, 30]))  # incl. odd/prime
    x = rng.standard_normal((batch, *shape)).astype(np.float32)
    y = both({"type": "r2c", "shape": shape, "direction": "forward", "batch": batch},
             x, impl, assert_close, f"fuzz r2c seed={seed} {shape}")
    assert_close(uninterleave(y), R.r2c_packed(x.astype(np.float64), shape),
                 label=f"fuzz r2c seed={seed} {shape}")
    back = both({"type": "c2r", "shape": shape, "direction": "inverse", "normalize": "backward",
                 "batch": batch}, y, impl, assert_close, f"fuzz c2r seed={seed} {shape}")
    assert_close(back, x, label=f"fuzz r2c/c2r roundtrip seed={seed} {shape}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(12))
def test_fuzz_dct_dst(seed, impl, assert_close):
    rng = np.random.default_rng(3000 + seed)
    shape, batch, direction, normalize = _rand_spec(rng)
    kind = str(rng.choice(["dct1", "dct2", "dct3", "dct4", "dst1", "dst2", "dst3", "dst4"]))
    if kind in ("dst1",):  # dst1 domain constraint: keep axes >= 2
        shape = [max(s, 2) for s in shape]
    x = rng.standard_normal((batch, *shape)).astype(np.float32)
    label = f"fuzz {kind} seed={seed} {shape} {direction}/{normalize}"
    y = both({"type": kind, "shape": shape, "batch": batch, "direction": direction,
              "normalize": normalize}, x, impl, assert_close, label, tol=5e-5)
    ref = R.dct_nd(x.astype(np.float64), shape, kind, direction)
    ref = ref * R.normalize_scale(normalize, direction, int(np.prod(shape)))
    assert_close(y, ref, atol_scale=5e-5, label=label)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(8))
def test_fuzz_fftconv(seed, impl, assert_close):
    rng = np.random.default_rng(4000 + seed)
    rank = int(rng.integers(1, 4))
    shape = [int(rng.choice([4, 6, 8, 9, 12, 16])) for _ in range(rank)]
    kshape = [int(rng.integers(1, s + 1)) for s in shape]
    boundary = str(rng.choice(["circular", "linear-full", "linear-same", "linear-valid"]))
    mode = str(rng.choice(["convolution", "correlation"]))
    batch = int(rng.choice([1, 2, 3]))
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    k = rng.standard_normal(kshape) + 1j * rng.standard_normal(kshape)
    label = f"fuzz fftconv seed={seed} {shape}*{kshape} {boundary}/{mode}"
    y = both({"type": "fftconv", "shape": shape, "batch": batch,
              "fftConv": {"boundary": boundary, "mode": mode, "kernelShape": kshape}},
             interleave(z), impl, assert_close, label, tol=5e-5, kernel=interleave(k))
    ref = R.fftconv(z, k, shape, batch=batch, mode=mode, boundary=boundary, kernel_shape=kshape)
    assert_close(uninterleave(y), ref, atol_scale=5e-5, label=label)
