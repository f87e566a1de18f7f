"""The port's pyfftw namespace (webgpufft_tpu_torch.pyfftw) against the JAX
package's, case by case as tests/test_pyfftw.py, with the wisdom crossing
both ways between the two packages.

Arrays are numpy in and out in both; the port's transforms run on the CPU
device (``device="cpu"`` on FFTW and builders, a ``default_device`` block
for the interfaces).  Same seeded input, 1e-5 of max|expected|.
"""

import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu import pyfftw as jpf
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import pyfftw as tpf
from torch_port_support import assert_close_c


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pair(a, out_shape=None, out_dtype=None, **kw):
    """The same planned transform in both packages, each with its own
    output array."""
    def out():
        return np.zeros(a.shape if out_shape is None else out_shape,
                        a.dtype if out_dtype is None else out_dtype)
    return jpf.FFTW(a.copy(), out(), **kw), tpf.FFTW(a.copy(), out(), device="cpu", **kw)


def _same(pair, tol=1e-5, call=True, **kw):
    J, P = pair
    if call:
        want, got = J(**kw), P(**kw)
        assert got is P.output_array
    else:
        J.execute()
        P.execute()
        want, got = J.output_array, P.output_array
    assert got.dtype == want.dtype
    assert_close_c(got, want, tol)
    assert J.N == P.N
    return got


def test_surface():
    assert sorted(tpf.__all__) == sorted(jpf.__all__)
    assert T.pyfftw is tpf
    assert sorted(vars(tpf.builders)) == sorted(vars(jpf.builders))
    for ns in ("numpy_fft", "scipy_fft", "scipy_fftpack"):
        assert sorted(vars(getattr(tpf.interfaces, ns))) == \
            sorted(vars(getattr(jpf.interfaces, ns))), ns


# ------------------------------------------------------------ FFTW object

def test_c2c_forward_backward_raw_ortho(rng):
    a = _cplx(rng, 4, 16)
    y = _same(_pair(a, axes=(-1,)))
    assert_close_c(y, np.fft.fft(a, axis=-1), 3e-5)
    _same(_pair(a, direction="FFTW_BACKWARD"))
    _same(_pair(a), call=False)
    _same(_pair(a, direction="FFTW_BACKWARD"), call=False)   # raw: N * ifft
    _same(_pair(a), ortho=True, normalise_idft=False)
    _same(_pair(a, direction="FFTW_BACKWARD"), ortho=True, normalise_idft=False)


def test_ortho_and_normalise_both_raises(rng):
    a = _cplx(rng, 8)
    with pytest.raises(ValueError, match="ortho"):
        tpf.FFTW(a, np.zeros_like(a), ortho=True, normalise_idft=True,
                 device="cpu")
    obj = tpf.FFTW(a, np.zeros_like(a), device="cpu")
    with pytest.raises(ValueError, match="ortho"):
        obj(ortho=True, normalise_idft=True)


def test_r2c_and_c2r(rng):
    x = rng.standard_normal((3, 10)).astype(np.float32)
    spec = _same(_pair(x, (3, 6), np.complex64))
    back = _same(_pair(spec.copy(), (3, 10), np.float32,
                       direction="FFTW_BACKWARD"))
    assert_close_c(back, x, 1e-4)


@pytest.mark.parametrize("make,match", [
    (lambda pf, kw: pf.FFTW(np.zeros(10, np.float32), np.zeros(6, np.complex64),
                            direction="FFTW_BACKWARD", **kw), "forward-only"),
    (lambda pf, kw: pf.FFTW(np.zeros(6, np.complex64), np.zeros(10, np.float32),
                            **kw), "backward-only"),
    (lambda pf, kw: pf.FFTW(np.zeros(8, np.complex64), np.zeros(9, np.complex64),
                            **kw), "shape"),
    (lambda pf, kw: pf.FFTW(np.zeros(8, np.float32), np.zeros(8, np.complex64),
                            **kw), "packed"),
    (lambda pf, kw: pf.FFTW(np.zeros(8, np.complex64), np.zeros(8, np.complex64),
                            flags=("FFTW_BOGUS",), **kw), "flags"),
    (lambda pf, kw: pf.FFTW(np.zeros(8, np.complex64), np.zeros(8, np.complex64),
                            direction="SIDEWAYS", **kw), "direction"),
    (lambda pf, kw: pf.FFTW(np.zeros((4, 6), np.complex64),
                            np.zeros((4, 6), np.complex64), axes=(1, -1), **kw),
     "duplicate"),
])
def test_construction_errors_raise_in_both(make, match):
    with pytest.raises(ValueError, match=match):
        make(jpf, {})
    with pytest.raises(ValueError, match=match):
        make(tpf, {"device": "cpu"})


def test_multi_axis_c2c(rng):
    pair = _pair(_cplx(rng, 4, 6, 8), axes=(0, 2))
    _same(pair)
    assert pair[1].N == 32


@pytest.mark.parametrize("kind", [
    "FFTW_REDFT00", "FFTW_REDFT10", "FFTW_REDFT01", "FFTW_REDFT11",
    "FFTW_RODFT00", "FFTW_RODFT10", "FFTW_RODFT01", "FFTW_RODFT11",
    "FFTW_R2HC", "FFTW_HC2R", "FFTW_DHT"])
@pytest.mark.parametrize("n", [12, 13])
def test_r2r_kinds(rng, kind, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    _same(_pair(x, axes=(-1,), direction=(kind,)), call=False)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_halfcomplex_kinds_short_lengths(rng, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    for kind in ("FFTW_R2HC", "FFTW_HC2R") + (("FFTW_DHT",) if n > 1 else ()):
        _same(_pair(x, axes=(-1,), direction=(kind,)), call=False)


def test_r2r_logical_N_and_per_axis_composition(rng):
    x = rng.standard_normal(12).astype(np.float32)
    for kind, n in (("FFTW_REDFT00", 22), ("FFTW_RODFT00", 26),
                    ("FFTW_REDFT10", 24), ("FFTW_R2HC", 12),
                    ("FFTW_HC2R", 12), ("FFTW_DHT", 12)):
        assert tpf.FFTW(x, np.zeros_like(x), direction=(kind,),
                        device="cpu").N == n, kind
    x2 = rng.standard_normal((10, 8)).astype(np.float32)
    pair = _pair(x2, axes=(0, 1), direction=("FFTW_R2HC", "FFTW_REDFT10"))
    _same(pair, call=False)
    assert pair[1].N == 10 * 16
    x3 = rng.standard_normal((6, 4)).astype(np.float32)
    _same(_pair(x3, axes=(0,), direction=("FFTW_DHT",)), ortho=True,
          normalise_idft=False)


def test_nonplanning_flags_recorded(rng):
    a = _cplx(rng, 8)
    obj = tpf.FFTW(a, np.zeros_like(a),
                   flags=("FFTW_MEASURE", "FFTW_DESTROY_INPUT"),
                   threads=4, planning_timelimit=2.0, device="cpu")
    assert "FFTW_DESTROY_INPUT" in obj.ignored_options
    assert any(s.startswith("threads=") for s in obj.ignored_options)
    assert any(s.startswith("planning_timelimit=") for s in obj.ignored_options)
    assert obj.flags == ("FFTW_MEASURE", "FFTW_DESTROY_INPUT")
    assert obj.simd_aligned and obj.threads == 4 and obj.axes == (0,)
    assert obj.input_shape == obj.output_shape == (8,)
    assert obj.input_dtype == obj.output_dtype == np.complex64
    assert obj.get_input_array() is obj.input_array


def test_update_arrays_and_call_with_new_input(rng):
    a = _cplx(rng, 16)
    J, P = _pair(a)
    a2 = _cplx(rng, 16)
    oj, op = np.zeros_like(a2), np.zeros_like(a2)
    J.update_arrays(a2, oj)
    P.update_arrays(a2, op)
    J.execute()
    P.execute()
    assert_close_c(op, oj, 1e-5)
    with pytest.raises(ValueError, match="shape"):
        P.update_arrays(_cplx(rng, 8), np.zeros(8, np.complex64))
    with pytest.raises(ValueError, match="scheme"):
        P.update_arrays(np.zeros(16, np.float32), op)
    a3 = _cplx(rng, 16)
    assert_close_c(P(a3), J(a3), 1e-5)


def test_float64_arrays_accepted(rng):
    a = (rng.standard_normal(16) + 1j * rng.standard_normal(16))
    y = _same(_pair(a.astype(np.complex128)))
    assert y.dtype == np.complex128     # device f32, reported as c128


def test_device_is_taken_at_construction(rng):
    """No device and no GPU: planning raises (it does not fall back to the
    CPU); ``device="cpu"`` or an enclosing default_device block runs."""
    a = _cplx(rng, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpf.FFTW(a, np.zeros_like(a))
    with TF.default_device("cpu"):
        obj = tpf.FFTW(a, np.zeros_like(a))
        assert_close_c(obj(), np.fft.fft(a), 3e-5)


# --------------------------------------------------------------- builders

def _build_both(name, a, *args, **kw):
    kw.setdefault("planner_effort", "FFTW_ESTIMATE")
    return (getattr(jpf.builders, name)(a, *args, **kw),
            getattr(tpf.builders, name)(a, *args, device="cpu", **kw))


def test_builders_fft_roundtrip_and_crop_pad(rng):
    z = _cplx(rng, 32)
    J, P = _build_both("fft", z)
    assert_close_c(P(), J(), 1e-5)
    Ji, Pi = _build_both("ifft", P().copy())
    assert_close_c(Pi(), Ji(), 1e-5)
    assert_close_c(Pi(), z, 1e-4)
    for n in (48, 20):
        J, P = _build_both("fft", z, n=n)
        assert_close_c(P(), J(), 1e-5)
        z2 = _cplx(rng, 32)
        assert_close_c(P(z2), J(z2), 1e-5)
    with pytest.raises(ValueError, match="shape"):
        P(_cplx(rng, 16))


def test_builders_real_and_nd(rng):
    x = rng.standard_normal(30).astype(np.float32)
    J, P = _build_both("rfft", x)
    assert_close_c(P(), J(), 1e-5)
    J, P = _build_both("irfft", np.fft.rfft(x).astype(np.complex64), n=30)
    assert_close_c(P(), J(), 1e-5)
    x2 = rng.standard_normal((4, 8)).astype(np.float32)
    for name, arr, kw in (("rfftn", x2, {}), ("rfft2", x2, {}),
                          ("fftn", _cplx(rng, 4, 8), {"s": (6, 10), "axes": (0, 1)}),
                          ("fft2", _cplx(rng, 4, 8), {}),
                          ("ifftn", _cplx(rng, 4, 8), {}),
                          ("ifft2", _cplx(rng, 4, 8), {}),
                          ("irfftn", np.fft.rfftn(x2).astype(np.complex64),
                           {"s": (4, 8)}),
                          ("irfft2", np.fft.rfftn(x2).astype(np.complex64), {})):
        J, P = _build_both(name, arr, **kw)
        assert_close_c(P(), J(), 1e-5, name)


def test_builders_inert_options_and_real_through_c2c(rng):
    z = _cplx(rng, 16)
    obj = tpf.builders.fft(z, overwrite_input=True, avoid_copy=True,
                           planner_effort="FFTW_ESTIMATE", device="cpu")
    assert "overwrite_input" in obj.ignored_options
    assert "avoid_copy" in obj.ignored_options
    x = rng.standard_normal(16)
    J, P = _build_both("fft", x)
    assert_close_c(P(x), J(x), 1e-5)
    xr = rng.standard_normal(10).astype(np.float32)
    r2c = tpf.FFTW(xr, np.zeros(6, np.complex64), device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        r2c(input_array=xr.astype(np.complex64))
    with pytest.raises(TypeError, match="unexpected"):
        tpf.builders.fft(z, bogus=1, device="cpu")


# -------------------------------------------------------------- interfaces

def _iface_both(ns, name, *args, **kw):
    want = getattr(getattr(jpf.interfaces, ns), name)(*args, **kw)
    with TF.default_device("cpu"):
        got = getattr(getattr(tpf.interfaces, ns), name)(*args, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    assert_close_c(got, want, 1e-5, f"{ns}.{name}")
    return got


def test_interfaces(rng):
    z = _cplx(rng, 4, 16)
    got = _iface_both("numpy_fft", "fft", z, planner_effort="FFTW_ESTIMATE",
                      threads=2, auto_align_input=False)
    assert got.dtype == np.complex64
    x = rng.standard_normal((4, 10)).astype(np.float32)
    _iface_both("numpy_fft", "irfft", np.fft.rfft(x).astype(np.complex64), axis=-1)
    x3 = rng.standard_normal((3, 12)).astype(np.float32)
    _iface_both("scipy_fft", "dct", x3, type=3)
    _iface_both("scipy_fft", "dstn", x3, type=2, norm="ortho")
    got = _iface_both("scipy_fftpack", "rfft", rng.standard_normal(17).astype(np.float32))
    assert not np.iscomplexobj(got)     # fftpack packed-real form
    _iface_both("numpy_fft", "fft", _cplx(rng, 16), planning_timelimit=2.0)
    assert np.array_equal(tpf.interfaces.numpy_fft.fftfreq(10, 0.5),
                          np.fft.fftfreq(10, 0.5))
    assert tpf.interfaces.scipy_fft.next_fast_len(1000) == \
        jpf.interfaces.scipy_fft.next_fast_len(1000)
    with pytest.raises(ValueError, match="planner_effort"):
        tpf.interfaces.numpy_fft.fft(_cplx(rng, 8), planner_effort="FFTW_TURBO")
    c = tpf.interfaces.cache
    c.disable()
    assert not c.is_enabled()
    c.enable()
    assert c.is_enabled()
    c.set_keepalive_time(10)
    assert c.keepalive_time == 10.0


# ------------------------------------------------------------------ wisdom

def test_wisdom_roundtrip_restores_measured_winners(rng):
    cache = T.default_cache()
    z = _cplx(rng, 64)
    with TF.default_device("cpu"):
        # PATIENT maps to the measured planner -> a remembered winner
        tpf.interfaces.numpy_fft.fft(z, planner_effort="FFTW_PATIENT")
    assert len(cache.measured) >= 1
    w = tpf.export_wisdom()
    assert isinstance(w, tuple) and len(w) == 3
    n_measured = len(cache.measured)
    tpf.forget_wisdom()
    assert len(cache.measured) == 0
    assert tpf.import_wisdom(w)[0] is True
    assert len(cache.measured) == n_measured
    assert tpf.import_wisdom((b"not wisdom", b"", b""))[0] is False
    with pytest.raises(ValueError, match="wisdom"):
        tpf.import_wisdom(42)


def test_wisdom_crosses_between_the_packages(rng):
    """``export_wisdom()`` of either package imports into the other: the
    snapshot schema underneath is shared, measured winners are keyed by
    device identity so each package keeps the other's without using them."""
    z = _cplx(rng, 48)
    with TF.default_device("cpu"):
        tpf.interfaces.numpy_fft.fft(z, planner_effort="FFTW_PATIENT")
    jpf.interfaces.numpy_fft.fft(z, planner_effort="FFTW_PATIENT")
    tw, jw = tpf.export_wisdom(), jpf.export_wisdom()
    t_keys = set(T.default_cache().measured)
    j_keys = set(W.default_cache().measured)
    assert t_keys and j_keys
    # port -> JAX package
    assert jpf.import_wisdom(tw) == (True, True, True)
    assert t_keys <= set(W.default_cache().measured)
    # JAX package -> port
    assert tpf.import_wisdom(jw) == (True, True, True)
    assert j_keys <= set(T.default_cache().measured)
    # and a plan still builds and runs in both after the crossing
    with TF.default_device("cpu"):
        got = tpf.interfaces.numpy_fft.fft(z)
    assert_close_c(got, jpf.interfaces.numpy_fft.fft(z), 1e-5)
    tpf.forget_wisdom()
    jpf.forget_wisdom()


# --------------------------------------------------------------- alignment

def test_alignment_helpers():
    for n in (16, 64, 128):
        a = tpf.empty_aligned((5, 7), dtype="float32", n=n)
        assert a.shape == (5, 7) and tpf.is_byte_aligned(a, n)
    assert tpf.zeros_aligned((4,), dtype="complex64").sum() == 0
    assert tpf.ones_aligned((4,), dtype="float64").sum() == 4
    a = tpf.empty_aligned(16, dtype="float64", n=64)
    assert tpf.byte_align(a, n=64) is a
    off = np.empty(17, dtype=np.uint8)[1:9].view(np.float64)
    if not tpf.is_byte_aligned(off, 64):
        b = tpf.byte_align(off, n=64)
        assert tpf.is_byte_aligned(b, 64)
        np.testing.assert_array_equal(b, off)
    assert tpf.simd_alignment == jpf.simd_alignment
