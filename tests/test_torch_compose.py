"""Design points of the port's functional facade that the case-by-case
mirrors do not reach: the device rule and the mixed-device error, float64
in -> float32 out, the pad helper against ``numpy.pad``, plans built lazily
inside ``torch.func.grad`` / ``vmap`` / ``jvp`` (the torch form of
tests/test_jit_compose.py's tracer regression), the facade cases of
tests/test_autodiff.py against ``jax.grad`` / ``jvp`` / ``vmap``, the host
cost rule (an untracked call never enters ``Function.apply``), and the
numpy.fft / scipy.fft halves of tests/test_parity_surface.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import numpy.fft as nf
import pytest
import scipy.fft as sf
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu import fftapi as JF
from webgpufft_tpu_torch import fftapi as TF
from torch_port_support import assert_close, assert_close_c


# ------------------------------------------------------------ 1. the device

def test_non_tensor_input_without_a_gpu_raises_and_does_not_run_on_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert not TF._DEVICE_STACK
    with pytest.raises(RuntimeError, match="cuda"):
        TF.fft(rng.standard_normal((2, 8)))
    with pytest.raises(RuntimeError, match="cuda"):
        TF.welch(rng.standard_normal(512).tolist())


def test_cpu_tensor_runs_on_the_cpu_with_no_device_block(rng):
    x = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    y = TF.rfft(x)
    assert y.device.type == "cpu" and y.shape == (2, 9, 2)
    f, t, Z = TF.stft(x, nperseg=8)
    assert Z.device.type == "cpu"
    # a non-tensor second input follows the tensor
    c = TF.fftconvolve(x, np.ones((1, 3)), axes=(1,))
    assert c.device.type == "cpu" and c.shape == (2, 18)


def test_default_device_nests_and_restores():
    assert TF._DEVICE_STACK == []
    with TF.default_device("cpu"):
        assert TF._default_device() == torch.device("cpu")
        with TF.default_device("cpu"):
            assert len(TF._DEVICE_STACK) == 2
        assert len(TF._DEVICE_STACK) == 1
        with pytest.raises(ValueError):
            with TF.default_device("cpu"):
                raise ValueError("restored on error too")
        assert len(TF._DEVICE_STACK) == 1
    assert TF._DEVICE_STACK == []
    with TF.default_device("meta"), pytest.raises(T.PlanError, match="device"):
        TF.fft(np.ones(4))


def test_mixed_devices_raise_plan_error():
    a = torch.zeros(2, 8)
    b = torch.zeros(1, 3, device="meta")
    for call in (lambda: TF.fftconvolve(a, b, axes=(1,)),
                 lambda: TF.correlate(a, b),
                 lambda: TF.convolve2d(a, b),
                 lambda: TF.csd(a, b, nperseg=4),
                 lambda: TF.upfirdn(b[0], a)):
        with pytest.raises(T.PlanError, match="different devices"):
            call()


# ------------------------------------------------------------ 3. float32

@pytest.mark.parametrize("name,args", [
    ("fft", ()), ("rfft", ()), ("dct", ()), ("hilbert", ()),
    ("fftshift", ()), ("detrend", ()), ("resample", (24,)),
])
def test_float64_in_float32_out_equal_to_the_reference(rng, name, args):
    x = rng.standard_normal((3, 32))                     # float64
    want = np.asarray(getattr(JF, name)(x, *args))
    assert want.dtype == np.float32
    for inp in (x, torch.from_numpy(x)):                 # numpy and tensor
        with TF.default_device("cpu"):
            got = getattr(TF, name)(inp, *args)
        assert got.dtype == torch.float32, name
        assert_close(got.numpy(), want, 1e-5, name)


def test_one_cast_helper_is_the_only_as_tensor_of_user_data():
    """``_f32`` and ``_const`` hold the facade's only ``torch.as_tensor``
    calls besides the integer index vectors of the pad / overlap-add /
    envelope gathers."""
    import inspect
    import re
    src = inspect.getsource(TF)
    calls = re.findall(r"torch\.as_tensor\(([^,\n]*)", src)
    user = [c for c in calls if c.strip() not in ("idx", "dest")]
    assert len(user) == 2, calls          # _f32 and _const


# ------------------------------------------------------------ 4. padding

@pytest.mark.parametrize("mode,kw", [
    ("constant", {}), ("edge", {}), ("reflect", {}), ("symmetric", {}),
    ("wrap", {}), ("reflect", {"reflect_type": "odd"}),
])
@pytest.mark.parametrize("n,lo,hi", [(7, 3, 2), (7, 0, 5), (5, 13, 9),
                                     (4, 4, 3), (1, 2, 3), (6, 6, 0)])
def test_pad_axis_against_numpy(rng, mode, kw, n, lo, hi):
    """Every mode the facade names, pads larger than the signal too, on the
    last axis and on an inner one."""
    x = rng.standard_normal((2, n, 3)).astype(np.float32)
    for axis in (1, -2):
        pads = [(0, 0), (lo, hi), (0, 0)]
        want = np.pad(x, pads, mode=mode, **kw)
        got = TF._pad_axis(torch.from_numpy(x), axis, lo, hi, mode, **kw)
        assert_close(got.numpy(), want, 1e-6, f"{mode} {kw}")
    x1 = rng.standard_normal((3, n)).astype(np.float32)
    want = np.pad(x1, [(0, 0), (lo, hi)], mode=mode, **kw)
    got = TF._pad_axis(torch.from_numpy(x1), -1, lo, hi, mode, **kw)
    assert_close(got.numpy(), want, 1e-6, f"last axis {mode} {kw}")


def test_pad_axis_rejects_unknown_mode_and_passes_gradients():
    x = torch.arange(5.0, requires_grad=True)
    with pytest.raises(T.PlanError, match="mode"):
        TF._pad_axis(x, 0, 1, 1, "linear_ramp")
    assert TF._pad_axis(x, 0, 0, 0, "edge") is x
    y = TF._pad_axis(x, 0, 2, 2, "reflect", reflect_type="odd")
    g, = torch.autograd.grad(y.sum(), x)
    assert g.shape == (5,) and torch.isfinite(g).all()


# ---------------------------------- 7. plans built inside a torch transform

def _no_wrapped_tensor_in(cache):
    """Every table of every cached plan is a plain tensor: no functorch
    wrapper (grad / vmap / jvp level), no autograd history."""
    from torch._C._functorch import is_functorch_wrapped_tensor
    n = 0
    for plan in cache._plans.values():
        for name, t in plan.consts.items():
            assert type(t) is torch.Tensor, name
            assert not is_functorch_wrapped_tensor(t), name
            assert not t.requires_grad and t.grad_fn is None, name
            n += 1
    return n


@pytest.mark.parametrize("transform", ["grad", "vmap", "jvp"])
def test_first_use_inside_a_transform_leaves_plain_tables(rng, transform):
    """A shape no other test uses, so the transformed call builds the
    plan; the same call afterwards outside the transform works and agrees."""
    n = {"grad": 251, "vmap": 253, "jvp": 247}[transform]
    cache = T.default_cache()
    before = len(cache)
    x = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    if transform == "grad":
        g = torch.func.grad(lambda v: TF.rfft(v).pow(2).sum())(x)
        assert g.shape == x.shape
        inside = None
    elif transform == "vmap":
        inside = torch.func.vmap(lambda v: TF.rfft(v))(x)
    else:
        inside, tangent = torch.func.jvp(lambda v: TF.rfft(v), (x,), (x,))
        assert_close(tangent.numpy(), inside.numpy(), 1e-6, "linear: jvp == apply")
    assert len(cache) > before
    assert _no_wrapped_tensor_in(cache) > 0
    outside = TF.rfft(x if transform != "vmap" else x[:1])      # must not raise
    if inside is not None:
        ref = inside if transform != "vmap" else inside[:1]
        assert_close(outside.numpy(), ref.numpy(), 1e-6, transform)
    assert_close_c(TF.ascomplex(TF.rfft(x)), np.fft.rfft(x.numpy()), 3e-5)


def test_shorttimefft_inside_grad_then_eager(rng):
    import scipy.signal as ss
    A = T.ShortTimeFFT(ss.windows.gaussian(16, 4), hop=4, fs=10)
    x = torch.from_numpy(rng.standard_normal(249).astype(np.float32))
    g = torch.func.grad(lambda v: A.stft(v).pow(2).sum())(x)
    assert torch.isfinite(g).all()
    _no_wrapped_tensor_in(T.default_cache())
    S = A.stft(x)
    xr = A.istft(S, k1=249, interleaved=True)
    assert_close(xr.numpy(), x.numpy(), 1e-4, "roundtrip after grad")


# ------------------------------------- facade cases of tests/test_autodiff.py

def test_grad_facade_fft_parseval_against_jax(rng):
    n = 48
    x = np.stack([rng.standard_normal((3, n)), rng.standard_normal((3, n))],
                 -1).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(JF.fft(v, interleaved=True) ** 2))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, = torch.autograd.grad(TF.fft(xt, interleaved=True).pow(2).sum(), xt)
    assert_close(got.numpy(), np.asarray(want), 1e-5, "facade grad")
    assert_close(got.numpy(), 2.0 * n * x, 1e-5, "parseval")
    gf = torch.func.grad(lambda v: TF.fft(v, interleaved=True).pow(2).sum())(
        torch.from_numpy(x))
    assert_close(gf.numpy(), np.asarray(want), 1e-5, "func.grad")


def test_grad_facade_fftconvolve_against_jax(rng):
    x = rng.standard_normal((32,)).astype(np.float32)
    k = rng.standard_normal((7,)).astype(np.float32)
    want = jax.grad(lambda kk: jnp.sum(JF.fftconvolve(jnp.asarray(x), kk, "full")))(
        jnp.asarray(k))
    kt = torch.from_numpy(k).requires_grad_(True)
    got, = torch.autograd.grad(
        TF.fftconvolve(torch.from_numpy(x), kt, "full").sum(), kt)
    assert_close(got.numpy(), np.asarray(want), 1e-5, "facade conv grad")


def test_jvp_facade_stft_linear_against_jax(rng):
    x = rng.standard_normal((512,)).astype(np.float32)
    v = rng.standard_normal((512,)).astype(np.float32)
    _, want = jax.jvp(lambda a: JF.stft(a, nperseg=64, noverlap=16)[2],
                      (jnp.asarray(x),), (jnp.asarray(v),))
    f = lambda a: TF.stft(a, nperseg=64, noverlap=16)[2]      # noqa: E731
    _, got = torch.func.jvp(f, (torch.from_numpy(x),), (torch.from_numpy(v),))
    assert_close(got.numpy(), np.asarray(want), 1e-5, "stft jvp")
    assert_close(got.numpy(), f(torch.from_numpy(v)).numpy(), 1e-6, "jvp == apply")


def test_vmap_facade_dct_against_jax(rng):
    x = rng.standard_normal((5, 20)).astype(np.float32)
    want = jax.vmap(lambda r: JF.dct(r, norm="ortho"))(jnp.asarray(x))
    got = torch.func.vmap(lambda r: TF.dct(r, norm="ortho"))(torch.from_numpy(x))
    assert_close(got.numpy(), np.asarray(want), 1e-5, "vmap dct")
    assert_close(got.numpy(), TF.dct(torch.from_numpy(x), norm="ortho").numpy(),
                 1e-6, "vmap == batch")


@pytest.mark.parametrize("name,kw", [
    ("hilbert", {}), ("resample", {"num": 40}),
    ("resample_poly", {"up": 3, "down": 2, "axis": -1}),
    ("welch", {"nperseg": 16}), ("istft_of_stft", {}),
])
def test_gradients_flow_through_the_signal_functions(rng, name, kw):
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    x.requires_grad_(True)
    if name == "istft_of_stft":
        y = TF.istft(TF.stft(x, nperseg=16)[2], nperseg=16)[1]
    else:
        y = getattr(TF, name)(x, **kw)
        y = y[1] if isinstance(y, tuple) else y
    g, = torch.autograd.grad(y.pow(2).sum(), x)
    assert g.shape == x.shape and torch.isfinite(g).all() and g.abs().max() > 0


# ------------------------------------------------------------ 8. host cost

def test_untracked_facade_call_never_enters_function_apply(rng, monkeypatch):
    """The facade wraps nothing as requiring grad and opens no transform of
    its own: a plain call launches the kernels' wrappers directly."""
    from webgpufft_tpu_torch.core import fused, fused_cols
    hits = []
    fns = [c for m in (fused, fused_cols) for c in vars(m).values()
           if isinstance(c, type) and issubclass(c, torch.autograd.Function)
           and c is not torch.autograd.Function]
    assert fns
    for c in fns:
        orig = c.apply
        monkeypatch.setattr(c, "apply", staticmethod(
            lambda *a, _o=orig, _c=c, **k: (hits.append(_c.__name__), _o(*a, **k))[1]))
    x = torch.from_numpy(rng.standard_normal((8, 1024)).astype(np.float32))
    y = TF.rfft(x)                          # routes through K1's wrapper
    plan = T.create_plan(type="r2c", shape=[1024], batch=8, device="cpu")
    assert "r2c-axis0-fused-lines" in plan.route.reasons
    TF.fftn(torch.from_numpy(rng.standard_normal((2, 64, 256, 2)).astype(np.float32)))
    TF.stft(x, nperseg=256)
    assert not y.requires_grad and not x.requires_grad
    assert hits == [], hits
    xg = x.clone().requires_grad_(True)
    TF.rfft(xg).sum().backward()
    assert hits, "a tracked call goes through the kernels' autograd Functions"


# ------------------------------------- numpy.fft / scipy.fft surface parity

_NON_API = {"test"}


def _public(mod):
    return [n for n in dir(mod) if not n.startswith("_")
            and n not in _NON_API
            and not isinstance(getattr(mod, n), types.ModuleType)]


@pytest.mark.parametrize("oracle", [nf, sf], ids=["numpy.fft", "scipy.fft"])
def test_fft_namespaces_complete(oracle):
    missing = [n for n in _public(oracle) if not hasattr(TF, n)]
    assert not missing, f"the port's fftapi lacks {missing}"


def test_pyfftw_interfaces_cover_their_namespaces():
    from webgpufft_tpu_torch import pyfftw as pf
    for ns, names in ((pf.interfaces.numpy_fft, pf._NUMPY_FFT_NAMES),
                      (pf.interfaces.scipy_fft, pf._SCIPY_FFT_NAMES)):
        missing = [n for n in names if not hasattr(ns, n)]
        assert not missing, missing


def test_oracle_control_kwargs_accepted():
    x = np.arange(8.0)
    with TF.default_device("cpu"):
        for fn in (TF.fft, TF.rfft, TF.hfft, TF.dct, TF.dstn, TF.irfftn):
            arg = x if fn is not TF.irfftn else np.ones((5, 2))
            fn(arg, overwrite_x=True, workers=4)       # accepted, ignored
        with pytest.raises(NotImplementedError, match="precomputed plan"):
            TF.fft(x, plan=object())
        with pytest.raises(NotImplementedError, match="out="):
            TF.ifft(x, out=np.zeros(8, complex))
        b = TF.fft(x)
        assert torch.equal(TF.fft(x, workers=2), b)
        assert torch.equal(TF.fft(x, None, -1, None, True, 4), b)
        assert torch.equal(TF.dct(x, 2, None, -1, None, True, 4), TF.dct(x))
        with pytest.raises(TypeError, match="positional"):
            TF.fft(x, None, -1, None, True, 4, "extra")


def test_no_library_fft_inside_the_package():
    """``torch.fft.*``, ``torch.stft`` and ``torch.istft`` are oracles in
    the tests and yardsticks on the card, never called by the package."""
    import pathlib
    import re
    root = pathlib.Path(T.__file__).parent
    pat = re.compile(r"torch\.(fft\.|stft|istft)")
    bad = [f"{p.relative_to(root)}:{i}" for p in root.rglob("*.py")
           for i, line in enumerate(p.read_text().splitlines(), 1) if pat.search(line)]
    assert not bad, bad


def test_einsum_route_and_trig_matmuls_run_at_full_float32(rng, monkeypatch):
    """A caller's TF32 flag does not reach the plan layer's einsum
    contractions or the DCT trig matmuls: the JAX package runs them at
    ``Precision.HIGHEST`` (``core/precision.full_f32``); the flag is the
    caller's again afterwards."""
    import sys
    from webgpufft_tpu_torch.core import axis, precision
    from webgpufft_tpu_torch.plans import transforms
    seen = []
    real_einsum, real_matmul = torch.einsum, torch.matmul
    # the contractions of both run in core/precision.einsum
    files = (axis.__file__, transforms.__file__, precision.__file__)

    def spy(real):
        def f(*args, **kw):
            if sys._getframe(1).f_code.co_filename in files:
                seen.append(torch.backends.cuda.matmul.fp32_precision)
            return real(*args, **kw)
        return f
    monkeypatch.setattr(torch, "einsum", spy(real_einsum))
    monkeypatch.setattr(torch, "matmul", spy(real_matmul))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.from_numpy(rng.standard_normal((4, 60, 2)).astype(np.float32))
        T.create_plan({"type": "c2c", "shape": [60], "batch": 4, "tuning": {"impl": "xla"}},
                      device="cpu", cache=T.PlanCache())(x)
        T.create_plan({"type": "dct2", "shape": [8, 8], "batch": 4}, device="cpu",
                      cache=T.PlanCache())(torch.from_numpy(
                          rng.standard_normal((4, 8, 8)).astype(np.float32)))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen and set(seen) == {"ieee"}, seen
