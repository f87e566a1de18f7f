"""Support for the PyTorch port's GPU-only tests (imports torch only).

Tests that need an NVIDIA GPU carry ``@pytest.mark.cuda`` (registered in
pyproject.toml) and take the ``cuda_device`` fixture, which decides at run
time, never at import, whether a card exists and skips otherwise: a CUDA
kernel has no CPU mode.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def assert_close(actual, expected, atol_scale=1e-5, label=""):
    """|a - e| <= atol_scale * max|e| elementwise, as tests/conftest.py's
    _assert_close (which cannot be imported where JAX is absent)."""
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    assert actual.shape == expected.shape, (
        f"{label}: shape {actual.shape} != {expected.shape}")
    scale = max(np.max(np.abs(expected)), 1e-12)
    err = np.max(np.abs(actual - expected)) / scale
    assert err <= atol_scale, f"{label}: max rel err {err:.3e} > {atol_scale:.0e}"


def run_both(opts, x, *, impl="auto", kernel=None, out=None, **exec_kw):
    """Build the JAX plan and the port's CPU plan from the same options
    (``tuning.impl`` set to ``impl``), run both on the same numpy input and
    return ``(jax_plan, port_plan, jax_result, port_result)`` with the
    results as float numpy arrays (lists of them for a ``BufferView`` out).

    ``x`` and ``out`` are numpy arrays or lists of numpy segments (wrapped
    in each package's ``BufferView``); a bf16-storage plan gets them rounded
    to bfloat16.  The JAX package is imported here, not at module import, so
    the GPU-only tests can use this module where JAX is absent.
    """
    import jax.numpy as jnp
    import webgpufft_tpu as W
    import webgpufft_tpu_torch as T

    opts = dict(opts)
    opts["tuning"] = {**(opts.get("tuning") or {}), "impl": impl}
    jplan = W.create_plan(opts, cache=W.PlanCache())
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    bf16 = tplan.spec.precision == "bf16-storage"

    def to_jax(a):
        if a is None:
            return None
        if isinstance(a, list):
            return W.BufferView([to_jax(s) for s in a])
        return jnp.asarray(a).astype(jnp.bfloat16) if bf16 else a

    def to_torch(a):
        if a is None:
            return None
        if isinstance(a, list):
            return T.BufferView([to_torch(s) for s in a])
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if bf16 else t

    def to_numpy(y):
        if isinstance(y, (list, tuple)):
            return [to_numpy(p) for p in y]
        if isinstance(y, torch.Tensor):
            return y.float().numpy()
        return np.asarray(y.astype(jnp.float32))

    kw = {k: v for k, v in exec_kw.items() if v is not None}
    if kernel is not None:
        kw["kernel"] = kernel
    jy = jplan.exec(to_jax(x), out=to_jax(out), **kw)
    ty = tplan.exec(to_torch(x), out=to_torch(out), **kw)
    return jplan, tplan, to_numpy(jy), to_numpy(ty)


def same_route(jplan, tplan):
    """Route metadata equal field for field (expected under ``impl: "xla"``)."""
    jr, tr = jplan.route, tplan.route
    assert (tr.mode, tr.impl, tr.axis_kinds, tr.reasons) == \
        (jr.mode, jr.impl, jr.axis_kinds, jr.reasons)


def to_numpy(y):
    """A facade result (tensor, jax array, numpy, scalar, or a tuple of
    them) as float/complex numpy, tuples kept."""
    if isinstance(y, (tuple, list)):
        return tuple(to_numpy(p) for p in y)
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


def facade_both(name, *args, tol=1e-5, module="fftapi", **kw):
    """Call ``name`` of the JAX package's ``module`` and of the port's with
    the same (numpy) arguments, the port on the CPU device, and hold every
    output of the port against the JAX package's at ``tol`` of
    max|expected|.  Returns the port's result as numpy."""
    import importlib
    jmod = importlib.import_module(f"webgpufft_tpu.{module}")
    tmod = importlib.import_module(f"webgpufft_tpu_torch.{module}")
    from webgpufft_tpu_torch import fftapi as TF
    want = to_numpy(getattr(jmod, name)(*args, **kw))
    with TF.default_device("cpu"):
        got = to_numpy(getattr(tmod, name)(*args, **kw))
    label = f"{module}.{name}"
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_c(g, w, tol, f"{label}[{i}]")
    else:
        assert_close_c(got, want, tol, label)
    return got


def assert_close_c(actual, expected, atol_scale=1e-5, label=""):
    """``assert_close`` that also compares complex arrays in both parts."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    if np.iscomplexobj(actual) or np.iscomplexobj(expected):
        actual = np.stack([actual.real, actual.imag], -1)
        expected = np.stack([expected.real, expected.imag], -1)
    assert_close(actual, expected, atol_scale, label)


def facade_raises(name, match, *args, module="fftapi", exc=None, **kw):
    """Both packages raise (``PlanError`` unless ``exc``) matching ``match``
    for the same arguments."""
    import importlib
    import webgpufft_tpu as W
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import fftapi as TF
    jmod = importlib.import_module(f"webgpufft_tpu.{module}")
    tmod = importlib.import_module(f"webgpufft_tpu_torch.{module}")
    match = match or None
    with pytest.raises(exc or W.PlanError, match=match):
        getattr(jmod, name)(*args, **kw)
    with TF.default_device("cpu"), pytest.raises(exc or T.PlanError, match=match):
        getattr(tmod, name)(*args, **kw)


def torch_fft_stepper3(n, nu, dt, device):
    """``chip_smoke.torch_fft_stepper3``: the port's NS-3D solver with
    ``torch.fft`` in place of the plans, the one copy the GPU script and the
    tests share."""
    repo = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke.torch_fft_stepper3(n, nu, dt, device)


def same(got, want, label=""):
    """Equal results, element for element (NaN equal to NaN), through
    tuples, lists, dicts and objects' attributes; tensors are compared as
    numpy."""
    close(got, want, None, label)


def close(got, want, tol, label=""):
    """Results held together member by member through tuples, lists, dicts
    and objects (by their attributes): floating arrays and tensors within
    ``tol`` of max|want| (both parts of complex ones; equal when ``tol`` is
    None), integer and boolean arrays, strings and the rest equal."""
    if isinstance(got, torch.Tensor):
        got = to_numpy(got)
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), label
        for k in want:
            close(got[k], want[k], tol, f"{label}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, tol, f"{label}[{i}]")
    elif hasattr(want, "__dict__") and not hasattr(want, "__array__"):
        assert type(got).__name__ == type(want).__name__, label
        close(vars(got), vars(want), tol, f"{label}.{type(want).__name__}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        if tol is not None and want.dtype.kind in "fc" and want.size:
            assert_close_c(got, want, tol, label)
        else:
            np.testing.assert_array_equal(got, want, err_msg=label)


def _host(a):
    """A port result handed to the JAX package: tensors as numpy."""
    if isinstance(a, torch.Tensor):
        return to_numpy(a)
    if isinstance(a, (tuple, list)):
        return type(a)(_host(v) for v in a)
    return a


class BothModules:
    """Stands for one of the JAX package's modules in its own test cases:
    every function called through it runs the port's copy (on the CPU
    device: numpy inputs go to ``fftapi.default_device("cpu")``) and the
    JAX package's on the same arguments, holds the two results equal and
    returns the port's.  ``tol`` (a float, or a dict of function name ->
    float with ``"*"`` for the rest) is the tolerance of a function that
    computes in float32 on the device, as a fraction of max|JAX result|;
    a function without one must give equal results (``same``: both run the
    same float64 host code).  When the JAX function raises, the port's must
    raise an exception of the same class name and message; the JAX
    package's then propagates, so a case's ``pytest.raises`` names the
    class it imported."""

    def __init__(self, port, reference, tol=None):
        self._port, self._reference = port, reference
        self._tol = tol if isinstance(tol, dict) else {"*": tol}

    def __getattr__(self, name):
        import copy
        from webgpufft_tpu_torch import fftapi as TF
        port_fn, ref_fn = getattr(self._port, name), getattr(self._reference, name)
        if not callable(port_fn) or isinstance(port_fn, type):
            return port_fn
        tol = self._tol.get(name, self._tol.get("*"))

        def call(*args, **kw):
            try:
                want = ref_fn(*_host(copy.deepcopy(args)), **_host(copy.deepcopy(kw)))
            except Exception as ref_err:
                with pytest.raises(Exception) as port_err, TF.default_device("cpu"):
                    port_fn(*args, **kw)
                assert (type(port_err.value).__name__, str(port_err.value)) == (
                    type(ref_err).__name__, str(ref_err)), name
                raise
            with TF.default_device("cpu"):
                got = port_fn(*args, **kw)
            label = f"{self._port.__name__}.{name}"
            if tol is None:
                same(got, want, label)
            else:
                close(got, want, tol, label)
            return got
        return call
