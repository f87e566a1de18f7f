"""The port's FFT linear algebra (webgpufft_tpu_torch/linalg.py) against the
JAX package's and scipy.linalg, case by case as tests/test_linalg.py: the
same seeded numpy operands through both packages (the port on the CPU
device).  Each case holds the port against scipy at the JAX test's own bar
(``_rel`` < 5e-4; 1e-4 on a residual) and against the JAX package at
``TOL_JAX`` of max|expected|.  Where the JAX test traces b or x under
``jax.jit`` / ``jax.grad``, the port's case gives a tensor that requires
grad (``radix.tracked``): the device path and its gradient."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from webgpufft_tpu import linalg as WL
from webgpufft_tpu_torch import PlanError
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import linalg as TL
from torch_port_support import assert_close_c, to_numpy

# both packages run the same host-f64 operator tables and f32 transforms in
# another summation order; 1e-5 of max|expected| is the f32 bar, and a
# solve divides by the operator's spectrum, which can amplify that rounding
# by its condition number (the seeded cases stay below 30)
TOL_JAX = 1e-5
TOL_SOLVE = 3e-4


@pytest.fixture
def rng():
    return np.random.default_rng(20260818)


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - b)) / max(np.max(np.abs(b)), 1e-30)


def _mk(rng, shape, cx):
    a = rng.standard_normal(shape)
    return (a + 1j * rng.standard_normal(shape)) if cx else a


def _cplx(y, cx):
    y = to_numpy(y)
    return y[..., 0] + 1j * y[..., 1] if cx else y


def _both(name, *args, cx=False, bar=TOL_JAX, **kw):
    """``name`` of both packages on the same numpy arguments; the port's
    result (complex when ``cx``) after holding it against the JAX one."""
    want = to_numpy(getattr(WL, name)(*args, **kw))
    with TF.default_device("cpu"):
        got = getattr(TL, name)(*args, **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = to_numpy(got)
    assert_close_c(got, want, bar, f"linalg.{name}")
    return _cplx(got, cx)


def _raises_both(name, exc, match, *args, **kw):
    with pytest.raises(exc, match=match):
        getattr(WL, name)(*args, **kw)
    with TF.default_device("cpu"), pytest.raises(exc, match=match):
        getattr(TL, name)(*args, **kw)


class TestSolveCirculant:
    @pytest.mark.parametrize("n", [2, 7, 16, 33])
    @pytest.mark.parametrize("cx", [False, True])
    def test_basic_vs_scipy(self, rng, n, cx):
        c = _mk(rng, (n,), cx)
        b = _mk(rng, (n,), cx)
        ref = sla.solve_circulant(c, b)
        got = _both("solve_circulant", c, b, cx=cx, bar=TOL_SOLVE)
        assert got.shape == ref.shape
        assert _rel(got, ref) < 5e-4

    def test_solves_the_system(self, rng):
        n = 12
        c = rng.standard_normal(n) + 3 * np.eye(1, n, 0).ravel()
        b = rng.standard_normal(n)
        x = _both("solve_circulant", c, b)
        assert _rel(sla.circulant(c) @ x, b) < 1e-4

    def test_broadcasting_and_axes(self, rng):
        n = 10
        c = rng.standard_normal((3, 1, n))
        b = rng.standard_normal((n, 2))
        for outaxis in (0, -1):
            ref = sla.solve_circulant(c, b, outaxis=outaxis)
            got = _both("solve_circulant", c, b, outaxis=outaxis, bar=TOL_SOLVE)
            assert got.shape == ref.shape
            assert _rel(got, ref) < 5e-4

    def test_caxis_baxis(self, rng):
        n = 9
        c = rng.standard_normal((n, 3))
        b = rng.standard_normal((3, n))
        ref = sla.solve_circulant(c, b, caxis=0, baxis=1)
        got = _both("solve_circulant", c, b, caxis=0, baxis=1, bar=TOL_SOLVE)
        assert got.shape == ref.shape
        assert _rel(got, ref) < 5e-4

    def test_singular_raise_and_lstsq(self):
        c = np.array([1.0, 1.0, 1.0, 1.0])   # fft has exact zeros
        _raises_both("solve_circulant", np.linalg.LinAlgError, "singular", c, np.ones(4))
        ref = sla.solve_circulant(c, np.ones(4), singular="lstsq")
        got = _both("solve_circulant", c, np.ones(4), singular="lstsq")
        np.testing.assert_allclose(got, ref, atol=1e-6)

    def test_explicit_tol(self, rng):
        c = np.array([1.0, 0.9999, 1.0, 1.0001])
        b = rng.standard_normal(4)
        _raises_both("solve_circulant", np.linalg.LinAlgError, None, c, b, tol=10.0)
        got = _both("solve_circulant", c, b, tol=10.0, singular="lstsq")
        ref = sla.solve_circulant(c, b, tol=10.0, singular="lstsq")
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_shape_mismatch(self, rng):
        _raises_both("solve_circulant", ValueError, "incompatible",
                     rng.standard_normal(4), rng.standard_normal(5))

    def test_traced_b_under_jit(self, rng):
        """The JAX case traces b under jit; here b requires grad."""
        n = 8
        c = rng.standard_normal(n) + 2 * np.eye(1, n, 0).ravel()
        b = rng.standard_normal(n).astype(np.float32)
        ref = _both("solve_circulant", c, b)
        bt = torch.from_numpy(b).requires_grad_()
        got = TL.solve_circulant(c, bt)
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-6)
        g, = torch.autograd.grad(got.pow(2).sum(), bt)
        # the solve is linear: d|x|^2/db = 2 C^-T x
        want = 2 * np.linalg.solve(sla.circulant(c).T, ref)
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4 * np.abs(want).max())

    def test_traced_c_rejected(self, rng):
        c = torch.from_numpy(rng.standard_normal(8).astype(np.float32)).requires_grad_()
        with pytest.raises(PlanError, match="concrete"):
            TL.solve_circulant(c, np.ones(8))


class TestMatmulToeplitz:
    @pytest.mark.parametrize("nr,nc", [(5, 5), (7, 3), (2, 9), (1, 1)])
    @pytest.mark.parametrize("cx", [False, True])
    def test_tuple_form_vs_scipy(self, rng, nr, nc, cx):
        c, r = _mk(rng, (nr,), cx), _mk(rng, (nc,), cx)
        for x in (_mk(rng, (nc,), cx), _mk(rng, (nc, 3), cx)):
            ref = sla.matmul_toeplitz((c, r), x)
            got = _both("matmul_toeplitz", (c, r), x, cx=cx)
            assert got.shape == ref.shape
            assert _rel(got, ref) < 5e-4

    @pytest.mark.parametrize("cx", [False, True])
    def test_bare_c_implies_hermitian(self, rng, cx):
        n = 8
        c = _mk(rng, (n,), cx)
        x = _mk(rng, (n, 2), cx)
        ref = sla.matmul_toeplitz(c, x)
        got = _both("matmul_toeplitz", c, x, cx=cx)
        assert _rel(got, ref) < 5e-4

    def test_matches_dense_toeplitz(self, rng):
        c, r = rng.standard_normal(6), rng.standard_normal(4)
        x = rng.standard_normal((4, 2))
        got = _both("matmul_toeplitz", (c, r), x)
        assert _rel(got, sla.toeplitz(c, r) @ x) < 1e-4

    def test_traced_x_and_operator(self, rng):
        """The JAX case traces x under jit and differentiates through c;
        here x, then c, require grad (the device-f32 operator path)."""
        c, r = rng.standard_normal(5), rng.standard_normal(5)
        x = rng.standard_normal(5).astype(np.float32)
        ref = _both("matmul_toeplitz", (c, r), x)
        xt = torch.from_numpy(x).requires_grad_()
        got = TL.matmul_toeplitz((c, r), xt)
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
        cf = torch.from_numpy(c.astype(np.float32)).requires_grad_()
        rf = torch.from_numpy(r.astype(np.float32))
        y = TL.matmul_toeplitz((cf, rf), torch.from_numpy(x))
        np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-5)
        g, = torch.autograd.grad(y.pow(2).sum(), cf)
        # y = T(c, r) x: dy_i/dc_k = x_{i-k} for i >= k
        t = sla.toeplitz(c, r)
        want = np.array([2 * sum((t @ x)[i] * x[i - k] for i in range(k, 5))
                         for k in range(5)])
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4 * np.abs(want).max())

    def test_validation(self, rng):
        _raises_both("matmul_toeplitz", ValueError, "one-dimensional",
                     (rng.standard_normal((2, 2)), rng.standard_normal(2)),
                     rng.standard_normal(2))
        _raises_both("matmul_toeplitz", ValueError, "rows",
                     (rng.standard_normal(4), rng.standard_normal(3)),
                     rng.standard_normal(4))
        with pytest.raises(PlanError, match="1-D or 2-D"):
            TL.matmul_toeplitz(rng.standard_normal(3), rng.standard_normal((3, 1, 1)))
        _raises_both("matmul_toeplitz", ValueError, "infs or NaNs",
                     np.array([np.inf, 1.0]), rng.standard_normal(2), check_finite=True)


class TestSolveToeplitz:
    @pytest.mark.parametrize("n", [1, 2, 9, 32])
    @pytest.mark.parametrize("cx", [False, True])
    def test_tuple_form_vs_scipy(self, rng, n, cx):
        c, r = _mk(rng, (n,), cx), _mk(rng, (n,), cx)
        c[0] += n + 2
        for b in (_mk(rng, (n,), cx), _mk(rng, (n, 3), cx)):
            ref = sla.solve_toeplitz((c, r), b)
            got = _both("solve_toeplitz", (c, r), b, cx=cx)
            assert got.shape == ref.shape
            assert _rel(got, ref) < 5e-4

    @pytest.mark.parametrize("cx", [False, True])
    def test_bare_c_implies_hermitian(self, rng, cx):
        n = 11
        c = _mk(rng, (n,), cx)
        c[0] += n + 2
        b = _mk(rng, (n, 2), cx)
        ref = sla.solve_toeplitz(c, b)
        got = _both("solve_toeplitz", c, b, cx=cx)
        assert got.shape == ref.shape and _rel(got, ref) < 5e-4

    def test_mixed_complex_b_real_op(self, rng):
        n = 10
        c, r = _mk(rng, (n,), False), _mk(rng, (n,), False)
        c[0] += n
        b = _mk(rng, (n,), True)
        ref = sla.solve_toeplitz((c, r), b)
        got = _both("solve_toeplitz", (c, r), b, cx=True)
        assert got.shape == ref.shape and _rel(got, ref) < 5e-4

    def test_solves_the_system(self, rng):
        n = 16
        c, r = rng.standard_normal(n), rng.standard_normal(n)
        c[0] += n
        b = rng.standard_normal(n)
        x = _both("solve_toeplitz", (c, r), b)
        r2 = r.copy()
        r2[0] = c[0]
        assert _rel(sla.toeplitz(c, r2) @ x, b) < 1e-4

    def test_traced_b_jit_and_grad(self, rng):
        n = 8
        c = rng.standard_normal(n)
        c[0] += n
        b = rng.standard_normal(n).astype(np.float32)
        ref = _both("solve_toeplitz", c, b)
        bt = torch.from_numpy(b).requires_grad_()
        got = TL.solve_toeplitz(c, bt)
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
        g, = torch.autograd.grad(got.pow(2).sum(), bt)
        want = 2 * np.linalg.solve(sla.toeplitz(c, c).T, ref)
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4 * np.abs(want).max())

    def test_empty_system_and_empty_rhs(self, rng):
        with TF.default_device("cpu"):
            got = TL.solve_toeplitz(np.ones(0), np.ones(0))
            assert tuple(got.shape) == sla.solve_toeplitz(np.ones(0), np.ones(0)).shape
            c = np.r_[5.0, rng.standard_normal(4)]
            got = TL.solve_toeplitz(c, np.ones((5, 0)))
            assert tuple(got.shape) == sla.solve_toeplitz(c, np.ones((5, 0))).shape
            cx = c + 1j * rng.standard_normal(5)
            got = TL.solve_toeplitz(cx, np.ones((5, 0)))
            assert tuple(got.shape) == (5, 0, 2) == np.shape(WL.solve_toeplitz(cx, np.ones((5, 0))))

    def test_validation(self, rng):
        _raises_both("solve_toeplitz", ValueError, "Incompatible dimensions",
                     (np.ones(3), np.ones(4)), np.ones(3))
        _raises_both("solve_toeplitz", ValueError, "Incompatible dimensions",
                     np.ones(3), np.ones(4))
        _raises_both("solve_toeplitz", ValueError, "Incompatible dimensions",
                     np.ones(3), np.ones((3, 1, 1)))
        _raises_both("solve_toeplitz", np.linalg.LinAlgError, "principal minor",
                     np.array([0.0, 1.0]), np.ones(2))
        _raises_both("solve_toeplitz", np.linalg.LinAlgError, "principal minor",
                     (np.array([0.0, 1.0]), np.array([5.0, 2.0])), np.ones(2))
        _raises_both("solve_toeplitz", ValueError, "infs or NaNs",
                     np.array([np.nan, 1.0]), np.ones(2))
        with pytest.raises(PlanError, match="concrete"):
            TL.solve_toeplitz(torch.ones(4, requires_grad=True), np.ones(4))


class TestFuzzVsScipy:
    """Seeded grid mirroring the JAX package's."""

    @pytest.mark.parametrize("seed", range(12))
    def test_solve_circulant_random(self, seed):
        rng = np.random.default_rng(1000 + seed)
        n = int(rng.integers(2, 40))
        cx_c, cx_b = rng.random() < 0.4, rng.random() < 0.4
        c = _mk(rng, (n,), cx_c)
        b_extra = () if rng.random() < 0.5 else (int(rng.integers(1, 4)),)
        b = _mk(rng, (n,) + b_extra, cx_b)
        outaxis = int(rng.choice([0, -1]))
        ref = sla.solve_circulant(c, b, outaxis=outaxis)
        got = _both("solve_circulant", c, b, outaxis=outaxis, cx=cx_c or cx_b, bar=TOL_SOLVE)
        assert got.shape == ref.shape
        assert _rel(got, ref) < 5e-4

    @pytest.mark.parametrize("seed", range(12))
    def test_solve_toeplitz_random(self, seed):
        rng = np.random.default_rng(3000 + seed)
        n = int(rng.integers(1, 40))
        cx = rng.random() < 0.4
        c = _mk(rng, (n,), cx)
        c[0] += n + 2
        op = c if rng.random() < 0.4 else (c, _mk(rng, (n,), cx))
        b = (_mk(rng, (n,), cx) if rng.random() < 0.5
             else _mk(rng, (n, int(rng.integers(1, 5))), cx))
        ref = sla.solve_toeplitz(op, b)
        got = _both("solve_toeplitz", op, b, cx=cx)
        assert got.shape == ref.shape
        assert _rel(got, ref) < 5e-4

    @pytest.mark.parametrize("seed", range(12))
    def test_matmul_toeplitz_random(self, seed):
        rng = np.random.default_rng(2000 + seed)
        nr, nc = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        cx = rng.random() < 0.4
        c, r = _mk(rng, (nr,), cx), _mk(rng, (nc,), cx)
        x = (_mk(rng, (nc,), cx) if rng.random() < 0.4
             else _mk(rng, (nc, int(rng.integers(1, 5))), cx))
        ref = sla.matmul_toeplitz((c, r), x)
        got = _both("matmul_toeplitz", (c, r), x, cx=cx)
        assert got.shape == ref.shape
        assert _rel(got, ref) < 5e-4


def test_solve_circulant_complex_outaxis_out_of_range():
    rng = np.random.default_rng(5)
    c = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    b = rng.standard_normal((4, 3))
    _raises_both("solve_circulant", np.exceptions.AxisError, None, c, b, outaxis=2)
    _raises_both("solve_circulant", np.exceptions.AxisError, None, c, b, outaxis=-3)
    ref = sla.solve_circulant(c, b, outaxis=-2)
    got = _both("solve_circulant", c, b, outaxis=-2, cx=True)
    assert got.shape == ref.shape and _rel(got, ref) < 5e-4


def test_operands_on_their_device():
    """A tensor operator or right-hand side keeps the call on its device
    (here the CPU, outside any default_device block); a CPU tensor operator
    with numpy data runs the data there too; the result is float32."""
    rng = np.random.default_rng(7)
    c = rng.standard_normal(6)
    c[0] += 8
    b = rng.standard_normal((6, 2))
    ref = sla.solve_toeplitz(c, b)
    got = TL.solve_toeplitz(torch.from_numpy(c), b)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 5e-4
    got = TL.matmul_toeplitz(c, torch.from_numpy(b))
    assert _rel(got.numpy(), sla.matmul_toeplitz(c, b)) < 5e-4
    with pytest.raises(PlanError, match="devices"):
        TL.solve_circulant(torch.from_numpy(c), torch.from_numpy(b).to("meta"))
