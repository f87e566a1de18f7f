"""The port's NUFFT (webgpufft_tpu_torch/nufft.py) against the JAX package's
and the exact direct-NDFT oracle, case by case as tests/test_nufft.py: the
same seeded numpy points and strengths through both packages (the port on
the CPU device).  Each case holds the port against the oracle at the JAX
test's own bar and against the JAX package at ``TOL_JAX`` of max|expected|
(both compute in f32 from the same host-f64 base/residual split, in another
summation order).  Where the JAX test traces under ``jax.jit`` /
``jax.grad``, the port's case gives tensors that require grad
(``radix.tracked``): points then take the device-f32 path and gradients
reach them through the Gaussian taps."""

import numpy as np
import pytest
import torch

from webgpufft_tpu import nufft as JN
from webgpufft_tpu.spec import PlanError as JPlanError
from webgpufft_tpu_torch import PlanError
from webgpufft_tpu_torch import fftapi as TF
from webgpufft_tpu_torch import nufft as NU
from torch_port_support import assert_close, to_numpy

TOL_JAX = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(2026)


def direct1(x, c, n, isign=1):
    k = np.arange(-(n // 2), (n + 1) // 2)
    return (c[None, :].astype(np.complex128)
            * np.exp(isign * 1j * k[:, None] * x[None, :])).sum(1)


def direct2(x, f, isign=-1):
    n = len(f)
    k = np.arange(-(n // 2), (n + 1) // 2)
    return (f[None, :].astype(np.complex128)
            * np.exp(isign * 1j * x[:, None] * k[None, :])).sum(1)


def direct3(x, c, s, isign=1):
    return (c[None, :].astype(np.complex128)
            * np.exp(isign * 1j * s[:, None] * x[None, :])).sum(1)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _c(y):
    y = to_numpy(y)
    return y[..., 0] + 1j * y[..., 1]


def _both(name, *args, **kw):
    """``name`` of both packages on the same numpy arguments: the port's
    interleaved result (numpy) after holding it against the JAX one."""
    want = np.asarray(getattr(JN, name)(*args, **kw))
    with TF.default_device("cpu"):
        got = getattr(NU, name)(*args, **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = to_numpy(got)
    assert got.shape == want.shape, f"nufft.{name}: {got.shape} != {want.shape}"
    if want.size:
        assert_close(got, want, TOL_JAX, f"nufft.{name}")
    return got


def _raises_both(name, match, *args, **kw):
    with pytest.raises(JPlanError, match=match):
        getattr(JN, name)(*args, **kw)
    with TF.default_device("cpu"), pytest.raises(PlanError, match=match):
        getattr(NU, name)(*args, **kw)


class Test1D:
    @pytest.mark.parametrize("n", [16, 31, 50])
    @pytest.mark.parametrize("isign", [1, -1])
    def test_type1_matches_direct(self, rng, n, isign):
        m = 120
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        got = _c(_both("nufft1d1", x, c, n, isign=isign))
        assert _rel(got, direct1(x, c, n, isign)) < 2e-5

    @pytest.mark.parametrize("n", [16, 31])
    @pytest.mark.parametrize("isign", [1, -1])
    def test_type2_matches_direct(self, rng, n, isign):
        m = 90
        x = rng.uniform(0, 2 * np.pi, m)
        f = _cplx(rng, n)
        got = _c(_both("nufft1d2", x, f, isign=isign))
        assert _rel(got, direct2(x, f, isign)) < 2e-5

    def test_eps_controls_accuracy(self, rng):
        m, n = 200, 40
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        ref = direct1(x, c, n)
        loose = _rel(_c(_both("nufft1d1", x, c, n, eps=1e-2)), ref)
        tight = _rel(_c(_both("nufft1d1", x, c, n, eps=1e-6)), ref)
        assert tight < 2e-5
        assert loose < 1e-2
        assert tight <= loose

    def test_points_wrap_mod_2pi(self, rng):
        m, n = 60, 24
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        a = _both("nufft1d1", x, c, n)
        b = _both("nufft1d1", x + 2 * np.pi, c, n)
        d = _both("nufft1d1", x - 4 * np.pi, c, n)
        assert np.max(np.abs(a - b)) < 1e-4
        assert np.max(np.abs(a - d)) < 1e-4

    def test_type2_is_transpose_of_type1(self, rng):
        m, n = 7, 6
        x = rng.uniform(0, 2 * np.pi, m)
        a1 = np.zeros((n, m), np.complex128)
        for j in range(m):
            e = np.zeros(m, np.complex64)
            e[j] = 1.0
            a1[:, j] = _c(_both("nufft1d1", x, e, n, isign=1))
        a2 = np.zeros((m, n), np.complex128)
        for k in range(n):
            e = np.zeros(n, np.complex64)
            e[k] = 1.0
            a2[:, k] = _c(_both("nufft1d2", x, e, isign=1))
        assert np.max(np.abs(a1 - a2.T)) < 1e-4

    def test_batch_leading_dims(self, rng):
        m, n = 80, 20
        x = rng.uniform(0, 2 * np.pi, m)
        cb = _cplx(rng, 2, 3, m)
        out = _both("nufft1d1", x, cb, n)
        assert out.shape == (2, 3, n, 2)
        assert _rel(_c(out[1, 2]), direct1(x, cb[1, 2], n)) < 2e-5

    def test_jit_and_grads(self, rng):
        """Points and strengths require grad (the JAX case's jax.grad over
        both): the tracked points take the device-f32 path; the gradient
        wrt one point against the finite difference of the direct sum."""
        m, n = 40, 16
        x = torch.from_numpy(rng.uniform(0, 2 * np.pi, m).astype(np.float32)).requires_grad_()
        ci = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32)).requires_grad_()
        gx, gc = torch.autograd.grad(NU.nufft1d1(x, ci, n).pow(2).sum(), (x, ci))
        assert torch.isfinite(gx).all() and torch.isfinite(gc).all()
        # the JAX package's gradient over the same f32 points
        import jax
        import jax.numpy as jnp
        jgx = jax.grad(lambda p: jnp.sum(JN.nufft1d1(p, ci.detach().numpy(), n) ** 2))(
            jnp.asarray(x.detach().numpy()))
        assert_close(gx.numpy(), np.asarray(jgx), 1e-3, "grad over points vs JAX")
        eps = 1e-3
        xp = x.detach().numpy().astype(np.float64)
        cc = ci.detach().numpy()[..., 0] + 1j * ci.detach().numpy()[..., 1]

        def loss_direct(xv):
            f = direct1(xv, cc, n)
            return float(np.sum(f.real ** 2 + f.imag ** 2))

        j = 7
        xp1, xp2 = xp.copy(), xp.copy()
        xp1[j] += eps
        xp2[j] -= eps
        fd = (loss_direct(xp1) - loss_direct(xp2)) / (2 * eps)
        assert abs(float(gx[j]) - fd) / max(abs(fd), 1e-6) < 1e-2

    def test_validation(self, rng):
        x = rng.uniform(0, 2 * np.pi, 10)
        c = _cplx(rng, 10)
        _raises_both("nufft1d1", "eps", x, c, 16, eps=2.0)
        _raises_both("nufft1d1", "n_modes", x, c, 1)
        _raises_both("nufft1d1", "trailing", x, _cplx(rng, 11), 16)
        _raises_both("nufft1d1", "1-D", x.reshape(2, 5), c, 16)


class Test2D:
    @pytest.mark.parametrize("n_modes", [(12, 18), (9, 9)])
    @pytest.mark.parametrize("isign", [1, -1])
    def test_type1_matches_direct(self, rng, n_modes, isign):
        m = 100
        n1, n2 = n_modes
        x = rng.uniform(0, 2 * np.pi, m)
        y = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        k1 = np.arange(-(n1 // 2), (n1 + 1) // 2)
        k2 = np.arange(-(n2 // 2), (n2 + 1) // 2)
        ref = np.einsum(
            "j,kj,lj->kl", c.astype(np.complex128),
            np.exp(isign * 1j * k1[:, None] * x[None, :]),
            np.exp(isign * 1j * k2[:, None] * y[None, :]))
        got = _c(_both("nufft2d1", x, y, c, n_modes, isign=isign))
        assert _rel(got, ref) < 2e-5

    @pytest.mark.parametrize("isign", [1, -1])
    def test_type2_matches_direct(self, rng, isign):
        m, n1, n2 = 80, 10, 14
        x = rng.uniform(0, 2 * np.pi, m)
        y = rng.uniform(0, 2 * np.pi, m)
        f = _cplx(rng, n1, n2)
        k1 = np.arange(-(n1 // 2), (n1 + 1) // 2)
        k2 = np.arange(-(n2 // 2), (n2 + 1) // 2)
        ref = np.einsum(
            "kl,jk,jl->j", f.astype(np.complex128),
            np.exp(isign * 1j * x[:, None] * k1[None, :]),
            np.exp(isign * 1j * y[:, None] * k2[None, :]))
        got = _c(_both("nufft2d2", x, y, f, isign=isign))
        assert _rel(got, ref) < 2e-5

    def test_roundtrip_uniform_points_recover_fft(self, rng):
        n = 16
        x = 2 * np.pi * np.arange(n) / n
        c = _cplx(rng, n)
        got = _c(_both("nufft1d1", x, c, n))
        ref = np.fft.fftshift(np.fft.ifft(c.astype(np.complex128)) * n)
        assert _rel(got, direct1(x, c, n)) < 2e-5
        assert _rel(got, ref) < 2e-5

    def test_mismatched_points_raise(self, rng):
        _raises_both("nufft2d1", "same number", np.zeros(5), np.zeros(6), _cplx(rng, 5), (8, 8))

    def test_n_modes_validation(self, rng):
        x = rng.uniform(0, 2 * np.pi, 10)
        c = _cplx(rng, 10)
        _raises_both("nufft2d1", "sequence of 2", x, x, c, 8)
        _raises_both("nufft2d1", "2 entries", x, x, c, (8, 8, 8))

    def test_small_mode_counts_stay_accurate(self, rng):
        m, n = 80, 6
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        got = _c(_both("nufft1d1", x, c, n))
        assert _rel(got, direct1(x, c, n)) < 1e-5


class Test3D:
    @pytest.mark.parametrize("isign", [1, -1])
    def test_type1_and_type2_match_direct(self, rng, isign):
        m, n1, n2, n3 = 60, 8, 10, 6
        x, y, z = (rng.uniform(0, 2 * np.pi, m) for _ in range(3))
        c = _cplx(rng, m)
        k1 = np.arange(-(n1 // 2), (n1 + 1) // 2)
        k2 = np.arange(-(n2 // 2), (n2 + 1) // 2)
        k3 = np.arange(-(n3 // 2), (n3 + 1) // 2)
        ref = np.einsum(
            "j,kj,lj,mj->klm", c.astype(np.complex128),
            np.exp(isign * 1j * k1[:, None] * x[None, :]),
            np.exp(isign * 1j * k2[:, None] * y[None, :]),
            np.exp(isign * 1j * k3[:, None] * z[None, :]))
        got = _c(_both("nufft3d1", x, y, z, c, (n1, n2, n3), isign=isign))
        assert _rel(got, ref) < 2e-5
        f = _cplx(rng, n1, n2, n3)
        ref2 = np.einsum(
            "klm,jk,jl,jm->j", f.astype(np.complex128),
            np.exp(-isign * 1j * x[:, None] * k1[None, :]),
            np.exp(-isign * 1j * y[:, None] * k2[None, :]),
            np.exp(-isign * 1j * z[:, None] * k3[None, :]))
        got2 = _c(_both("nufft3d2", x, y, z, f, isign=-isign))
        assert _rel(got2, ref2) < 2e-5

    def test_jit_composes(self, rng):
        """Strengths that require grad (the JAX case jits over c)."""
        m, n = 30, 6
        x, y, z = (torch.from_numpy(rng.uniform(0, 2 * np.pi, m).astype(np.float32))
                   for _ in range(3))
        ci = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32)).requires_grad_()
        out = NU.nufft3d1(x, y, z, ci, (n, n, n))
        assert tuple(out.shape) == (n, n, n, 2) and torch.isfinite(out).all()
        want = np.asarray(JN.nufft3d1(*(p.numpy() for p in (x, y, z)), ci.detach().numpy(),
                                      (n, n, n)))
        assert_close(out.detach().numpy(), want, TOL_JAX, "nufft3d1 tracked strengths")
        g, = torch.autograd.grad(out.pow(2).sum(), ci)
        assert torch.isfinite(g).all()

    def test_point_chunking_matches_unchunked(self, rng, monkeypatch):
        m, n = 150, 8
        x, y, z = (rng.uniform(0, 2 * np.pi, m) for _ in range(3))
        c = _cplx(rng, m)
        f = _cplx(rng, n, n, n)
        ref1 = _both("nufft3d1", x, y, z, c, (n, n, n))
        ref2 = _both("nufft3d2", x, y, z, f)
        monkeypatch.setattr(NU, "_CHUNK_TAP_ELEMS", 1 << 12)
        with TF.default_device("cpu"):
            got1 = to_numpy(NU.nufft3d1(x, y, z, c, (n, n, n)))
            got2 = to_numpy(NU.nufft3d2(x, y, z, f))
        assert _rel(got1, ref1) < 1e-5
        assert _rel(got2, ref2) < 1e-5

    def test_chunk_count_stays_bounded(self):
        """The JAX package caps the chunk count (an unroll bound under
        jit); the port has no unroll and bounds the tap transient instead:
        B * chunk * taps <= _CHUNK_TAP_ELEMS, 16384 points of the 4096
        taps of a 3-D eps=1e-6 call, 16 chunks for 2^18 points."""
        step = NU._point_step(1, 10_000_000, 4096)
        assert step * 4096 <= NU._CHUNK_TAP_ELEMS and step == 16384
        assert -(-(1 << 18) // NU._point_step(1, 1 << 18, 4096)) == 16
        assert NU._point_step(8, 1 << 17, 256) * 8 * 256 <= NU._CHUNK_TAP_ELEMS
        assert NU._point_step(1, 5, 4096) == 5 and NU._point_step(1, 0, 4096) == 1


class TestType3:
    @pytest.mark.parametrize("isign", [1, -1])
    def test_1d_matches_direct(self, rng, isign):
        m, k = 120, 90
        x = rng.uniform(-3.0, 7.0, m)
        s = rng.uniform(-40.0, 25.0, k)
        c = _cplx(rng, m)
        got = _c(_both("nufft1d3", x, c, s, isign=isign))
        assert _rel(got, direct3(x, c, s, isign)) < 1e-5

    def test_2d_and_3d_match_direct(self, rng):
        m, k = 80, 60
        x, y, z = (rng.uniform(-2, 5, m) for _ in range(3))
        s, t, u = (rng.uniform(-15, 10, k) for _ in range(3))
        c = _cplx(rng, m)
        ref2 = (c[None, :].astype(np.complex128)
                * np.exp(1j * (s[:, None] * x[None, :]
                               + t[:, None] * y[None, :]))).sum(1)
        got2 = _c(_both("nufft2d3", x, y, c, s, t))
        assert _rel(got2, ref2) < 1e-5
        ref3 = (c[None, :].astype(np.complex128)
                * np.exp(1j * (s[:, None] * x[None, :]
                               + t[:, None] * y[None, :]
                               + u[:, None] * z[None, :]))).sum(1)
        got3 = _c(_both("nufft3d3", x, y, z, c, s, t, u))
        assert _rel(got3, ref3) < 1e-5

    def test_integer_targets_match_type1(self, rng):
        m, n = 70, 24
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        ks = np.arange(-(n // 2), (n + 1) // 2).astype(np.float64)
        t3 = _c(_both("nufft1d3", x, c, ks))
        t1 = _c(_both("nufft1d1", x, c, n))
        assert _rel(t3, t1) < 1e-5

    def test_degenerate_extents(self, rng):
        m, k = 40, 30
        c = _cplx(rng, m)
        x0 = np.full(m, 2.7)
        s = rng.uniform(-30, 30, k)
        assert _rel(_c(_both("nufft1d3", x0, c, s)), direct3(x0, c, s)) < 1e-5
        x = rng.uniform(-2, 2, m)
        s0 = np.full(k, -4.2)
        assert _rel(_c(_both("nufft1d3", x, c, s0)), direct3(x, c, s0)) < 1e-5
        got = _c(_both("nufft1d3", x[:1], c[:1], s[:1]))
        assert _rel(got, direct3(x[:1], c[:1], s[:1])) < 1e-5

    def test_eps_controls_accuracy(self, rng):
        m, k = 100, 50
        x = rng.uniform(-2, 2, m)
        s = rng.uniform(-20, 20, k)
        c = _cplx(rng, m)
        ref = direct3(x, c, s)
        loose = _rel(_c(_both("nufft1d3", x, c, s, eps=1e-2)), ref)
        tight = _rel(_c(_both("nufft1d3", x, c, s, eps=1e-6)), ref)
        assert tight < 1e-5
        assert loose < 1e-1
        assert tight <= loose

    def test_batch_and_jit_in_strengths(self, rng):
        m, k = 60, 40
        x = rng.uniform(-1, 1, m)
        s = rng.uniform(-10, 10, k)
        cb = _cplx(rng, 2, 3, m)
        out = _both("nufft1d3", x, cb, s)
        assert out.shape == (2, 3, k, 2)
        assert _rel(_c(out[1, 2]), direct3(x, cb[1, 2], s)) < 1e-5
        ci = torch.from_numpy(np.stack([cb[0, 0].real, cb[0, 0].imag], -1)).requires_grad_()
        got = NU.nufft1d3(x, ci, s)
        assert _rel(_c(got.detach()), direct3(x, cb[0, 0], s)) < 1e-5
        g, = torch.autograd.grad(got.pow(2).sum(), ci)
        assert torch.isfinite(g).all()

    def test_traced_coordinates_rejected(self, rng):
        m, k = 20, 10
        x = rng.uniform(-1, 1, m)
        s = rng.uniform(-5, 5, k)
        ci = rng.standard_normal((m, 2)).astype(np.float32)
        with pytest.raises(PlanError, match="concrete"):
            NU.nufft1d3(torch.from_numpy(x).requires_grad_(), torch.from_numpy(ci), s)
        _raises_both("nufft2d3", "same length", x, np.zeros(m + 1), ci, s, s)
        _raises_both("nufft1d3", "non-empty", np.zeros(0), np.zeros((0, 2)), s)


class TestAccuracyFloor:
    def test_host_points_stay_accurate_at_large_n(self, rng):
        m, n = 300, 4096
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        got = _c(_both("nufft1d1", x, c, n))
        assert _rel(got, direct1(x, c, n)) < 3e-5


class TestReviewFixes:
    def test_zero_points_type1_gives_zero_modes(self):
        out = _c(_both("nufft1d1", np.zeros(0), np.zeros((0, 2), np.float32), 8))
        assert out.shape == (8,)
        assert np.all(out == 0)

    def test_zero_points_type2_gives_empty_values(self, rng):
        f = _cplx(rng, 8)
        assert _both("nufft1d2", np.zeros(0), f).shape == (0, 2)
        assert _both("nufft2d2", np.zeros(0), np.zeros(0), _cplx(rng, 8, 6)).shape == (0, 2)

    def test_zero_points_batched(self, rng):
        out = _both("nufft1d1", np.zeros(0), np.zeros((3, 0, 2), np.float32), 8)
        assert out.shape == (3, 8, 2)
        assert np.all(out == 0)

    @pytest.mark.parametrize("bad", [0, 2, -3])
    def test_isign_validated_types_1_and_2(self, rng, bad):
        x = rng.uniform(0, 2 * np.pi, 10)
        c = _cplx(rng, 10)
        _raises_both("nufft1d1", "isign", x, c, 8, isign=bad)
        _raises_both("nufft1d2", "isign", x, _cplx(rng, 8), isign=bad)

    def test_length1_tuple_n_modes_in_1d(self, rng):
        x = rng.uniform(0, 2 * np.pi, 30)
        c = _cplx(rng, 30)
        a = _both("nufft1d1", x, c, 16)
        b = _both("nufft1d1", x, c, (16,))
        assert np.array_equal(a, b)
        _raises_both("nufft1d1", "1 entries", x, c, (16, 16))

    def test_fine_grid_int32_overflow_rejected(self, rng):
        x = rng.uniform(0, 2 * np.pi, 4)
        c = _cplx(rng, 4)
        _raises_both("nufft3d1", "int32", x, x, x, c, (700, 700, 700))

    def test_chunked_taps_match_single_chunk(self, rng, monkeypatch):
        m, n = 64, 24
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        f = _cplx(rng, n)
        ref1 = _both("nufft1d1", x, c, n)
        ref2 = _both("nufft1d2", x, f)
        monkeypatch.setattr(NU, "_CHUNK_TAP_ELEMS", 64)
        with TF.default_device("cpu"):
            got1 = to_numpy(NU.nufft1d1(x, c, n))
            got2 = to_numpy(NU.nufft1d2(x, f))
        np.testing.assert_allclose(got1, ref1, rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(got2, ref2, rtol=2e-6, atol=2e-6)


def test_adjoint_dot_type1_type2(rng):
    """<A c, f> = <c, A^H f>: type 1 with isign +1 and type 2 with isign -1
    are adjoint (the dot test the chip script runs at full size)."""
    m, n = 50, (10, 12)
    x, y = rng.uniform(0, 2 * np.pi, m), rng.uniform(0, 2 * np.pi, m)
    c, f = _cplx(rng, m), _cplx(rng, *n)
    with TF.default_device("cpu"):
        ac = _c(NU.nufft2d1(x, y, c, n, isign=1))
        ahf = _c(NU.nufft2d2(x, y, f, isign=-1))
    lhs = np.vdot(f, ac)
    rhs = np.vdot(ahf, c)
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_tensors_run_where_they_live(rng):
    """Tensor points and strengths keep the call on their device (here the
    CPU, outside any default_device block); float64 tensor points take the
    host-f64 base/residual split when nothing tracks them."""
    m, n = 40, 12
    x = rng.uniform(0, 2 * np.pi, m)
    c = _cplx(rng, m)
    got = NU.nufft1d1(torch.from_numpy(x), torch.from_numpy(c), n)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(JN.nufft1d1(x, c, n)), TOL_JAX, "tensor inputs")
    with pytest.raises(PlanError, match="devices"):
        NU.nufft1d1(torch.from_numpy(x), torch.from_numpy(c).to("meta"), n)
