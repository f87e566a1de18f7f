"""tests/test_nufft_distributed.py case by case through the port's
``parallel/nufft.py`` in a gloo world of 8 CPU ranks: the same seeded points
and strengths through the JAX package's distributed builder and the port's,
the port held to the JAX result (1e-5 of max|JAX|) and to the test's own
oracle / single-device bars.  The JAX cases that read the compiled HLO read
the port's collective calls instead."""

import numpy as np
import pytest

from torch_dist_support import both_build
from torch_world import raises, world_fixture

world = world_fixture(8)

SP8 = {"sp": 8}
DPSP = {"dp": 2, "sp": 4}


@pytest.fixture
def rng():
    return np.random.default_rng(20260818)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def asc(y):
    y = np.asarray(y, np.float64)
    return y[..., 0] + 1j * y[..., 1]


def direct1(x, c, n, isign=1):
    k = np.arange(-(n // 2), (n + 1) // 2)
    return (c[..., None, :].astype(np.complex128)
            * np.exp(isign * 1j * k[:, None] * x[None, :])).sum(-1)


def direct3(x, c, s, isign=1):
    return (c[..., None, :].astype(np.complex128)
            * np.exp(isign * 1j * s[:, None] * x[None, :])).sum(-1)


def both(world, builder, args, kw, axes, c, tol=1e-5):
    got, want = both_build(world, builder, args, kw, axes, [c], tol=tol,
                           attrs=("n_points",))
    return asc(got)


class TestType1:
    @pytest.mark.parametrize("m", [203, 64, 5])
    def test_1d_vs_oracle_and_single_chip(self, world, rng, m):
        from webgpufft_tpu import nufft as NU
        n = 48
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, 2, m)
        got = both(world, "build_distributed_nufft_type1", [x, n, "MESH"], {}, SP8, c)
        assert _rel(got, direct1(x, c, n)) < 2e-5
        assert _rel(got, asc(NU.nufft1d1(x, c, n))) < 5e-6

    def test_2d_vs_single_chip(self, world, rng):
        from webgpufft_tpu import nufft as NU
        m, ns = 117, (24, 20)
        x, y = (rng.uniform(0, 2 * np.pi, m) for _ in range(2))
        c = _cplx(rng, m)
        got = both(world, "build_distributed_nufft_type1", [[x, y], ns, "MESH"], {},
                   SP8, c)
        assert _rel(got, asc(NU.nufft2d1(x, y, c, ns))) < 5e-6

    def test_3d_vs_single_chip(self, world, rng):
        from webgpufft_tpu import nufft as NU
        m, ns = 61, (8, 10, 6)
        x, y, z = (rng.uniform(0, 2 * np.pi, m) for _ in range(3))
        c = _cplx(rng, m)
        got = both(world, "build_distributed_nufft_type1", [[x, y, z], ns, "MESH"],
                   {"eps": 1e-4}, SP8, c, tol=5e-5)
        assert _rel(got, asc(NU.nufft3d1(x, y, z, c, ns, eps=1e-4))) < 5e-5

    def test_isign_minus_one(self, world, rng):
        m, n = 80, 32
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, m)
        got = both(world, "build_distributed_nufft_type1", [x, n, "MESH"],
                   {"isign": -1}, SP8, c)
        assert _rel(got, direct1(x, c, n, isign=-1)) < 2e-5

    def test_comm_profile_one_all_reduce_no_all_to_all(self, world, rng):
        m, n = 64, 32
        x = rng.uniform(0, 2 * np.pi, m)
        c = np.stack([_cplx(rng, m).real, _cplx(rng, m).imag], -1).astype(np.float32)
        r = world.run("call", "torch_world_cases", "nufft_collectives",
                      "build_distributed_nufft_type1", [x, n], {}, c)
        assert (r["all_reduce"], r["all_to_all"], r["all_gather"], r["p2p"]) == (1, 0, 0, 0)


class TestType2:
    @pytest.mark.parametrize("m", [203, 64])
    def test_1d_vs_oracle_and_single_chip(self, world, rng, m):
        from webgpufft_tpu import nufft as NU
        n = 48
        x = rng.uniform(0, 2 * np.pi, m)
        f = _cplx(rng, 2, n)
        got = both(world, "build_distributed_nufft_type2", [x, n, "MESH"], {}, SP8, f)
        k = np.arange(-(n // 2), (n + 1) // 2)
        ref = np.einsum("bk,mk->bm", f.astype(np.complex128),
                        np.exp(-1j * x[:, None] * k[None, :]))
        assert _rel(got, ref) < 2e-5
        assert _rel(got, asc(NU.nufft1d2(x, f))) < 5e-6

    def test_2d_vs_single_chip(self, world, rng):
        from webgpufft_tpu import nufft as NU
        m, ns = 117, (18, 22)
        x, y = (rng.uniform(0, 2 * np.pi, m) for _ in range(2))
        f = _cplx(rng, *ns)
        got = both(world, "build_distributed_nufft_type2", [[x, y], ns, "MESH"], {},
                   SP8, f)
        assert _rel(got, asc(NU.nufft2d2(x, y, f))) < 5e-6

    def test_collective_free(self, world, rng):
        m, n = 64, 32
        x = rng.uniform(0, 2 * np.pi, m)
        f = _cplx(rng, n)
        f = np.stack([f.real, f.imag], -1).astype(np.float32)
        r = world.run("call", "torch_world_cases", "nufft_collectives",
                      "build_distributed_nufft_type2", [x, n], {}, f)
        assert (r["all_reduce"], r["all_to_all"], r["all_gather"], r["p2p"]) == (0, 0, 0, 0)


class TestComposition:
    def test_dp_x_sp_type1_matches_sp_only(self, world, rng):
        m, n, b = 90, 40, 4
        x = rng.uniform(0, 2 * np.pi, m)
        c = _cplx(rng, b, m)
        a = both(world, "build_distributed_nufft_type1", [x, n, "MESH"],
                 {"batch_axis_name": "dp"}, DPSP, c)
        bb = both(world, "build_distributed_nufft_type1", [x, n, "MESH"], {}, SP8, c)
        assert _rel(a, bb) < 1e-6
        assert _rel(a, direct1(x, c, n)) < 2e-5

    def test_dp_x_sp_type2(self, world, rng):
        from webgpufft_tpu import nufft as NU
        m, n, b = 90, 40, 4
        x = rng.uniform(0, 2 * np.pi, m)
        f = _cplx(rng, b, n)
        got = both(world, "build_distributed_nufft_type2", [x, n, "MESH"],
                   {"batch_axis_name": "dp"}, DPSP, f)
        assert _rel(got, asc(NU.nufft1d2(x, f))) < 5e-6

    def test_gradients_match_single_chip(self, world, rng):
        import jax
        import jax.numpy as jnp
        from webgpufft_tpu import nufft as NU
        m, n = 70, 24
        x = rng.uniform(0, 2 * np.pi, m)
        ci = rng.standard_normal((m, 2)).astype(np.float32)
        g_dist, g_single = world.run("call", "torch_world_cases", "nufft1_grad",
                                     x, n, ci)
        np.testing.assert_allclose(g_dist, g_single, rtol=1e-4, atol=1e-5)
        g_jax = jax.grad(lambda c: jnp.sum(NU.nufft1d1(x, c, n) ** 2))(jnp.asarray(ci))
        np.testing.assert_allclose(g_dist, np.asarray(g_jax), rtol=1e-4, atol=1e-5)

    def test_roundtrip_t2_of_t1_peak(self, world, rng):
        m, n = 128, 32
        x = rng.uniform(0, 2 * np.pi, m)
        c = np.exp(-1j * 3 * x).astype(np.complex64)
        modes = both(world, "build_distributed_nufft_type1", [x, n, "MESH"], {}, SP8, c)
        k = np.arange(-(n // 2), (n + 1) // 2)
        assert np.argmax(np.abs(modes)) == int(np.where(k == 3)[0][0])


def _bad(world, match, builder, args, kw=None, inputs=(), call=False):
    raises(world, "PlanError", match, "build", builder, args, kw or {}, SP8,
           list(inputs), call=call)


class TestValidation:
    def test_bad_mesh_axes(self, world, rng):
        x = rng.uniform(0, 2 * np.pi, 8)
        _bad(world, "no axis", "build_distributed_nufft_type1", [x, 16, "MESH", "nope"])
        _bad(world, "batch axis", "build_distributed_nufft_type1", [x, 16, "MESH"],
             {"batch_axis_name": "dp"})

    def test_zero_points_rejected(self, world):
        _bad(world, "at least one", "build_distributed_nufft_type1",
             [np.zeros(0), 16, "MESH"])

    def test_traced_points_rejected(self, world, rng):
        x = rng.uniform(0, 2 * np.pi, 8)
        raises(world, "PlanError", "concrete", "call", "torch_world_cases",
               "nufft_tracked_points", "build_distributed_nufft_type1", x)

    def test_mismatched_coords(self, world, rng):
        x = rng.uniform(0, 2 * np.pi, 8)
        _bad(world, "same number", "build_distributed_nufft_type1",
             [[x, x[:4]], (8, 8), "MESH"])

    def test_wrong_strength_length(self, world, rng):
        x = rng.uniform(0, 2 * np.pi, 8)
        _bad(world, "trailing length", "build_distributed_nufft_type1",
             [x, 16, "MESH"], inputs=[_cplx(rng, 9)], call=True)

    def test_wrong_mode_shape(self, world, rng):
        x = rng.uniform(0, 2 * np.pi, 8)
        _bad(world, "trailing shape", "build_distributed_nufft_type2",
             [x, 16, "MESH"], inputs=[_cplx(rng, 15)], call=True)

    def test_bad_isign(self, world, rng):
        x = rng.uniform(0, 2 * np.pi, 8)
        _bad(world, "isign", "build_distributed_nufft_type1", [x, 16, "MESH"],
             {"isign": 0})


class TestType3:
    @pytest.mark.parametrize("m,k", [(157, 93), (64, 64), (6, 3)])
    def test_1d_vs_oracle_and_single_chip(self, world, rng, m, k):
        from webgpufft_tpu import nufft as NU
        x = rng.uniform(-4, 7, m)
        s = rng.uniform(-30, 20, k)
        c = _cplx(rng, 2, m)
        got = both(world, "build_distributed_nufft_type3", [x, s, "MESH"], {}, SP8, c)
        assert _rel(got, direct3(x, c, s)) < 2e-5
        assert _rel(got, asc(NU.nufft1d3(x, c, s))) < 5e-6

    def test_2d_vs_oracle(self, world, rng):
        m, k = 84, 41
        x, y = rng.uniform(-2, 2, m), rng.uniform(0, 5, m)
        s, t = rng.uniform(-8, 8, k), rng.uniform(-6, 3, k)
        c = _cplx(rng, m)
        got = both(world, "build_distributed_nufft_type3", [[x, y], [s, t], "MESH"],
                   {}, SP8, c)
        ref = np.einsum("m,km->k", c.astype(np.complex128),
                        np.exp(1j * (np.outer(s, x) + np.outer(t, y))))
        assert _rel(got, ref) < 2e-5

    def test_isign_minus_one(self, world, rng):
        m, k = 60, 50
        x = rng.uniform(-1, 1, m)
        s = rng.uniform(-12, 12, k)
        c = _cplx(rng, m)
        got = both(world, "build_distributed_nufft_type3", [x, s, "MESH"],
                   {"isign": -1}, SP8, c)
        assert _rel(got, direct3(x, c, s, isign=-1)) < 2e-5

    def test_dp_x_sp(self, world, rng):
        m, k, b = 90, 70, 4
        x = rng.uniform(0, 3, m)
        s = rng.uniform(-15, 5, k)
        c = _cplx(rng, b, m)
        got = both(world, "build_distributed_nufft_type3", [x, s, "MESH"],
                   {"batch_axis_name": "dp"}, DPSP, c)
        assert _rel(got, direct3(x, c, s)) < 2e-5

    def test_comm_profile(self, world, rng):
        m, k = 64, 32
        x = rng.uniform(-1, 1, m)
        s = rng.uniform(-9, 9, k)
        c = _cplx(rng, m)
        c = np.stack([c.real, c.imag], -1).astype(np.float32)
        r = world.run("call", "torch_world_cases", "nufft_collectives",
                      "build_distributed_nufft_type3", [x, s], {}, c)
        assert (r["all_reduce"], r["all_to_all"], r["all_gather"], r["p2p"]) == (1, 0, 0, 0)

    def test_rank_mismatch_rejected(self, world, rng):
        x = rng.uniform(-1, 1, 8)
        _bad(world, "same rank", "build_distributed_nufft_type3", [[x, x], x, "MESH"])

    def test_traced_coords_rejected(self, world, rng):
        x = rng.uniform(-1, 1, 8)
        raises(world, "PlanError", "concrete", "call", "torch_world_cases",
               "nufft_tracked_points", "build_distributed_nufft_type3", x)
