"""tests/test_sharded.py case by case through the port's
``parallel/sharded.py``, in a gloo world of 8 CPU ranks (``torch_world``):
the same seeded numpy input goes through the JAX builder (8 virtual CPU
devices) and the port's, and the port is held to both the JAX package's
output and the test's own reference at its tolerance."""

import numpy as np
import pytest

from torch_dist_support import both_build, cx, il, jax_mesh, unil
from torch_port_support import assert_close, assert_close_c
from torch_world import raises, world_fixture
from webgpufft_tpu.utils import mathref as R

world = world_fixture(8)

DP8 = {"dp": 8}
DP2SP4 = {"dp": 2, "sp": 4}
SP8 = {"sp": 8}


def test_make_mesh_validates(world):
    raises(world, "ValueError", "devices", "mesh", {"dp": 64})


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 4}, {"sp": 4}, {"dp": 8}])
def test_make_mesh_ici_optimized_and_plain_agree_in_shape(world, axes):
    """The port's mesh has the JAX mesh's dim names and shape, and the
    ranks in the JAX mesh's device-id order (ici_optimized has no effect)."""
    ranks, names = world.run("mesh", axes)
    jm = jax_mesh(axes)
    assert names == tuple(jm.axis_names)
    np.testing.assert_array_equal(ranks, np.vectorize(lambda d: d.id)(jm.devices))


def test_make_mesh_dcn_path(world):
    """dcn= arranges ranks as mesh_utils.create_hybrid_device_mesh arranges
    devices; invalid factors and unknown axes are rejected."""
    ranks, _ = world.run("mesh", {"dp": 2, "sp": 4}, dcn={"dp": 1})
    jm = jax_mesh({"dp": 2, "sp": 4}, dcn={"dp": 1})
    np.testing.assert_array_equal(ranks, np.vectorize(lambda d: d.id)(jm.devices))
    raises(world, "ValueError", "does not divide", "mesh", {"dp": 3}, dcn={"dp": 2})
    raises(world, "ValueError", "not in the mesh", "mesh", {"dp": 4}, dcn={"xx": 2})


class _FakeDevice:
    """What create_hybrid_device_mesh reads of a device, for a fabric of
    several slices (granules) that the CPU test process does not have."""
    platform = "cpu"
    device_kind = "cpu"

    def __init__(self, i, per):
        self.id = i
        self.slice_index = i // per
        self.process_index = i // per
        self.coords = (i, 0, 0)
        self.core_on_chip = 0

    def __repr__(self):
        return f"D{self.id}"


@pytest.mark.parametrize("ici,dcn", [((2, 2), (2, 1)), ((1, 4), (2, 1)),
                                     ((2, 1), (1, 4)), ((2, 2, 1), (1, 1, 2))])
def test_hybrid_rank_array_matches_mesh_utils(ici, dcn):
    """The port's rank arrangement for dcn= is the device arrangement of
    mesh_utils.create_hybrid_device_mesh, granule = one slice."""
    from jax.experimental import mesh_utils
    from webgpufft_tpu_torch.parallel.sharded import hybrid_rank_array
    n = int(np.prod(ici)) * int(np.prod(dcn))
    per = int(np.prod(ici))
    devs = [_FakeDevice(i, per) for i in range(n)]
    try:
        arr = mesh_utils.create_hybrid_device_mesh(list(ici), list(dcn),
                                                   devices=devs)
    except Exception as e:   # noqa: BLE001
        pytest.fail(f"mesh_utils refused the fake fabric: {e}")
    want = np.vectorize(lambda d: d.id)(arr)
    np.testing.assert_array_equal(hybrid_rank_array(ici, dcn, range(n)), want)


def test_batch_sharded_c2c(world, rng):
    n, batch = 128, 32
    z = cx(rng, batch, n)
    r = world.run("call", "torch_world_cases", "shard_batch_c2c", il(z), DP8)
    ref = R.fft_nd(z, [n], "forward")
    assert_close(unil(r).real, ref.real, label="dp.re")
    assert_close(unil(r).imag, ref.imag, label="dp.im")


def test_batch_sharded_fftconv(world, rng):
    x = cx(rng, 16, 16)
    k = cx(rng, 5)
    r = world.run("plan", {"type": "fftconv", "shape": [16], "batch": 16,
                           "fftConv": {"boundary": "linear-same", "kernelShape": [5]}},
                  DP8, "dp", None, [il(x)], il(k))
    ref = R.fftconv(x, k, [16], batch=16, boundary="linear-same", kernel_shape=[5])
    assert_close(unil(r["out"]).real, ref.real, label="dp fftconv.re")


@pytest.mark.parametrize("n,ndev_axis", [(1024, "dp"), (4096, "dp")])
def test_distributed_fft_1d(world, n, ndev_axis, rng):
    batch = 2
    z = cx(rng, batch, n)
    got, _ = both_build(world, "build_distributed_fft_1d",
                        [n, "MESH", "dp", "forward"], {}, DP8, [il(z)])
    y = unil(got.reshape(batch, n, 2))
    ref = R.fft_nd(z, [n], "forward")
    assert_close(y.real, ref.real, label=f"dist{n}.re")
    assert_close(y.imag, ref.imag, label=f"dist{n}.im")


def test_distributed_fft_inverse_normalized(world, rng):
    n, batch = 1024, 2
    z = cx(rng, batch, n)
    back = world.run("call", "torch_world_cases", "fft_roundtrip", il(z), n, DP8)
    assert_close(unil(back).real, z.real, label="dist roundtrip.re")
    assert_close(unil(back).imag, z.imag, label="dist roundtrip.im")


def test_distributed_split_validation(world):
    from webgpufft_tpu_torch.parallel.sharded import choose_distributed_split
    raises(world, "UnsplittableAxisError", "split", "build",
           "build_distributed_fft_1d", [17 * 8, "MESH", "dp"], {}, DP8, call=False)
    assert choose_distributed_split(2 ** 20, 8) == (1024, 1024)
    assert choose_distributed_split(64, 8) == (8, 8)
    assert choose_distributed_split(12, 8) is None


def test_2d_mesh_dp_plus_sp(world, rng):
    n, batch = 256, 4
    z = cx(rng, batch, n)
    got, _ = both_build(world, "build_distributed_fft_1d",
                        [n, "MESH", "sp", "forward"], {}, DP2SP4, [il(z)])
    ref = R.fft_nd(z, [n], "forward")
    assert_close(unil(got.reshape(batch, n, 2)).real, ref.real, label="dp+sp.re")


def test_distributed_fft_axis0_nd(world, rng):
    shape, batch = (256, 12), 2
    z = cx(rng, batch, *shape)
    got, _ = both_build(world, "build_distributed_fft_axis0",
                        [list(shape), "MESH", "dp", "forward"], {}, DP8, [il(z)])
    got = unil(got.reshape(batch, *shape, 2))
    ref = np.fft.fft(z, axis=1)
    assert_close(got.real, ref.real, label="nd-axis0.re")
    assert_close(got.imag, ref.imag, label="nd-axis0.im")


def test_distributed_axis0_composes_with_local_axes(world, rng):
    """Full 2D FFT: distributed axis 0 + a local plan for axis 1."""
    shape, batch = (256, 16), 2
    z = cx(rng, batch, *shape)
    y = world.run("call", "torch_world_cases", "axis0_then_local", il(z), shape, DP8)
    ref = np.fft.fft2(z, axes=(1, 2))
    assert_close(unil(y).real, ref.real, label="2d dist+local.re")
    assert_close(unil(y).imag, ref.imag, label="2d dist+local.im")


def test_distributed_r2c(world, rng):
    n, batch = 512, 4
    x = rng.standard_normal((batch, n)).astype(np.float32)
    got, _ = both_build(world, "build_distributed_r2c_1d", [n, "MESH", "dp"], {},
                        DP8, [x])
    ref = np.fft.rfft(x, axis=1)
    assert_close(unil(got).real, ref.real, label="dist-r2c.re")
    assert_close(unil(got).imag, ref.imag, label="dist-r2c.im")


def test_distributed_r2c_normalized(world, rng):
    n, batch = 256, 2
    x = rng.standard_normal((batch, n)).astype(np.float32)
    got, _ = both_build(world, "build_distributed_r2c_1d", [n, "MESH", "dp"],
                        {"normalize": "unitary"}, DP8, [x])
    assert_close(unil(got).real, np.fft.rfft(x, axis=1).real / np.sqrt(n),
                 label="dist-r2c unitary")


def test_distributed_fftconv(world, rng):
    """Circular fftconv on the dp x sp mesh, a NON-square digit split."""
    n, batch = 512, 4
    z, kt = cx(rng, batch, n), cx(rng, n)
    got, _ = both_build(world, "build_distributed_fftconv_1d",
                        [n, "MESH", "sp"], {"batch_axis_name": "dp"}, DP2SP4,
                        [il(z), il(kt)])
    n1, n2 = world.run("build", "build_distributed_fftconv_1d", [n, "MESH", "sp"],
                       {"batch_axis_name": "dp"}, DP2SP4, attrs=["split"],
                       call=False)["attrs"]["split"]
    assert n1 != n2
    ref = np.fft.ifft(np.fft.fft(z, axis=1) * np.fft.fft(kt), axis=1)
    assert_close(unil(got).real, ref.real, label="dist-fftconv.re")
    assert_close(unil(got).imag, ref.imag, label="dist-fftconv.im")


def test_distributed_fftconv_correlation(world, rng):
    n, batch = 256, 2
    z, kt = cx(rng, batch, n), cx(rng, n)
    got, _ = both_build(world, "build_distributed_fftconv_1d", [n, "MESH", "dp"],
                        {"mode": "correlation"}, DP8, [il(z), il(kt)])
    ref = np.fft.ifft(np.fft.fft(z, axis=1) * np.conj(np.fft.fft(kt)), axis=1)
    assert_close(unil(got).real, ref.real, label="dist-corr.re")
    assert_close(unil(got).imag, ref.imag, label="dist-corr.im")


def test_distributed_r2c_odd_widens(world, rng):
    n = 255
    x = rng.standard_normal((2, n))
    got, _ = both_build(world, "build_distributed_r2c_1d", [n, "MESH", "dp"], {},
                        DP8, [x.astype(np.float32)], jit=False)
    ref = np.fft.rfft(x, axis=-1)
    assert got.shape == (2, n // 2 + 1, 2)
    assert_close(got[..., 0], ref.real, label="odd r2c.re")
    assert_close(got[..., 1], ref.imag, label="odd r2c.im")


def test_distributed_fftconv_nd(world, rng):
    shape, batch = (256, 6, 5), 2
    z, kt = cx(rng, batch, *shape), cx(rng, *shape)
    got, _ = both_build(world, "build_distributed_fftconv_nd",
                        [list(shape), "MESH", "sp"], {"batch_axis_name": "dp"},
                        DP2SP4, [il(z), il(kt)])
    ref = np.fft.ifftn(np.fft.fftn(z, axes=(1, 2, 3)) * np.fft.fftn(kt),
                       axes=(1, 2, 3))
    assert_close(unil(got).real, ref.real, label="nd-dist-conv.re")
    assert_close(unil(got).imag, ref.imag, label="nd-dist-conv.im")


def test_distributed_fftconv_nd_correlation_rader_rest_axis(world, rng):
    shape, batch = (256, 7), 2
    z, kt = cx(rng, batch, *shape), cx(rng, *shape)
    got, _ = both_build(world, "build_distributed_fftconv_nd",
                        [list(shape), "MESH", "dp"], {"mode": "correlation"},
                        DP8, [il(z), il(kt)])
    ref = np.fft.ifftn(np.fft.fftn(z, axes=(1, 2)) * np.conj(np.fft.fftn(kt)),
                       axes=(1, 2))
    assert_close(unil(got).real, ref.real, label="nd-dist-corr.re")
    assert_close(unil(got).imag, ref.imag, label="nd-dist-corr.im")


def test_distributed_operand_bounds(world, rng):
    """The JAX package slabs the batch and bounds per-device operands (an
    XLA-TPU fact); the port runs the same shape whole and raises no
    per-device error, even with the bound the JAX test sets."""
    n, batch = 256, 32
    z = cx(rng, batch, n)
    r = world.run("build", "build_distributed_fft_1d", [n, "MESH", "dp", "forward"],
                  {"batch_axis_name": None}, DP8, [il(z)])
    y = unil(r["out"].reshape(batch, n, 2))
    assert_close_c(y, np.fft.fft(z, axis=1), label="dist-whole")


STFT_CASES = [
    (256, 192, 4000, "hann"),
    (128, 64, 4544, "hann"),
    (64, 0, 4544, "boxcar"),
    (100, 37, 3969, "hann"),
]


class TestDistributedStft:
    @pytest.mark.parametrize("W,O,n,win", STFT_CASES)
    def test_matches_facade(self, world, W, O, n, win):
        from webgpufft_tpu import fft as wfft
        x = np.random.default_rng(0).standard_normal((2, n)).astype(np.float32)
        kw = {"fs": 50.0, "window": win, "nperseg": W, "noverlap": O}
        Zd, _ = both_build(world, "build_distributed_stft", [n, "MESH", "sp"], kw,
                           SP8, [x], attrs=())
        f, t, _ = world.run("build", "build_distributed_stft", [n, "MESH", "sp"],
                            kw, SP8, call=False)["extra"] + (None,)
        fr, tr, Zr = wfft.stft(x, **kw)
        assert np.allclose(f, np.asarray(fr)) and np.allclose(t, np.asarray(tr))
        Zr = np.asarray(Zr)
        assert Zd.shape == Zr.shape
        assert np.max(np.abs(Zd - Zr)) / max(np.max(np.abs(Zr)), 1e-6) < 1e-5
        xr, _ = both_build(world, "build_distributed_istft", [n, "MESH", "sp"], kw,
                           SP8, [Zr], attrs=(), tol=2e-5)
        assert xr.shape == x.shape
        assert np.max(np.abs(xr - x)) < 2e-5 * max(np.max(np.abs(x)), 1)

    def test_no_all_to_all(self, world):
        """The comm profile is the O(W) halo: the port's STFT calls
        ppermute and no all_to_all."""
        calls = world.run("call", "torch_world_cases", "stft_collectives", 4000)
        assert calls["all_to_all"] == 0 and calls["p2p"] == 1
        assert calls["all_gather"] == 0

    def test_frame_split_validation(self, world):
        raises(world, "ValueError", "frame count", "build", "build_distributed_stft",
               [1000, "MESH", "sp"], {"nperseg": 256, "noverlap": 192}, SP8,
               call=False)

    def test_1d_input_and_nfft(self, world):
        from webgpufft_tpu import fft as wfft
        n = 4544
        x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        kw = {"nperseg": 128, "noverlap": 64, "nfft": 256}
        Zd, _ = both_build(world, "build_distributed_stft", [n, "MESH", "sp"], kw,
                           SP8, [x], attrs=(), jit=False)
        _, _, Zr = wfft.stft(x, **kw)
        Zr = np.asarray(Zr)
        assert Zd.shape == Zr.shape
        assert np.max(np.abs(Zd - Zr)) < 1e-5 * max(np.max(np.abs(Zr)), 1)


class TestDistributedWelch:
    @pytest.mark.parametrize("n,W,O,sc", [
        (4288, 256, 192, "density"),
        (4160, 128, 64, "spectrum"),
        (4288, 256, 192, "spectrum"),
    ])
    def test_matches_facade(self, world, n, W, O, sc):
        from webgpufft_tpu import fft as wfft
        x = np.random.default_rng(0).standard_normal((2, n)).astype(np.float32)
        kw = {"fs": 100.0, "nperseg": W, "noverlap": O, "scaling": sc}
        Pd, _ = both_build(world, "build_distributed_welch", [n, "MESH", "sp"], kw,
                           SP8, [x], attrs=())
        fr, Pr = wfft.welch(x, fs=100.0, nperseg=W, noverlap=O, scaling=sc)
        Pr = np.asarray(Pr)
        assert Pd.shape == Pr.shape
        assert np.max(np.abs(Pd - Pr)) / np.max(Pr) < 1e-5

    def test_validation(self, world):
        raises(world, "ValueError", "frame count", "build", "build_distributed_welch",
               [4544, "MESH", "sp"], {"nperseg": 128, "noverlap": 64}, SP8,
               call=False)
        raises(world, "ValueError", "shorter", "build", "build_distributed_welch",
               [100, "MESH", "sp"], {"nperseg": 256}, SP8, call=False)


class TestDistributedCsd:
    def test_matches_facade(self, world):
        from webgpufft_tpu import fft as wfft
        from webgpufft_tpu.fftapi import ascomplex
        rng = np.random.default_rng(0)
        n = 4288
        x = rng.standard_normal((2, n)).astype(np.float32)
        y = rng.standard_normal((2, n)).astype(np.float32)
        kw = {"fs": 100.0, "nperseg": 256, "noverlap": 192}
        Pd, _ = both_build(world, "build_distributed_csd", [n, "MESH", "sp"], kw,
                           SP8, [x, y], attrs=())
        _, Pr = wfft.csd(x, y, **kw)
        Pr = ascomplex(np.asarray(Pr))
        assert np.max(np.abs(unil(Pd) - Pr)) / np.max(np.abs(Pr)) < 1e-5

    def test_self_csd_is_welch(self, world):
        n = 4288
        x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        kw = {"nperseg": 256, "noverlap": 192}
        Pc, _ = both_build(world, "build_distributed_csd", [n, "MESH", "sp"], kw,
                           SP8, [x, x], attrs=(), jit=False)
        Pw, _ = both_build(world, "build_distributed_welch", [n, "MESH", "sp"], kw,
                           SP8, [x], attrs=(), jit=False)
        assert np.max(np.abs(Pc[..., 0] - Pw)) / np.max(Pw) < 1e-5
        assert np.max(np.abs(Pc[..., 1])) / np.max(Pw) < 1e-5


class TestDistributedSpectralDpSp:
    def test_stft_welch_on_dp_sp(self, world):
        from webgpufft_tpu import fft as wfft
        rng = np.random.default_rng(2)
        n = 4032
        x = rng.standard_normal((4, n)).astype(np.float32)
        kw = {"nperseg": 256, "noverlap": 192, "batch_axis_name": "dp"}
        Zd, _ = both_build(world, "build_distributed_stft", [n, "MESH", "sp"], kw,
                           DP2SP4, [x], attrs=())
        _, _, Zr = wfft.stft(x, nperseg=256, noverlap=192)
        Zr = np.asarray(Zr)
        assert np.max(np.abs(Zd - Zr)) / np.max(np.abs(Zr)) < 1e-5
        nw = 4288
        xw = rng.standard_normal((4, nw)).astype(np.float32)
        Pd, _ = both_build(world, "build_distributed_welch", [nw, "MESH", "sp"], kw,
                           DP2SP4, [xw], attrs=())
        _, Pr = wfft.welch(xw, nperseg=256, noverlap=192)
        Pr = np.asarray(Pr)
        assert np.max(np.abs(Pd - Pr)) / np.max(Pr) < 1e-5


class TestSpectralReviewRegressions:
    def test_istft_infers_nfft_from_bins(self, world):
        n = 4544
        x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
        xr = world.run("call", "torch_world_cases", "stft_istft_infer", x, n)
        assert np.max(np.abs(xr - x)) < 2e-5 * max(np.max(np.abs(x)), 1)

    def test_istft_rejects_bin_mismatch(self, world):
        bad = np.zeros((129, 72, 2), np.float32)
        raises(world, "ValueError", "frequency rows", "build",
               "build_distributed_istft", [4544, "MESH", "sp"],
               {"nperseg": 128, "noverlap": 64, "nfft": 128}, SP8, [bad])

    def test_halo_must_fit_slab(self, world):
        raises(world, "ValueError", "overlap", "build", "build_distributed_stft",
               [448, "MESH", "sp"], {"nperseg": 256, "noverlap": 192}, SP8,
               call=False)
        raises(world, "ValueError", "overlap", "build", "build_distributed_welch",
               [704, "MESH", "sp"], {"nperseg": 256, "noverlap": 192}, SP8,
               call=False)
