"""tests/test_distributed_plans.py case by case through the port's
``create_distributed_plan`` in a gloo world of 8 CPU ranks: each case
builds both packages' distributed plans from one options dict, runs them
on the same seeded numpy input, and holds the port's route (mode, axis
kinds, reasons) and output to the JAX package's, and to the test's own
reference at its tolerance.  The JAX cases that read the compiled HLO read
the port's collective calls instead.  Also the distributed cases of
test_autodiff.py, test_fuzz.py and test_measure.py."""

import numpy as np
import pytest

from torch_dist_support import both_build, both_plan, cx, il, jax_plan, unil
from torch_port_support import assert_close, assert_close_c
from torch_world import raises, world_fixture
from webgpufft_tpu.utils import mathref as R

world = world_fixture(8)

SP8 = {"sp": 8}
DP2SP4 = {"dp": 2, "sp": 4}
PENCIL = {"sp0": 2, "sp1": 4}
PENCIL_DP = {"dp": 2, "sp0": 2, "sp1": 2}
PAIR = ("sp0", "sp1")


def c2c(shape, batch, **kw):
    return {"type": "c2c", "shape": list(shape), "batch": batch, **kw}


def test_c2c_1d_seq(world, rng):
    n, batch = 1024, 2
    z = cx(rng, batch, n)
    r, _, jp = both_plan(world, c2c([n], batch, direction="forward",
                                    normalize="unitary"), SP8, None, "sp", [il(z)])
    assert r["route"]["mode"] == "distributed-sp"
    assert any(x.startswith("digit-split:") for x in r["route"]["reasons"])
    ref = R.fft_nd(z, [n], "forward") / np.sqrt(n)
    assert_close_c(unil(r["out"]), ref, label="dseq c2c")


def test_c2c_1d_seq_inverse_roundtrip(world, rng):
    n, batch = 512, 4
    z = cx(rng, batch, n)
    r, _, _ = both_plan(world, c2c([n], batch), DP2SP4, "dp", "sp", [il(z)],
                        chain=c2c([n], batch, direction="inverse",
                                  normalize="backward"))
    assert_close_c(unil(r["out"]), z, label="dseq roundtrip")


def test_c2c_nd_seq(world, rng):
    shape, batch = [64, 24], 2
    z = cx(rng, batch, *shape)
    r, _, _ = both_plan(world, c2c(shape, batch, normalize="unitary"), SP8,
                        None, "sp", [il(z)])
    ref = R.fft_nd(z, shape, "forward") / np.sqrt(np.prod(shape))
    assert_close_c(unil(r["out"]), ref, label="dseq nd")


def test_r2c_c2r_seq_roundtrip(world, rng):
    n, batch = 2048, 2
    x = rng.standard_normal((batch, n))
    r2c = {"type": "r2c", "shape": [n], "batch": batch}
    c2r = {"type": "c2r", "shape": [n], "batch": batch, "direction": "inverse",
           "normalize": "backward"}
    r, _, _ = both_plan(world, r2c, SP8, None, "sp", [x.astype(np.float32)])
    assert_close_c(unil(r["out"]), np.fft.rfft(x, axis=-1), label="dseq r2c")
    r2, _, _ = both_plan(world, r2c, SP8, None, "sp", [x.astype(np.float32)],
                         chain=c2r)
    assert_close(r2["out"], x, label="dseq c2r roundtrip")


def fftconv(shape, batch, **fc):
    return {"type": "fftconv", "shape": list(shape), "batch": batch,
            "fftConv": fc}


def test_fftconv_seq(world, rng):
    n, batch = 256, 4
    z, k = cx(rng, batch, n), cx(rng, n)
    r, _, _ = both_plan(world, fftconv([n], batch), DP2SP4, "dp", "sp", [il(z)],
                        il(k))
    ref = R.fftconv(z, k, [n], batch=batch, boundary="circular")
    assert_close_c(unil(r["out"]).reshape(batch, n), ref, label="dseq fftconv")


def test_fftconv_nd_seq_correlation(world, rng):
    shape, batch = [64, 6], 2
    z, k = cx(rng, batch, *shape), cx(rng, *shape)
    r, _, _ = both_plan(world, fftconv(shape, batch, mode="correlation"), SP8,
                        None, "sp", [il(z)], il(k))
    ref = R.fftconv(z, k, shape, batch=batch, boundary="circular",
                    mode="correlation")
    assert_close_c(unil(r["out"]).reshape(batch, *shape), ref, label="ndcorr")


@pytest.mark.parametrize("n,kc", [(100, 1), (101, 2), (13, 1)])
def test_fftconv_seq_circular_unsplittable(world, rng, n, kc):
    batch = 4
    z, ks = cx(rng, batch, n), cx(rng, kc, n)
    kin = il(ks) if kc > 1 else il(ks[0])
    r, _, _ = both_plan(world, fftconv([n], batch, mode="correlation",
                                       kernelCount=kc),
                        DP2SP4, "dp", "sp", [il(z)], kin, tol=5e-5)
    y = r["out"] if kc > 1 else r["out"][None]
    for i in range(kc):
        ref = R.fftconv(z, ks[i], [n], batch=batch, boundary="circular",
                        mode="correlation")
        assert_close_c(unil(y[i]), ref, 5e-5, label=f"padded conv n={n} #{i}")


def test_fftconv_nd_seq_circular_unsplittable_axis0(world, rng):
    shape, batch = [15, 6], 2
    z, k = cx(rng, batch, *shape), cx(rng, *shape)
    r, _, _ = both_plan(world, fftconv(shape, batch), SP8, None, "sp", [il(z)],
                        il(k), tol=5e-5)
    assert any(x.startswith("fftconv-padded-circular:") for x in r["route"]["reasons"])
    ref = R.fftconv(z, k, shape, batch=batch, boundary="circular")
    assert_close_c(unil(r["out"]).reshape(batch, *shape), ref, 5e-5, label="bs ndconv")


def test_fftconv_nd_seq_circular_unsplittable_dp_multikernel(world, rng):
    shape, batch, kc = [15, 4], 4, 2
    z, ks = cx(rng, batch, *shape), cx(rng, kc, *shape)
    r, _, _ = both_plan(world, fftconv(shape, batch, mode="correlation",
                                       kernelCount=kc),
                        DP2SP4, "dp", "sp", [il(z)], il(ks), tol=5e-5)
    for i in range(kc):
        ref = R.fftconv(z, ks[i], shape, batch=batch, boundary="circular",
                        mode="correlation")
        assert_close_c(unil(r["out"][i]).reshape(batch, *shape), ref, 5e-5,
                       label=f"padded nd dp kc #{i}")


@pytest.mark.parametrize("boundary", ["linear-full", "linear-same", "linear-valid"])
def test_fftconv_seq_linear_1d(world, rng, boundary):
    n, kn, batch = 100, 17, 4
    z, k = cx(rng, batch, n), cx(rng, kn)
    r, _, _ = both_plan(world, fftconv([n], batch, boundary=boundary,
                                       kernelShape=[kn]),
                        DP2SP4, "dp", "sp", [il(z)], il(k))
    ref = R.fftconv(z, k, [n], batch=batch, boundary=boundary, kernel_shape=[kn])
    assert r["out"].shape == (batch, ref.shape[1], 2)
    assert_close_c(unil(r["out"]), ref, label=f"dseq lin {boundary}")


def test_fftconv_seq_linear_nd_correlation(world, rng):
    shape, kshape, batch = [30, 10], [5, 3], 2
    z, k = cx(rng, batch, *shape), cx(rng, *kshape)
    r, _, _ = both_plan(world, fftconv(shape, batch, boundary="linear-same",
                                       kernelShape=kshape, mode="correlation"),
                        SP8, None, "sp", [il(z)], il(k))
    ref = R.fftconv(z, k, shape, batch=batch, boundary="linear-same",
                    kernel_shape=kshape, mode="correlation")
    assert_close_c(unil(r["out"]).reshape(ref.shape), ref, label="lin ndcorr")


@pytest.mark.parametrize("boundary", ["circular", "linear-full", "linear-same",
                                      "linear-valid"])
def test_fftconv_seq_halo_route(world, rng, boundary):
    n, k, batch = 1024, 17, 4
    z, kk = cx(rng, batch, n), cx(rng, k)
    r, _, _ = both_plan(world, fftconv([n], batch, boundary=boundary,
                                       kernelShape=[k]),
                        DP2SP4, "dp", "sp", [il(z)], il(kk))
    assert any(x.startswith("fftconv-halo") for x in r["route"]["reasons"])
    ref = R.fftconv(z, kk, [n], batch=batch, boundary=boundary, kernel_shape=[k])
    assert_close_c(unil(r["out"]), ref, label=f"halo {boundary}")


@pytest.mark.parametrize("boundary", ["circular", "linear-full", "linear-same",
                                      "linear-valid"])
def test_fftconv_seq_halo_nd(world, rng, boundary):
    shape, kshape, batch = (200, 8, 6), (9, 3, 2), 4
    z, kk = cx(rng, batch, *shape), cx(rng, *kshape)
    r, _, _ = both_plan(world, fftconv(shape, batch, boundary=boundary,
                                       kernelShape=list(kshape)),
                        DP2SP4, "dp", "sp", [il(z)], il(kk))
    assert any(x.startswith("fftconv-halo") for x in r["route"]["reasons"])
    ref = R.fftconv(z, kk, list(shape), batch=batch, boundary=boundary,
                    kernel_shape=list(kshape))
    assert_close_c(unil(r["out"]).reshape(ref.shape), ref, label=f"nd-halo {boundary}")


def test_fftconv_seq_halo_ineligible_falls_back(world, rng):
    n = 256
    r, _, _ = both_plan(world, fftconv([n], 2, boundary="linear-full",
                                       kernelShape=[n // 2]),
                        SP8, None, "sp", call=False)
    assert not any(x.startswith("fftconv-halo") for x in r["route"]["reasons"])
    z, kk = cx(rng, 2, n), cx(rng, 9)
    r, _, _ = both_plan(world, fftconv([n], 2, boundary="linear-same",
                                       kernelShape=[9], mode="correlation"),
                        SP8, None, "sp", [il(z)], il(kk))
    assert not any(x.startswith("fftconv-halo") for x in r["route"]["reasons"])
    ref = R.fftconv(z, kk, [n], batch=2, boundary="linear-same", kernel_shape=[9],
                    mode="correlation")
    assert_close(r["out"][..., 0], ref.real, label="spectrum corr fallback")


def test_fftconv_seq_multi_kernel(world, rng):
    n, batch, kcount = 128, 4, 3
    z, ks = cx(rng, batch, n), cx(rng, kcount, n)
    r, _, _ = both_plan(world, fftconv([n], batch, kernelCount=kcount), DP2SP4,
                        "dp", "sp", [il(z)], il(ks))
    assert r["out"].shape == (kcount, batch, n, 2)
    for k in range(kcount):
        ref = R.fftconv(z, ks[k], [n], batch=batch, boundary="circular")
        assert_close_c(unil(r["out"][k]), ref, label=f"dseq mk{k}")
    raises(world, "PlanError", "kernelCount", "plan",
           fftconv([n], batch, kernelCount=kcount), DP2SP4, "dp", "sp", [il(z)],
           il(ks)[0])


def test_fftconv_seq_multi_kernel_linear_batch_major(world, rng):
    shape, kshape, batch, kcount = [32, 8], [5, 3], 2, 2
    z, ks = cx(rng, batch, *shape), cx(rng, kcount, *kshape)
    r, _, _ = both_plan(world, fftconv(shape, batch, boundary="linear-full",
                                       kernelShape=kshape, kernelCount=kcount,
                                       outputLayout="batch-major"),
                        SP8, None, "sp", [il(z)], il(ks))
    out_shape = tuple(shape[d] + kshape[d] - 1 for d in range(2))
    assert r["out"].shape == (batch, kcount, *out_shape, 2)
    for k in range(kcount):
        ref = R.fftconv(z, ks[k], shape, batch=batch, boundary="linear-full",
                        kernel_shape=kshape)
        assert_close_c(unil(r["out"][:, k]), ref, label=f"dseq mklin{k}")


def test_c2c_seq_bluestein_prime(world, rng):
    n, batch = 101, 4
    z = cx(rng, batch, n)
    r, _, _ = both_plan(world, c2c([n], batch, normalize="none"), DP2SP4, "dp",
                        "sp", [il(z)])
    assert_close_c(unil(r["out"]), R.fft_nd(z, [n], "forward"), label="bluestein")


def test_c2c_seq_bluestein_inverse_roundtrip(world, rng):
    n, batch = 225, 2
    z = cx(rng, batch, n)
    r, _, _ = both_plan(world, c2c([n], batch), SP8, None, "sp", [il(z)],
                        chain=c2c([n], batch, direction="inverse",
                                  normalize="backward"))
    assert_close_c(unil(r["out"]), z, label="blu roundtrip")


def test_r2c_c2r_seq_odd_n(world, rng):
    n, batch = 225, 2
    x = rng.standard_normal((batch, n))
    r, _, _ = both_plan(world, {"type": "r2c", "shape": [n], "batch": batch},
                        SP8, None, "sp", [x.astype(np.float32)])
    assert r["out"].shape == (batch, n // 2 + 1, 2)
    assert_close_c(unil(r["out"]), np.fft.rfft(x, axis=-1), label="r2c odd")
    r2, _, _ = both_plan(world, {"type": "r2c", "shape": [n], "batch": batch},
                         SP8, None, "sp", [x.astype(np.float32)],
                         chain={"type": "c2r", "shape": [n], "batch": batch,
                                "direction": "inverse", "normalize": "backward"})
    assert_close(r2["out"], x, label="c2r odd roundtrip")


def trig(kind, shape, batch, **kw):
    return {"type": kind, "shape": list(shape), "batch": batch, **kw}


def test_trig_seq_bluestein_length(world, rng):
    n, batch = 1000, 4
    x = rng.standard_normal((batch, n))
    r, _, _ = both_plan(world, trig("dct2", [n], batch, normalize="unitary"),
                        DP2SP4, "dp", "sp", [x.astype(np.float32)])
    assert_close(r["out"], R.dct_nd(x, [n], "dct2", "forward", "unitary"),
                 label="dct2 bluestein")


@pytest.mark.parametrize("kind", ["dct1", "dct2", "dct3", "dct4",
                                  "dst1", "dst2", "dst3", "dst4"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_trig_seq(world, rng, kind, direction):
    n, batch = 256, 4
    x = rng.standard_normal((batch, n))
    r, _, _ = both_plan(world, trig(kind, [n], batch, direction=direction,
                                    normalize="unitary"),
                        DP2SP4, "dp", "sp", [x.astype(np.float32)])
    assert_close(r["out"], R.dct_nd(x, [n], kind, direction, "unitary"),
                 label=f"dseq {kind} {direction}")


def test_trig_seq_roundtrip(world, rng):
    n, batch = 512, 2
    x = rng.standard_normal((batch, n))
    r, _, _ = both_plan(world, trig("dct2", [n], batch, normalize="none"), SP8,
                        None, "sp", [x.astype(np.float32)],
                        chain=trig("dct2", [n], batch, direction="inverse",
                                   normalize="backward"))
    assert_close(r["out"] * 2.0, x, label="dseq dct2 roundtrip to x")


@pytest.mark.parametrize("kind", ["dct1", "dst1", "dct4", "dst4"])
def test_trig14_seq_nd_matches_single_chip(world, rng, kind):
    n, m, batch = 128, 16, 2
    x = rng.standard_normal((batch, n, m)).astype(np.float32)
    r, _, _ = both_plan(world, trig(kind, [n, m], batch, normalize="unitary"),
                        SP8, None, "sp", [x])
    assert_close(r["out"], R.dct_nd(x, [n, m], kind, "forward", "unitary"),
                 label=f"dseq {kind} rank2")


def test_trig14_seq_self_inverse_roundtrip(world, rng):
    n, batch = 256, 2
    x = rng.standard_normal((batch, n)).astype(np.float32)
    r, _, _ = both_plan(world, trig("dct4", [n], batch, normalize="none"), SP8,
                        None, "sp", [x],
                        chain=trig("dct4", [n], batch, direction="inverse",
                                   normalize="backward"))
    assert_close(r["out"] * 2.0, x, label="dseq dct4 roundtrip")


def test_fftconv_seq_linear_valid_too_big_kernel(world):
    raises(world, "PlanError", "valid", "plan",
           fftconv([16], 1, boundary="linear-valid", kernelShape=[20]),
           SP8, None, "sp", call=False)


def test_dp_only_wraps_local_plan(world, rng):
    n, batch = 64, 8
    x = rng.standard_normal((batch, n, n))
    r, _, _ = both_plan(world, trig("dct2", [n, n], batch, normalize="unitary"),
                        DP2SP4, "dp", None, [x.astype(np.float32)])
    assert r["route"]["mode"] == "distributed-dp"
    assert_close(r["out"], R.dct_nd(x, [n, n], "dct2", "forward", "unitary"),
                 label="dp dct2")


def test_dp_only_fftconv_kernel(world, rng):
    n, batch = 32, 4
    z, k = cx(rng, batch, n), cx(rng, 5)
    r, _, _ = both_plan(world, fftconv([n], batch, boundary="linear-same",
                                       kernelShape=[5]),
                        DP2SP4, "dp", None, [il(z)], il(k))
    ref = R.fftconv(z, k, [n], batch=batch, boundary="linear-same", kernel_shape=[5])
    assert_close(unil(r["out"]).real, ref.real, label="dp fftconv.re")


def test_validation_errors(world):
    def err(match, opts, axes, b=None, s=None):
        raises(world, "PlanError", match, "plan", opts, axes, b, s, call=False)
    err("batch_axis and/or seq_axis", c2c([64], 1), DP2SP4)
    err("not a mesh axis", c2c([64], 1), DP2SP4, None, "tp")
    err("distinct", c2c([64], 1), DP2SP4, "sp", "sp")
    err("divide evenly", c2c([64], 3), DP2SP4, "dp")
    err("not supported for type", {"type": "conv2d", "shape": [8, 8],
                                    "conv": {"kernelSize": 3}}, DP2SP4, None, "sp")
    r, _, _ = both_plan(world, c2c([64], 1, ioView={"input": {"shape": [32]}}),
                        DP2SP4, None, "sp", call=False)
    assert "distributed-staging" in r["route"]["reasons"]
    rng12 = np.random.default_rng(0)
    z12, k12 = cx(rng12, 1, 12), cx(rng12, 12)
    r, _, _ = both_plan(world, fftconv([12], 1, boundary="circular"), SP8, None,
                        "sp", [il(z12)], il(k12), tol=5e-5)
    ref12 = R.fftconv(z12, k12, [12], batch=1, boundary="circular")
    got12 = unil(r["out"]).reshape(1, 12)
    assert np.max(np.abs(got12 - ref12)) / np.max(np.abs(ref12)) < 5e-5
    err("kernelShape == shape", fftconv([64], 1, boundary="circular",
                                        kernelShape=[32]), DP2SP4, None, "sp")
    raises(world, "PlanError", "requires kernel=", "plan", fftconv([64], 1), SP8,
           None, "sp", [np.zeros((1, 64, 2), np.float32)])


def test_nd_seq_flat_input_with_batch_axis(world, rng):
    shape, batch = [64, 24], 4
    z = cx(rng, batch, *shape)
    flat = il(z).reshape(batch, int(np.prod(shape)), 2)
    r, _, _ = both_plan(world, c2c(shape, batch, normalize="unitary"), DP2SP4,
                        "dp", "sp", [flat])
    ref = R.fft_nd(z, shape, "forward") / np.sqrt(np.prod(shape))
    assert_close_c(unil(r["out"].reshape(batch, *shape, 2)), ref, label="nd flat")


def test_dp_only_strided_flat_buffer(world, rng):
    n, batch, stride = 32, 4, 3
    span = 1 + (n - 1) * stride
    z = cx(rng, batch * span)
    # a flat buffer runs whole on every rank (JAX plans.py:88-100)
    r, _, _ = both_plan(world, c2c([n], batch, layout={"strides": [stride]}),
                        DP2SP4, "dp", None, [il(z)], flat_out=True)
    y = unil(r["out"])
    gathered = np.stack([z[b * span: b * span + n * stride: stride]
                         for b in range(batch)])
    got = np.stack([y[b * span: b * span + n * stride: stride] for b in range(batch)])
    assert_close_c(got, R.fft_nd(gathered, [n], "forward"), label="dp strided")


def test_workspace_and_destroy(world):
    r = world.run("call", "torch_world_cases", "workspace_and_destroy")
    assert r == (2 * 8 * 512 * 8 // 8, True)


def test_fftconv_seq_halo_packed_kernel(world, rng):
    shape, kshape = (96, 5), (4, 2)
    z, kk = cx(rng, 2, *shape), cx(rng, *kshape)
    r, _, _ = both_plan(world, fftconv(shape, 2, boundary="linear-full",
                                       kernelShape=list(kshape)),
                        SP8, None, "sp", [il(z)], il(kk.reshape(-1)))
    assert any(x.startswith("fftconv-halo") for x in r["route"]["reasons"])
    ref = R.fftconv(z, kk, list(shape), batch=2, boundary="linear-full",
                    kernel_shape=list(kshape))
    assert_close(unil(r["out"]).reshape(ref.shape).real, ref.real,
                 label="halo packed kernel")


def test_halo_route_hlo_has_no_all_to_all(world):
    """The halo route exchanges its (k-1)-slab by ppermute and calls no
    all_to_all; the spectrum route's digit exchange is an all_to_all."""
    halo = world.run("call", "torch_world_cases", "plan_collectives",
                     fftconv([1024], 2, boundary="linear-same", kernelShape=[17]),
                     SP8, None, "sp")
    assert halo["all_to_all"] == 0 and halo["p2p"] >= 1
    assert halo["all_gather"] == 0
    spec = world.run("call", "torch_world_cases", "plan_collectives",
                     c2c([1024], 2), SP8, None, "sp")
    assert spec["all_to_all"] >= 1


@pytest.mark.parametrize("shape", [[128, 12], [30, 10], [13, 6], [24, 8, 6],
                                   [64, 4, 6]])
def test_r2c_c2r_nd_seq(world, rng, shape):
    batch = 2
    x = rng.standard_normal((batch, *shape))
    axes = tuple(range(1, len(shape) + 1))
    ref = np.fft.fftn(x, axes=axes)[:, : shape[0] // 2 + 1]
    r, _, _ = both_plan(world, {"type": "r2c", "shape": shape, "batch": batch},
                        SP8, None, "sp", [x.astype(np.float32)])
    assert_close_c(unil(r["out"]), ref, label=f"nd r2c {shape}")
    r2, _, _ = both_plan(world, {"type": "c2r", "shape": shape, "batch": batch,
                                 "direction": "inverse", "normalize": "backward"},
                         SP8, None, "sp", [il(ref)])
    assert_close(r2["out"], x, label=f"nd c2r {shape} roundtrip")


def test_r2c_nd_seq_dp_sp(world, rng):
    shape, batch = [32, 6, 4], 4
    x = rng.standard_normal((batch, *shape))
    r, _, _ = both_plan(world, {"type": "r2c", "shape": shape, "batch": batch,
                                "normalize": "unitary"},
                        DP2SP4, "dp", "sp", [x.astype(np.float32)])
    ref = np.fft.fftn(x, axes=(1, 2, 3))[:, :17] / np.sqrt(np.prod(shape))
    assert_close_c(unil(r["out"]), ref, label="nd r2c dpsp")


@pytest.mark.parametrize("kind", ["dct2", "dct3", "dst2", "dst3"])
def test_trig_nd_seq(world, rng, kind):
    shape, batch = [16, 12], 4
    x = rng.standard_normal((batch, *shape))
    for direction, normalize in (("forward", "none"), ("inverse", "backward")):
        r, _, _ = both_plan(world, trig(kind, shape, batch, direction=direction,
                                        normalize=normalize),
                            DP2SP4, "dp", "sp", [x.astype(np.float32)])
        assert_close(r["out"], R.dct_nd(x, shape, kind, direction, normalize),
                     label=f"nd {kind} {direction}")


def test_trig_nd_seq_odd_axis0_and_fft_rest(world, rng):
    x = rng.standard_normal((2, 15, 8))
    r, _, _ = both_plan(world, trig("dct2", [15, 8], 2), DP2SP4, "dp", "sp",
                        [x.astype(np.float32)])
    assert_close(r["out"], R.dct_nd(x, [15, 8], "dct2", "forward", "none"),
                 label="nd dct2 odd axis0")
    x2 = rng.standard_normal((2, 16, 16))
    r, _, _ = both_plan(world, trig("dct3", [16, 16], 2,
                                    tuning={"dctFftMinN": 16}),
                        DP2SP4, "dp", "sp", [x2.astype(np.float32)])
    assert_close(r["out"], R.dct_nd(x2, [16, 16], "dct3", "forward", "none"),
                 label="nd dct3 fft-routed rest axis")


def test_c2c_nd_seq_bluestein_axis0(world, rng):
    shape, batch = [13, 8], 2
    z = cx(rng, batch, *shape)
    r, _, _ = both_plan(world, c2c(shape, batch), SP8, None, "sp", [il(z)])
    assert_close_c(unil(r["out"]), R.fft_nd(z, shape, "forward"),
                   label="nd bluestein axis0")


def _preset_kernel_major():
    import webgpufft_tpu as W
    return W.create_fftconv_kernel_major_channel_lane_preset({
        "shape": [64], "batch": 4, "kernelCount": 2,
        "input": {"channels": 2, "channelIndex": 1},
        "output": {"channels": 4, "channelIndex": 0, "kernelStepChannels": 2}})


def test_fftconv_seq_channel_lanes(world, rng):
    import webgpufft_tpu as W
    preset = _preset_kernel_major()
    b, cin, cout, n, kc = 4, 2, 4, 64, 2
    lanes = cx(rng, b, cin, n)
    flat_in = il(lanes.reshape(-1))
    k = cx(rng, kc, n)
    # the lane frames are a flat output buffer
    r, _, _ = both_plan(world, {"type": "fftconv", **preset}, DP2SP4, "dp", "sp",
                        [flat_in], il(k), flat_out=True)
    ref_flat = np.asarray(W.create_plan({"type": "fftconv", **preset})
                          .exec(flat_in, kernel=il(k)))
    assert r["out"].shape == ref_flat.shape
    assert_close(r["out"], ref_flat, label="channel lanes vs local")
    out = unil(r["out"]).reshape(b, cout, n)
    for kk in range(kc):
        ref = R.fftconv(lanes[:, 1, :], k[kk], [64], batch=b)
        assert_close_c(out[:, kk * 2, :], ref, label=f"lane{kk * 2}")
    assert np.all(out[:, 1, :] == 0) and np.all(out[:, 3, :] == 0)


def test_fftconv_seq_channel_lanes_halo_linear(world, rng):
    n, kn, b, cin = 128, 5, 2, 3
    lanes, kern = cx(rng, b, cin, n), cx(rng, kn)
    r, _, _ = both_plan(world, fftconv([n], b, boundary="linear-same",
                                       kernelShape=[kn],
                                       channelPolicy={"input": {"channels": cin,
                                                                "channelIndex": 2}}),
                        SP8, None, "sp", [il(lanes.reshape(-1))], il(kern))
    assert any("fftconv-halo" in x for x in r["route"]["reasons"])
    ref = R.fftconv(lanes[:, 2, :], kern, [n], batch=b, boundary="linear-same",
                    kernel_shape=[kn])
    assert_close_c(unil(r["out"]).reshape(b, n), ref, label="halo lane")


@pytest.mark.parametrize("shape,direction,norm", [
    ([8, 16], "forward", "none"),
    ([12, 32], "inverse", "backward"),
    ([8, 16, 6], "forward", "unitary"),
    ([16, 16, 3, 5], "forward", "none"),
])
def test_c2c_pencil(world, rng, shape, direction, norm):
    b = 3
    z = cx(rng, b, *shape)
    r, _, _ = both_plan(world, c2c(shape, b, direction=direction, normalize=norm),
                        PENCIL, None, PAIR, [il(z)])
    assert r["route"]["mode"] == "distributed-pencil"
    assert any(x.startswith("pencil-split:") for x in r["route"]["reasons"])
    ref = R.fft_nd(z, shape, direction)
    if norm == "unitary":
        ref = ref / np.sqrt(np.prod(shape))
    elif norm == "backward" and direction == "inverse":
        ref = ref / np.prod(shape)
    assert_close_c(unil(r["out"]).reshape(b, *shape), ref, label="pencil c2c")


def test_c2c_pencil_dp(world, rng):
    shape, b = [8, 12, 10], 4
    z = cx(rng, b, *shape)
    r, _, _ = both_plan(world, c2c(shape, b), PENCIL_DP, "dp", PAIR, [il(z)])
    assert_close_c(unil(r["out"]).reshape(b, *shape), R.fft_nd(z, shape, "forward"),
                   label="pencil dp")


def test_c2c_pencil_roundtrip(world, rng):
    shape, b = [12, 16, 5], 2
    z = cx(rng, b, *shape)
    r, _, _ = both_plan(world, c2c(shape, b), PENCIL, None, PAIR, [il(z)],
                        chain=c2c(shape, b, direction="inverse",
                                  normalize="backward"))
    assert_close_c(unil(r["out"]).reshape(b, *shape), z, label="pencil rt")


@pytest.mark.parametrize("shape", [[8, 16, 6], [12, 32], [12, 16, 5]])
def test_r2c_c2r_pencil(world, rng, shape):
    b = 2
    x = rng.standard_normal((b, *shape)).astype(np.float32)
    r, _, _ = both_plan(world, {"type": "r2c", "shape": shape, "batch": b},
                        PENCIL, None, PAIR, [x])
    assert r["route"]["mode"] == "distributed-pencil"
    p0 = shape[0] // 2 + 1
    ref = R.fft_nd(x.astype(np.float64), shape, "forward")[:, :p0]
    assert_close_c(unil(r["out"]).reshape(b, p0, *shape[1:]), ref, label="pencil r2c")
    r2, _, _ = both_plan(world, {"type": "r2c", "shape": shape, "batch": b},
                         PENCIL, None, PAIR, [x],
                         chain={"type": "c2r", "shape": shape, "batch": b,
                                "direction": "inverse", "normalize": "backward"})
    assert_close(r2["out"].reshape(b, *shape), x, label="pencil c2r roundtrip")


@pytest.mark.parametrize("shape,boundary,kshape,kcount", [
    ([8, 16], "circular", None, 1),
    ([8, 16, 3], "circular", None, 2),
    ([10, 12], "linear-full", [3, 5], 1),
    ([10, 12], "linear-same", [3, 3], 2),
    ([12, 16], "linear-valid", [5, 3], 1),
])
def test_fftconv_pencil_matches_single_chip(world, rng, shape, boundary, kshape,
                                            kcount):
    import webgpufft_tpu as W
    fc = {"boundary": boundary, "kernelCount": kcount}
    if kshape is not None:
        fc["kernelShape"] = kshape
    opts = {"type": "fftconv", "shape": shape, "batch": 2, "fftConv": fc}
    ks = tuple(kshape) if kshape is not None else tuple(shape)
    x = rng.standard_normal((2, *shape, 2)).astype(np.float32) * 0.1
    kern = rng.standard_normal((kcount, *ks, 2)).astype(np.float32) * 0.1
    r, _, _ = both_plan(world, opts, PENCIL, None, PAIR, [x], kern)
    assert r["route"]["mode"] == "distributed-pencil"
    assert_close(r["out"], np.asarray(W.create_plan(opts).exec(x, kernel=kern)),
                 label=f"pencil fftconv {boundary}")


def test_fftconv_pencil_unsplittable_falls_back_single_axis(world, rng):
    import webgpufft_tpu as W
    opts = fftconv([7, 16], 2, boundary="circular")
    x = rng.standard_normal((2, 7, 16, 2)).astype(np.float32) * 0.1
    kern = rng.standard_normal((7, 16, 2)).astype(np.float32) * 0.1
    r, _, _ = both_plan(world, opts, PENCIL, None, PAIR, [x], kern)
    reasons = r["route"]["reasons"]
    assert any(x_.startswith("pencil-fallback-single-axis(sp0)") for x_ in reasons)
    assert not any(x_.startswith("pencil-split:") for x_ in reasons)
    assert any(x_.startswith("fftconv-padded-circular:") for x_ in reasons)
    assert_close(r["out"], np.asarray(W.create_plan(opts).exec(x, kernel=kern)),
                 label="pencil fftconv fallback")


def test_fftconv_pencil_operand_bound_error_does_not_fall_back(world):
    """The JAX package rejects this shape on its per-device operand bound
    (an XLA-TPU fact); the port has no such bound: the plan builds on the
    pencil route itself, with no fallback."""
    opts = fftconv([512, 512, 256], 1, boundary="circular")
    r = world.run("plan", opts, PENCIL, None, PAIR, call=False)
    assert r["route"]["mode"] == "distributed-pencil"
    assert any(x.startswith("pencil-split:") for x in r["route"]["reasons"])
    assert not any("fallback" in x for x in r["route"]["reasons"])


def test_fftconv_trivial_zeropad_not_tagged_staged(world, rng):
    import webgpufft_tpu as W
    opts = {**fftconv([8, 16], 2, boundary="circular"),
            "zeroPad": {"read": {"start": [0, 0], "end": [8, 16]}}}
    x = rng.standard_normal((2, 8, 16, 2)).astype(np.float32) * 0.1
    kern = rng.standard_normal((8, 16, 2)).astype(np.float32) * 0.1
    r, _, _ = both_plan(world, opts, PENCIL, None, PAIR, [x], kern)
    assert "distributed-staging" not in r["route"]["reasons"]
    assert_close(r["out"], np.asarray(W.create_plan(opts).exec(x, kernel=kern)),
                 label="pencil fftconv trivial zeroPad")


def test_fftconv_pencil_correlation_zeropad_dp(world, rng):
    import webgpufft_tpu as W
    opts = {**fftconv([8, 12], 4, boundary="linear-same", mode="correlation",
                      kernelShape=[3, 3]),
            "zeroPad": {"read": {"start": [1, 0], "end": [9, 13]},
                        "write": {"start": [0, 1], "end": [9, 12]}}}
    x = rng.standard_normal((4, 8, 12, 2)).astype(np.float32)
    kern = rng.standard_normal((3, 3, 2)).astype(np.float32)
    r, _, _ = both_plan(world, opts, PENCIL_DP, "dp", PAIR, [x], kern)
    assert "distributed-staging" in r["route"]["reasons"]
    assert_close(r["out"], np.asarray(W.create_plan(opts).exec(x, kernel=kern)),
                 label="pencil fftconv correlation+zeroPad+dp")


def test_fftconv_pencil_hlo_collectives_ride_own_axis(world):
    """No collective of the pencil fftconv spans all 8 ranks: every
    all_to_all rides one pencil dim's group."""
    r = world.run("call", "torch_world_cases", "plan_collectives",
                  fftconv([8, 16], 2, boundary="circular"), PENCIL, None, PAIR)
    assert r["all_to_all"] >= 2 and r["max_group"] < 8
    assert r["all_gather"] == 0


def test_fftconv_pencil_linear_same_collectives_ride_own_axis(world, rng):
    """The linear pencil fftconv pads to its work shape and crops back on
    the pencil shards: every collective it issues (the digit exchanges, the
    pad and crop exchanges) rides one pencil dim's group, and none gathers;
    its result equals the JAX package's."""
    opts = fftconv([12, 20], 2, boundary="linear-same", kernelShape=[5, 3])
    r = world.run("call", "torch_world_cases", "plan_collectives", opts, PENCIL,
                  None, PAIR)
    assert r["all_to_all"] >= 2 and r["max_group"] < 8
    assert r["all_gather"] == 0
    x = il(cx(rng, 2, 12, 20))
    k = il(cx(rng, 5, 3))
    both_plan(world, opts, PENCIL, None, PAIR, [x], k)


def test_pencil_validation_errors(world):
    def err(match, opts, axes, b=None, s=PAIR):
        raises(world, "PlanError", match, "plan", opts, axes, b, s, call=False)
    err("rank >= 2", c2c([1024], 2), PENCIL)
    err("pencil seq_axis supports", trig("dct2", [8, 16], 2), PENCIL)
    err("distinct", c2c([8, 16], 2), PENCIL, None, ("sp0", "sp0"))
    err("distinct", c2c([8, 8], 2), PENCIL_DP, "sp0")
    err("Bluestein", c2c([10, 16], 2), PENCIL)
    err("pair", c2c([8, 8, 8], 1), PENCIL_DP, None, ("dp", "sp0", "sp1"))
    r, _, _ = both_plan(world, c2c([16, 6], 2), PENCIL, None, ("sp0",), call=False)
    assert r["route"]["mode"] == "distributed-sp"


def test_pencil_hlo_collectives_ride_own_axis(world):
    r = world.run("call", "torch_world_cases", "plan_collectives",
                  c2c([8, 16], 2), PENCIL, None, PAIR)
    assert r["all_to_all"] >= 2 and r["max_group"] < 8
    assert r["all_gather"] == 0


def _vs_local(world, opts, axes, b, s, x, kernel=None, tol=1e-5, flat_out=False):
    import webgpufft_tpu as W
    r, _, _ = both_plan(world, opts, axes, b, s, [x], kernel, tol=tol,
                        flat_out=flat_out)
    kw = {"kernel": kernel} if kernel is not None else {}
    want = np.asarray(W.create_plan(opts).exec(x, **kw), dtype=np.float32)
    assert_close(np.asarray(r["out"], np.float32), want, tol, label=str(opts))
    return r


def test_seq_c2c_ioview_zeropad_matches_single_chip(world, rng):
    opts = c2c([64, 16], 4, direction="forward", normalize="unitary",
               ioView={"input": {"shape": [48, 12], "placement": "center"},
                       "output": {"shape": [32, 8]}},
               zeroPad={"read": {"start": [2, 0], "end": [46, 16]}})
    x = rng.standard_normal((4, 48, 12, 2)).astype(np.float32)
    r = _vs_local(world, opts, DP2SP4, "dp", "sp", x)
    assert "distributed-staging" in r["route"]["reasons"]


def test_seq_r2c_layout_strides_matches_single_chip(world, rng):
    opts = {"type": "r2c", "shape": [64, 16], "batch": 2, "direction": "forward",
            "normalize": "none",
            "layout": {"inputStrides": [16, 1], "inputOffsetElements": 8,
                       "inputBatchStrideElements": 1100}}
    flat = rng.standard_normal((2 * 1100 + 64 * 16,)).astype(np.float32)
    _vs_local(world, opts, DP2SP4, None, "sp", flat)


def test_seq_c2r_output_ioview(world, rng):
    opts = {"type": "c2r", "shape": [32, 8], "batch": 2, "direction": "inverse",
            "normalize": "backward", "ioView": {"output": {"shape": [24, 8]}}}
    z = np.fft.fftn(rng.standard_normal((2, 32, 8)), axes=(1, 2))
    x = np.stack([z.real, z.imag], -1).astype(np.float32)[:, :17]
    r = _vs_local(world, opts, DP2SP4, None, "sp", x)
    assert r["out"].shape == (2, 24, 8)


def test_seq_bf16_storage(world, rng):
    """bf16 storage: both packages round the same bf16 input; the port's
    result is its local plan's exactly."""
    import ml_dtypes
    opts = c2c([256], 4, precision="bf16-storage", normalize="unitary")
    x = rng.standard_normal((4, 256, 2)).astype(ml_dtypes.bfloat16).astype(np.float32)
    r = world.run("call", "torch_world_cases", "bf16_vs_local", opts, DP2SP4, x)
    got, want = r
    assert np.max(np.abs(got - want)) == 0.0
    jp = jax_plan(opts, DP2SP4, None, "sp")
    import jax.numpy as jnp
    jy = np.asarray(jp(jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert_close(got, jy, 1e-2, label="bf16 vs JAX")


def test_pencil_staged_ioview(world, rng):
    opts = c2c([16, 16, 8], 2, normalize="none",
               ioView={"input": {"shape": [12, 16, 8]}})
    x = rng.standard_normal((2, 12, 16, 8, 2)).astype(np.float32)
    _vs_local(world, opts, {"sp0": 2, "sp1": 2, "dp": 2}, "dp", PAIR, x)


def test_seq_trig_staged_zeropad(world, rng):
    opts = trig("dct4", [64], 2, normalize="unitary",
                zeroPad={"read": {"start": [4], "end": [60]}})
    x = rng.standard_normal((2, 64)).astype(np.float32)
    _vs_local(world, opts, DP2SP4, None, "sp", x)


@pytest.mark.parametrize("boundary,kshape,zp", [
    ("circular", None,
     {"read": {"start": [8], "end": [56]}, "write": {"start": [4], "end": [60]}}),
    ("circular", [5], {"read": {"start": [0], "end": [48]}}),
    ("linear-full", [9], {"write": {"start": [6], "end": [70]}}),
    ("linear-same", [7],
     {"read": {"start": [2], "end": [64]}, "write": {"start": [0], "end": [60]}}),
    ("linear-valid", [9], {"read": {"start": [1], "end": [70]}}),
])
def test_seq_fftconv_zeropad_matches_single_chip(world, rng, boundary, kshape, zp):
    fc = {"boundary": boundary}
    if kshape is not None:
        fc["kernelShape"] = kshape
    opts = {"type": "fftconv", "shape": [64], "batch": 4, "fftConv": fc,
            "zeroPad": zp}
    k = kshape[0] if kshape is not None else 64
    x = rng.standard_normal((4, 64, 2)).astype(np.float32)
    kern = rng.standard_normal((k, 2)).astype(np.float32)
    r = _vs_local(world, opts, DP2SP4, "dp", "sp", x, kern)
    assert "distributed-staging" in r["route"]["reasons"]


def test_seq_fftconv_zeropad_nd_multikernel(world, rng):
    for outl in ("kernel-major", "batch-major"):
        opts = {"type": "fftconv", "shape": [16, 12], "batch": 2,
                "fftConv": {"boundary": "linear-same", "mode": "correlation",
                            "kernelShape": [5, 3], "kernelCount": 2,
                            "outputLayout": outl},
                "zeroPad": {"read": {"start": [1, 0], "end": [18, 13]},
                            "write": {"start": [0, 1], "end": [19, 12]}}}
        x = rng.standard_normal((2, 16, 12, 2)).astype(np.float32)
        kern = rng.standard_normal((2, 5, 3, 2)).astype(np.float32)
        _vs_local(world, opts, DP2SP4, "dp", "sp", x, kern)


def test_seq_fftconv_zeropad_channel_lanes(world, rng):
    opts = {"type": "fftconv", "shape": [32], "batch": 2,
            "fftConv": {"boundary": "circular", "kernelShape": [32],
                        "kernelCount": 2,
                        "channelPolicy": {
                            "input": {"channels": 3, "channelIndex": 1},
                            "output": {"channels": 4, "channelIndex": 0,
                                       "kernelStepChannels": 2}}},
            "zeroPad": {"read": {"start": [2], "end": [30]},
                        "write": {"start": [1], "end": [31]}}}
    x = rng.standard_normal((2 * 3 * 32, 2)).astype(np.float32)
    kern = rng.standard_normal((2, 32, 2)).astype(np.float32)
    # the lane frames are a flat output buffer
    _vs_local(world, opts, DP2SP4, "dp", "sp", x, kern, flat_out=True)


def test_seq_inplace_still_rejected(world):
    raises(world, "PlanError", "inPlace", "plan", c2c([64], 1, inPlace=True),
           SP8, None, "sp", call=False)


# ---------------------------------------------------------------- autodiff

def test_grad_through_distributed_plans(world, rng):
    """test_autodiff.py::test_grad_through_distributed_plans: the gradient
    through the distributed r2c plan (and the pencil c2c plan) equals the
    local plan's and the JAX package's."""
    import jax
    import jax.numpy as jnp
    import webgpufft_tpu as W
    n = 32
    opts = {"type": "r2c", "shape": [n, n], "batch": 1, "direction": "forward",
            "normalize": "unitary"}
    x = rng.standard_normal((1, n, n)).astype(np.float32)
    w = rng.standard_normal((1, n // 2 + 1, n, 2)).astype(np.float32)
    gd, gl = world.run("plan_grad", opts, SP8, None, "sp", x, w)
    assert_close(gd, gl, 1e-5, label="distributed grad == local grad")
    jd = jax_plan(opts, SP8, None, "sp")
    with jd.mesh:
        gj = jax.grad(lambda v: jnp.sum(w * jd.exec(v)))(jnp.asarray(x))
    assert_close(gd, np.asarray(gj), 1e-5, label="distributed grad == JAX grad")
    copts = {"type": "c2c", "shape": [n, n], "batch": 1, "direction": "forward",
             "normalize": "unitary"}
    z = rng.standard_normal((1, n, n, 2)).astype(np.float32)
    gp, gc = world.run("plan_grad", copts, {"sp1": 2, "sp2": 4}, None,
                       ("sp1", "sp2"), z, None)
    assert_close(gp, gc, 1e-5, label="pencil grad == local grad")
    lc = W.create_plan(copts)
    gjc = jax.grad(lambda v: jnp.sum(lc.exec(v) ** 2))(jnp.asarray(z))
    assert_close(gp, np.asarray(gjc), 1e-5, label="pencil grad == JAX grad")


# ---------------------------------------------------------------- fuzz lane

FUZZ_MESHES = {"sp8": SP8, "dp2sp4": DP2SP4, "dp4sp2": {"dp": 4, "sp": 2}}


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_distributed_c2c(world, seed):
    """test_fuzz.py::test_fuzz_distributed_c2c: the same seeded draws."""
    rng = np.random.default_rng(5000 + seed)
    key = str(rng.choice(["sp8", "dp2sp4", "dp4sp2"]))
    axes = FUZZ_MESHES[key]
    dp = "dp" if "dp" in axes else None
    n = int(rng.choice([64, 96, 101, 128, 144, 225, 256, 360, 509, 1000]))
    batch = int(rng.choice([2, 4])) * (axes[dp] if dp else 1)
    direction = str(rng.choice(["forward", "inverse"]))
    normalize = str(rng.choice(["none", "backward", "unitary"]))
    z = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    r, _, _ = both_plan(world, c2c([n], batch, direction=direction,
                                   normalize=normalize), axes, dp, "sp", [il(z)])
    assert_close_c(unil(r["out"]), R.fft_nd(z, [n], direction, normalize),
                   label=f"dfuzz seed={seed} n={n} {key}")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_distributed_fftconv(world, seed):
    """test_fuzz.py::test_fuzz_distributed_fftconv: the same seeded draws
    (sp8 or dp2sp4; every boundary and mode; one or two kernels)."""
    rng = np.random.default_rng(6000 + seed)
    key = str(rng.choice(["sp8", "dp2sp4"]))
    axes = FUZZ_MESHES[key]
    dp = "dp" if "dp" in axes else None
    n = int(rng.choice([64, 100, 128, 160]))
    kn = int(rng.integers(1, 33))
    boundary = str(rng.choice(["circular", "linear-full", "linear-same", "linear-valid"]))
    mode = str(rng.choice(["convolution", "correlation"]))
    kcount = int(rng.choice([1, 2]))
    batch = 2 * (axes[dp] if dp else 1)
    if boundary == "circular":
        kn = n
    z = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    ks = rng.standard_normal((kcount, kn)) + 1j * rng.standard_normal((kcount, kn))
    kin = il(ks) if kcount > 1 else il(ks[0])
    r, _, _ = both_plan(world, fftconv([n], batch, boundary=boundary, mode=mode,
                                       kernelShape=[kn], kernelCount=kcount),
                        axes, dp, "sp", [il(z)], kin, tol=5e-5)
    y = r["out"] if kcount > 1 else r["out"][None]
    for k in range(kcount):
        ref = R.fftconv(z, ks[k], [n], batch=batch, mode=mode, boundary=boundary,
                        kernel_shape=[kn])
        assert_close_c(unil(y[k]), ref, 5e-5,
                       label=f"dfuzz conv seed={seed} n={n} k{kn} {key} {boundary}/{mode} #{k}")


def _real_and_trig(world, rng, axes, dp, shape, batch, x, label):
    """The r2c -> c2r or dct/dst draw shared by the 1-D and N-D real lanes."""
    which = str(rng.choice(["r2c", "trig"]))
    if which == "r2c":
        r2c = {"type": "r2c", "shape": list(shape), "batch": batch}
        r, _, _ = both_plan(world, r2c, axes, dp, "sp", [x.astype(np.float32)])
        ref = np.fft.fftn(x, axes=tuple(range(1, len(shape) + 1)))[:, : shape[0] // 2 + 1]
        assert_close_c(unil(r["out"]), ref, label=f"{label} r2c")
        c2r = {"type": "c2r", "shape": list(shape), "batch": batch,
               "direction": "inverse", "normalize": "backward"}
        r2, _, _ = both_plan(world, c2r, axes, dp, "sp", [r["out"]])
        assert_close(r2["out"], x, label=f"{label} c2r")
    else:
        kind = str(rng.choice(["dct2", "dct3", "dst2", "dst3"]))
        direction = str(rng.choice(["forward", "inverse"]))
        opts = {"type": kind, "shape": list(shape), "batch": batch,
                "direction": direction, "normalize": "unitary"}
        r, _, _ = both_plan(world, opts, axes, dp, "sp", [x.astype(np.float32)], tol=5e-5)
        assert_close(r["out"], R.dct_nd(x, list(shape), kind, direction, "unitary"), 5e-5,
                     label=f"{label} {kind} {direction}")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_distributed_real_and_trig(world, seed):
    """test_fuzz.py::test_fuzz_distributed_real_and_trig: 1-D r2c -> c2r or
    dct/dst on dp 2 x sp 4, lengths that split and that do not."""
    rng = np.random.default_rng(7000 + seed)
    n = int(rng.choice([64, 128, 225, 256, 360, 1000]))
    x = rng.standard_normal((4, n))
    _real_and_trig(world, rng, DP2SP4, "dp", [n], 4, x,
                   f"dfuzz seed={seed} n={n}")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_distributed_real_and_trig_nd(world, seed):
    """test_fuzz.py::test_fuzz_distributed_real_and_trig_nd: rank-2/3 shapes
    whose axis 0 is splittable, even and unsplittable, or odd (13, 15: uneven
    over 8 and 4 ranks), on sp8 or dp2sp4."""
    rng = np.random.default_rng(7500 + seed)
    key = str(rng.choice(["sp8", "dp2sp4"]))
    axes = FUZZ_MESHES[key]
    dp = "dp" if "dp" in axes else None
    n0 = int(rng.choice([13, 15, 24, 30, 32, 64, 128]))
    rest = [int(v) for v in rng.choice([4, 5, 6, 8, 12], size=int(rng.choice([1, 2])))]
    shape = [n0] + rest
    batch = 2 * (axes[dp] if dp else 1)
    x = rng.standard_normal((batch, *shape))
    _real_and_trig(world, rng, axes, dp, shape, batch, x,
                   f"dfuzz nd seed={seed} {shape} {key}")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_distributed_fftconv_nd(world, seed):
    """test_fuzz.py::test_fuzz_distributed_fftconv_nd: N-D convolutions on
    dp 2 x sp 4 across the halo and spectrum routes (the kernel's size
    decides), every boundary."""
    rng = np.random.default_rng(8000 + seed)
    shape = [int(rng.choice([96, 128, 200])), int(rng.choice([6, 8, 12]))]
    kshape = [int(rng.integers(2, 12)), int(rng.integers(1, 4))]
    boundary = str(rng.choice(["linear-full", "linear-same", "circular"]))
    if boundary == "circular" and shape[0] % 4:
        boundary = "linear-full"
    batch = 4
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    kk = rng.standard_normal(kshape) + 1j * rng.standard_normal(kshape)
    r, _, _ = both_plan(world, fftconv(shape, batch, boundary=boundary, kernelShape=kshape),
                        DP2SP4, "dp", "sp", [il(z)], il(kk), tol=5e-5)
    ref = R.fftconv(z, kk, shape, batch=batch, boundary=boundary, kernel_shape=kshape)
    assert_close_c(unil(r["out"]).reshape(ref.shape), ref, 5e-5,
                   label=f"dfuzz ndconv seed={seed} {shape}*{kshape} {boundary} "
                   f"route={r['route']['reasons'][-1]}")


PENCIL_MESHES = {"2x4": PENCIL, "4x2": {"sp0": 4, "sp1": 2}, "dp2x2x2": PENCIL_DP}


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_distributed_pencil(world, seed):
    """test_fuzz.py::test_fuzz_distributed_pencil: pencil (2-D mesh) c2c or
    r2c -> c2r with random splittable axes, a riding axis of any length
    (3, 5, 6, 7), every direction and norm, with and without dp."""
    rng = np.random.default_rng(7000 + seed)
    key = str(rng.choice(list(PENCIL_MESHES)))
    axes = PENCIL_MESHES[key]
    dp = "dp" if "dp" in axes else None
    p0, p1 = axes["sp0"], axes["sp1"]

    def pick_len(p):
        return int(rng.choice([p * p, 4 * p * p, 3 * p * p, 6 * p * p, 2 * p * p]))

    n0, n1 = pick_len(p0), pick_len(p1)
    rank = int(rng.choice([2, 3]))
    rest = [int(rng.choice([3, 5, 6, 7]))] if rank == 3 else []
    shape = [n0, n1, *rest]
    batch = (axes[dp] if dp else 1) * int(rng.choice([1, 2]))
    kind = str(rng.choice(["c2c", "r2c_c2r"]))
    label = f"pfuzz seed={seed} {shape} {key}"
    if kind == "c2c":
        direction = str(rng.choice(["forward", "inverse"]))
        normalize = str(rng.choice(["none", "backward", "unitary"]))
        z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
        r, _, _ = both_plan(world, c2c(shape, batch, direction=direction, normalize=normalize),
                            axes, dp, PAIR, [il(z)])
        assert_close_c(unil(r["out"]).reshape(batch, *shape),
                       R.fft_nd(z, shape, direction, normalize),
                       label=f"{label} c2c {direction}/{normalize}")
    else:
        x = rng.standard_normal((batch, *shape)).astype(np.float32)
        r, _, _ = both_plan(world, {"type": "r2c", "shape": shape, "batch": batch},
                            axes, dp, PAIR, [x])
        pk = shape[0] // 2 + 1
        ref = R.fft_nd(x.astype(np.float64), shape, "forward")[:, :pk]
        assert_close_c(unil(r["out"]).reshape(batch, pk, *shape[1:]), ref,
                       label=f"{label} r2c")
        r2, _, _ = both_plan(world, {"type": "c2r", "shape": shape, "batch": batch,
                                     "direction": "inverse", "normalize": "backward"},
                             axes, dp, PAIR, [r["out"]])
        assert_close(r2["out"].reshape(batch, *shape), x, label=f"{label} c2r")


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_distributed_spectral(world, seed):
    """test_fuzz.py::test_fuzz_distributed_spectral: random sequence-parallel
    STFT / ISTFT / welch geometries on sp 2, 4 or 8, against the façade at
    the JAX file's bars; the port agrees with the JAX builders at the same."""
    import scipy.signal as ss
    from webgpufft_tpu import fft as wfft
    from webgpufft_tpu.parallel.sharded import distributed_stft_geometry
    from webgpufft_tpu_torch.parallel import sharded as TS
    r = np.random.default_rng(3000 + seed)
    ndev = int(r.choice([2, 4, 8]))
    axes = {"sp": ndev}
    W = int(r.choice([32, 64, 96, 128]))
    H = int(r.integers(max(W // 4, 8), W + 1))
    n = int(r.integers(1500, 4000))
    for _ in range(2000):
        if distributed_stft_geometry(n, W, H, ndev) is not None:
            break
        n += 1
    assert TS.distributed_stft_geometry(n, W, H, ndev) == distributed_stft_geometry(
        n, W, H, ndev)
    x = r.standard_normal((2, n)).astype(np.float32)
    kw = {"nperseg": W, "noverlap": W - H}
    label = (W, H, n, ndev)
    Zd, _ = both_build(world, "build_distributed_stft", [n, "MESH", "sp"], kw, axes, [x],
                       tol=2e-5, attrs=())
    _, _, Zr = wfft.stft(x, **kw)
    Zr = np.asarray(Zr)
    assert np.max(np.abs(Zd - Zr)) / max(np.max(np.abs(Zr)), 1e-6) < 2e-5, label
    if ss.check_NOLA("hann", W, W - H):
        xr, _ = both_build(world, "build_distributed_istft", [n, "MESH", "sp"], kw, axes,
                           [Zr], tol=5e-5, attrs=())
        assert np.max(np.abs(xr - x)) / max(np.max(np.abs(x)), 1e-6) < 5e-5, label
    if ((n - W) // H + 1) % ndev == 0:
        Pd, _ = both_build(world, "build_distributed_welch", [n, "MESH", "sp"], kw, axes,
                           [x], tol=2e-5, attrs=())
        _, Pr = wfft.welch(x, **kw)
        Pr = np.asarray(Pr)
        assert np.max(np.abs(Pd - Pr)) / np.max(Pr) < 2e-5, label


def test_distributed_records_measure_degradation(world):
    """test_measure.py::test_distributed_records_measure_degradation."""
    r, _, _ = both_plan(world, c2c([64], 2, direction="forward", normalize="none",
                                   tuning={"rigor": "measure"}),
                        {"sp": 4}, None, "sp", call=False)
    assert "measure-unsupported:distributed" in r["route"]["reasons"]



@pytest.mark.parametrize("route,opts,axes,batch_axis,seq_axis", [
    ("halo", fftconv([256], 4, boundary="linear-same", kernelShape=[9]),
     DP2SP4, "dp", "sp"),
    ("spectrum", fftconv([256], 4, boundary="circular"), DP2SP4, "dp", "sp"),
    ("spectrum, linear", fftconv([96], 4, boundary="linear-full", kernelShape=[40]),
     {"dp": 2, "sp": 2}, "dp", "sp"),
    ("pencil", fftconv([16, 8], 2, boundary="circular"), PENCIL_DP, "dp", PAIR),
    ("dp", fftconv([64], 8, boundary="linear-same", kernelShape=[9]),
     {"dp": 8}, "dp", None)], ids=["halo", "spectrum", "spectrum-linear", "pencil", "dp"])
def test_kernel_gradient_matches_the_local_plan(world, rng, route, opts, axes,
                                                batch_axis, seq_axis):
    """d/dk sum(w * plan(x, kernel=k)) through each distributed fftconv
    route equals the local plan's: every rank convolves its part of the
    batch and the signal with the kernel every rank holds, so the kernel's
    gradient sums the parts' (``collectives.psum_grad``)."""
    fc = opts["fftConv"]
    kshape = fc.get("kernelShape", opts["shape"])
    b, shape = opts["batch"], opts["shape"]
    x = il(cx(rng, b, *shape))
    k = il(cx(rng, *kshape))
    jplan = jax_plan(opts, axes, batch_axis, seq_axis)
    w = rng.standard_normal(np.asarray(jplan(x, kernel=k)).shape).astype(np.float32)
    g, gl, reasons = world.run("call", "torch_world_cases", "plan_kernel_grad", opts,
                               axes, batch_axis, seq_axis, x, k, w)
    assert any(r.startswith("fftconv-halo") for r in reasons) == (route == "halo")
    assert_close(g, gl, label=f"d/dkernel {route}")


# ------------------------------------------------- distributed AOT export

def _jax_served(opts, axes, batch_axis, seq_axis, x, kernel=None):
    """The JAX artifact of the same plan, loaded and served on the same
    mesh (8 virtual CPU devices)."""
    import webgpufft_tpu as W
    from torch_dist_support import jax_mesh
    ep = W.load_exported_plan(W.export_distributed_plan(
        jax_plan(opts, axes, batch_axis, seq_axis)))
    args = (x,) if kernel is None else (x, kernel)
    return np.asarray(ep(*args, mesh=jax_mesh(axes))), ep


def _both_served(world, opts, axes, batch_axis, seq_axis, x, kernel=None, **kw):
    """Both packages' artifacts served on the same input: the port's output
    equals its live plan's, agrees with the JAX artifact's at 1e-5 of
    max|JAX|, gathered nothing, and records the JAX artifact's mesh."""
    jy, jep = _jax_served(opts, axes, batch_axis, seq_axis, x, kernel)
    r = world.run("call", "torch_world_cases", "aot_distributed", opts, axes,
                  batch_axis, seq_axis, x, kernel, **kw)
    assert r["same_as_live"]
    assert_close_c(r["out"], jy, 1e-5, f"aot {opts['type']}")
    assert r["coll"]["all_gather"] == 0, r["coll"]
    jd = jep.distributed
    assert r["distributed"]["mesh"] == {k: int(v) for k, v in jd["mesh"].items()}
    assert r["distributed"]["nr_devices"] == jd["nr_devices"]
    assert r["distributed"]["batch_axis"] == jd["batch_axis"]
    assert r["route_mode"] == jep.route_mode
    return r


def test_aot_distributed_c2c(world, rng):
    """test_aot.py::test_aot_distributed_c2c: dp 2 x sp 4, served on a
    fresh mesh of the same axes; a mesh of other axes is refused."""
    z = cx(rng, 4, 256)
    opts = c2c([256], 4, normalize="unitary")
    r = _both_served(world, opts, DP2SP4, "dp", "sp", il(z), wrong_axes=SP8)
    assert r["distributed"]["nr_devices"] == 8
    assert r["distributed"]["mesh"] == {"dp": 2, "sp": 4}
    assert_close_c(unil(r["out"]), R.fft_nd(z, [256], "forward") / np.sqrt(256),
                   label="aot dist")
    assert "mesh axes" in r["wrong_mesh"]


def test_aot_distributed_pencil(world, rng):
    """test_aot.py::test_aot_distributed_pencil: the axis pair is recorded."""
    shape, b = [8, 16, 3], 2
    z = cx(rng, b, *shape)
    r = _both_served(world, c2c(shape, b), PENCIL, None, PAIR, il(z))
    assert r["route_mode"] == "distributed-pencil"
    assert r["distributed"]["seq_axis"] == ["sp0", "sp1"]
    assert_close_c(unil(r["out"]), R.fft_nd(z, shape, "forward"), label="aot pencil")


def test_aot_distributed_fftconv_kernel(world, rng):
    """test_aot.py::test_aot_distributed_fftconv_kernel."""
    z, k = cx(rng, 2, 64), cx(rng, 9)
    opts = fftconv([64], 2, boundary="linear-same", kernelShape=[9])
    r = _both_served(world, opts, SP8, None, "sp", il(z), il(k)[None])
    ref = R.fftconv(z, k, [64], batch=2, boundary="linear-same", kernel_shape=[9])
    assert_close_c(unil(r["out"]), ref, label="aot dconv")


def test_aot_distributed_rejects_dp_only(world):
    """test_aot.py::test_aot_distributed_rejects_dp_only."""
    import webgpufft_tpu as W
    opts = c2c([32], 8)
    with pytest.raises(W.PlanError, match="export_plan"):
        W.export_distributed_plan(jax_plan(opts, {"dp": 8}, "dp", None))
    raises(world, "PlanError", "export_plan", "call", "torch_world_cases",
           "aot_distributed", opts, {"dp": 8}, "dp", None,
           np.zeros((8, 32, 2), np.float32))


def test_aot_distributed_halo_plan(world, rng):
    """test_aot.py::test_aot_distributed_halo_plan: the halo route exports
    and serves like the spectrum routes (a bare kernel gains its count dim)."""
    z, k = cx(rng, 2, 1024), cx(rng, 17)
    opts = fftconv([1024], 2, boundary="linear-same", kernelShape=[17])
    r = _both_served(world, opts, SP8, None, "sp", il(z), il(k))
    assert any(x.startswith("fftconv-halo") for x in r["reasons"])
    ref = R.fftconv(z, k, [1024], batch=2, boundary="linear-same", kernel_shape=[17])
    assert_close_c(unil(r["out"]), ref, label="aot halo")
