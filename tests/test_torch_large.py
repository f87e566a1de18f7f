"""The case list of ``tests/test_large.py`` through both packages.

Sizes are the JAX file's.  Outputs: the port's CPU plan against the JAX plan
built from the same options dict and against numpy, 1e-5 * max|expected|
(bf16-storage 2e-2, the JAX file's own bound, which is inside the port's
3e-2).  Routes: the JAX cases that pin batch chunking rest on a TPU fact the
port dropped (the 2^22-element operand bound ``CHUNK_ELEMS`` /
``chunked_batch``, and the unroll-or-``lax.map`` choice per core type): the
port runs every batch whole, so those cases write the port's route out
(``PORT_REASONS``: no chunk reason, ``chunkElements`` recorded as
``ignored-tpu-knob:chunkElements``) beside the JAX package's, and compare
outputs all the same.
"""

import numpy as np
import pytest

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from torch_port_support import run_both, same_route
from webgpufft_tpu.core.cplx import interleave, uninterleave
from webgpufft_tpu.utils import factors as jfactors
from webgpufft_tpu_torch.utils import factors as tfactors

KNOB = "ignored-tpu-knob:chunkElements"


def no_chunking(plan):
    """The port's route for a spec the JAX package chunks: nothing chunked."""
    assert not any("chunk" in r and r != KNOB for r in plan.route.reasons), plan.route.reasons


def rand_c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("n", [2 ** 16, 2 ** 18])
def test_large_1d_c2c(n, rng, assert_close):
    z = rand_c(rng, (1, n))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": [n], "batch": 1,
                                     "direction": "forward"}, interleave(z), impl="xla")
    same_route(jplan, tplan)
    assert_close(ty, jy, label=f"large{n} port vs JAX")
    assert_close(uninterleave(ty), np.fft.fft(z, axis=-1), label=f"large{n} vs numpy")


def test_pow20_decomposition_structure():
    """2^20 = four levels of 32-point sub-DFTs in both packages."""
    subs = tfactors.split_sublengths(2 ** 20, 32)
    assert subs == jfactors.split_sublengths(2 ** 20, 32)
    assert np.prod(subs) == 2 ** 20 and all(s <= 32 for s in subs) and len(subs) == 4


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_large_2d(impl, rng, assert_close):
    shape = (512, 512)
    z = rand_c(rng, (1, *shape))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": list(shape), "batch": 1},
                                    interleave(z), impl=impl)
    assert_close(ty, jy, label="512x512 port vs JAX")
    assert_close(uninterleave(ty), np.fft.fft2(z, axes=(1, 2)), label="512x512 vs numpy")
    if impl == "xla":
        same_route(jplan, tplan)
    else:   # auto: the einsum route there, K2 + K1 here
        assert jplan.route.mode == "xla" and tplan.route.mode == "pallas-fused"


def test_large_r2c_roundtrip(rng, assert_close):
    n = 2 ** 16
    x = rng.standard_normal((1, n)).astype(np.float32)
    _, _, jy, ty = run_both({"type": "r2c", "shape": [n], "direction": "forward", "batch": 1}, x)
    assert_close(ty, jy, label="large r2c port vs JAX")
    _, _, jb, tb = run_both({"type": "c2r", "shape": [n], "direction": "inverse",
                             "normalize": "backward", "batch": 1}, ty)
    assert_close(tb, jb, label="large c2r port vs JAX")
    assert_close(tb, x, label="large r2c roundtrip")


def test_bf16_storage_large(rng, assert_close):
    n = 2 ** 16
    z = rand_c(rng, (1, n))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": [n], "batch": 1,
                                     "precision": "bf16-storage"}, interleave(z), impl="xla")
    assert (tplan.route.mode, tplan.route.axis_kinds) == (jplan.route.mode,
                                                          jplan.route.axis_kinds)
    ref = np.fft.fft(z, axis=-1)
    assert_close(ty, jy, atol_scale=2e-2, label="bf16 large port vs JAX")
    err = np.max(np.abs(uninterleave(ty) - ref)) / np.max(np.abs(ref))
    assert err < 2e-2, err  # bf16 input rounding dominates; compute is f32


def test_large_batch_chunk_mode(rng, assert_close):
    """batch * N beyond 2^22 elements: chunked per batch slice in the JAX
    package, run whole in the port."""
    opts = {"type": "c2c", "shape": [4096], "batch": 4096, "direction": "forward"}
    jplan = W.create_plan(opts, cache=W.PlanCache())
    assert any("large-batch-chunk" in r for r in jplan.route.reasons)
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    no_chunking(tplan)
    assert tplan.route.mode == "pallas-fused"
    z = rand_c(rng, (8, 2048))
    zfull = np.tile(z, (512, 1))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": [2048], "batch": 4096,
                                     "direction": "forward"}, interleave(zfull))
    assert any("large-batch-chunk(2048)" in r for r in jplan.route.reasons)
    no_chunking(tplan)
    assert_close(ty, jy, label="chunked port vs JAX")
    assert_close(uninterleave(ty), np.fft.fft(zfull, axis=-1), label="chunked vs numpy")


class TestChunkElementsKnob:
    """tuning.chunkElements: a per-plan operand bound in the JAX package; in
    the port an accepted knob that changes nothing and is recorded."""

    def test_tiny_bound_forces_chunking(self, rng, assert_close):
        n, batch = 256, 64
        z = rand_c(rng, (batch, n))
        jplan, tplan, jy, ty = run_both(
            {"type": "c2c", "shape": [n], "batch": batch,
             "tuning": {"chunkElements": 1 << 12}}, interleave(z))
        assert any("chunk-elems-override(4096)" in r for r in jplan.route.reasons)
        assert any("large-batch-chunk(16)" in r for r in jplan.route.reasons)
        assert KNOB in tplan.route.reasons
        no_chunking(tplan)
        assert_close(ty, jy, label="chunk-knob port vs JAX")
        assert_close(uninterleave(ty), np.fft.fft(z, axis=-1), label="chunk-knob vs numpy")

    @pytest.mark.parametrize("kind,shape,batch", [("r2c", [64, 64, 64], 48),
                                                  ("c2r", [64, 64, 64], 48),
                                                  ("c2c", [4096], 4096)])
    def test_batch_chunks_are_a_jax_route(self, kind, shape, batch):
        """The JAX package chunks these batches (through ``lax.map`` for
        r2c/c2r, unrolled for c2c: TPU compiler facts); the port's plan for
        the same options has no chunk group at all."""
        opts = {"type": kind, "shape": shape, "batch": batch,
                **({"direction": "inverse"} if kind == "c2r" else {})}
        jplan = W.create_plan(opts, cache=W.PlanCache())
        assert any("large-batch-chunk" in r for r in jplan.route.reasons)
        tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
        no_chunking(tplan)
        assert tplan.route.mode == "pallas-fused"
        assert tplan.route.axis_kinds == jplan.route.axis_kinds

    def test_bound_can_only_lower(self):
        opts = {"type": "c2c", "shape": [4096], "batch": 4096}
        jplan = W.create_plan({**opts, "tuning": {"chunkElements": 1 << 22}},
                              cache=W.PlanCache())
        assert any("large-batch-chunk" in r for r in jplan.route.reasons)
        tplan = T.create_plan({**opts, "tuning": {"chunkElements": 1 << 22}}, device="cpu",
                              cache=T.PlanCache())
        assert KNOB in tplan.route.reasons
        no_chunking(tplan)
        with pytest.raises(W.PlanError):
            W.create_plan({**opts, "tuning": {"chunkElements": 1 << 23}})
        with pytest.raises(T.PlanError):
            T.create_plan({**opts, "tuning": {"chunkElements": 1 << 23}}, device="cpu")

    def test_four_step_uses_custom_bound(self, rng, assert_close):
        n = 1 << 16
        z = rand_c(rng, (1, n))
        jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": [n], "batch": 1,
                                         "tuning": {"chunkElements": 1 << 14}}, interleave(z))
        assert jplan.route.mode == tplan.route.mode == "four-step-hbm"
        assert KNOB in tplan.route.reasons
        assert_close(ty, jy, label="fourstep-chunk port vs JAX")
        assert_close(uninterleave(ty), np.fft.fft(z, axis=-1), label="fourstep-chunk vs numpy")

    def test_r2c_c2r_respect_knob(self, rng, assert_close):
        n, batch = 512, 64
        x = rng.standard_normal((batch, n)).astype(np.float32)
        tun = {"chunkElements": 1 << 13}
        jf, tf, jy, ty = run_both({"type": "r2c", "shape": [n], "batch": batch, "tuning": tun}, x)
        assert any("chunk-elems-override" in r for r in jf.route.reasons)
        assert any("large-batch-chunk" in r for r in jf.route.reasons)
        assert KNOB in tf.route.reasons
        no_chunking(tf)
        assert_close(ty, jy, label="r2c knob port vs JAX")
        _, ti, jb, tb = run_both({"type": "c2r", "shape": [n], "batch": batch,
                                  "direction": "inverse", "normalize": "backward",
                                  "tuning": tun}, ty)
        assert KNOB in ti.route.reasons
        assert_close(tb, jb, label="c2r knob port vs JAX")
        assert_close(tb, x, label="r2c knob roundtrip")

    def test_validation(self):
        for bad in (7, 1 << 30):
            with pytest.raises(W.PlanError):
                W.create_plan(type="c2c", shape=[16], tuning={"chunkElements": bad})
            with pytest.raises(T.PlanError):
                T.create_plan({"type": "c2c", "shape": [16], "tuning": {"chunkElements": bad}},
                              device="cpu")
