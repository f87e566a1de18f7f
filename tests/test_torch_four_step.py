"""The case list of ``tests/test_four_step.py`` through both packages.

Outputs: the port's CPU plan against the JAX plan from the same options dict
and against numpy at 1e-5 * max|expected| (bf16-storage 2e-2, the JAX
file's bound).  Routes: equal where the decision still exists in the port
(the ``fourStepMinN`` threshold, ``largeRoute``, ``disableOutOfCoreFourStep``,
the mid-form preferences).  The JAX cases that shrink ``OPERAND_CHUNK_ELEMS``
/ ``CHUNK_ELEMS`` rest on the TPU operand bound the port dropped (no
necessity four-step, no digit slabs, no outer slabs): there the JAX plan is
built under the same patch as in the JAX file and the port's route is written
out in the case, with the outputs compared all the same.  The eligibility
rule itself and the r2c/c2r four-step cases also stand in
``test_torch_axis_kinds.py`` and ``test_torch_real.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from torch_port_support import run_both, same_route
from webgpufft_tpu.core import axis as JA
from webgpufft_tpu.core.cplx import interleave, uninterleave
from webgpufft_tpu.plans import transforms as JT
from webgpufft_tpu.spec import TuningSpec as JTuning
from webgpufft_tpu.utils import mathref as R
from webgpufft_tpu_torch.core import axis as TA
from webgpufft_tpu_torch.spec import TuningSpec as TTuning

FS = {"fourStepMinN": 2048}


def rand_c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def shrink_bound(monkeypatch, elems):
    """The JAX package's operand bound, lowered as its own tests lower it."""
    monkeypatch.setattr(JA, "OPERAND_CHUNK_ELEMS", elems)
    monkeypatch.setattr(JT, "CHUNK_ELEMS", elems)


def axis_reasons(route):
    return [r for r in route.reasons if "-axis" in r]


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_four_step_forced_matches_numpy(rng, assert_close, direction):
    n = 8192
    z = rand_c(rng, (2, n))
    jplan, tplan, jy, ty = run_both(
        {"type": "c2c", "shape": [n], "batch": 2, "direction": direction,
         "normalize": "unitary", "tuning": {"largeRoute": "out-of-core"}}, interleave(z))
    assert jplan.route.mode == tplan.route.mode == "four-step-hbm"
    assert any("four-step" in r for r in tplan.route.reasons)
    assert_close(ty, jy, label="4step port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, [n], direction) / np.sqrt(n), label="4step")


def test_four_step_auto_threshold(rng, assert_close):
    n = 4096
    z = rand_c(rng, (1, n))
    ref = R.fft_nd(z, [n], "forward")
    for minn, mode in ((n, "four-step-hbm"), (n + 1, "xla")):
        jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": [n], "batch": 1,
                                         "tuning": {"fourStepMinN": minn}}, interleave(z))
        assert jplan.route.mode == tplan.route.mode == mode
        assert_close(ty, jy, label=f"threshold {minn} port vs JAX")
        assert_close(uninterleave(ty), ref, label=f"threshold {minn}")


def test_four_step_chunk_route_disables():
    opts = {"type": "c2c", "shape": [8192], "batch": 1,
            "tuning": {"largeRoute": "chunk", "fourStepMinN": 4096}}
    assert W.create_plan(opts, cache=W.PlanCache()).route.mode == "xla"
    assert T.create_plan(opts, device="cpu", cache=T.PlanCache()).route.mode == "xla"


def test_four_step_slab_chunking(rng, assert_close, monkeypatch):
    """Past its (lowered) operand bound the JAX package takes four-step by
    necessity and streams digit slabs; the port runs the line whole on the
    mixed-radix einsum route (one line is under K1's floor of 8)."""
    shrink_bound(monkeypatch, 2048)
    n = 16384
    z = rand_c(rng, (1, n))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": [n], "batch": 1,
                                     "direction": "forward"}, interleave(z))
    assert jplan.route.mode == "four-step-hbm"
    assert "single-item-exceeds-chunk" in jplan.route.reasons
    assert tplan.route.mode == "xla" and axis_reasons(tplan.route) == ["c2c-axis0-xla"]
    assert "fused-batch-too-small" in tplan.route.reasons
    assert "single-item-exceeds-chunk" not in tplan.route.reasons
    assert_close(ty, jy, label="4step-slabs port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, [n], "forward"), label="4step-slabs")


def test_giant_nd_slabbed_axes(rng, assert_close, monkeypatch):
    """The JAX package slabs every axis application of an item past its
    bound; the port has no bound and runs K2 then K1."""
    shrink_bound(monkeypatch, 1024)
    shape = (64, 128)
    z = rand_c(rng, (1, *shape))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": list(shape), "batch": 1},
                                    interleave(z))
    assert "single-item-exceeds-chunk" in jplan.route.reasons
    assert tplan.route.mode == "pallas-fused"
    assert axis_reasons(tplan.route) == ["c2c-axis0-fused-cols", "c2c-axis1-fused-lines"]
    assert "single-item-exceeds-chunk" not in tplan.route.reasons
    assert_close(ty, jy, label="nd-slabs port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, shape, "forward"), label="nd-slabs")


def test_giant_r2c_slabbed(rng, assert_close, monkeypatch):
    shrink_bound(monkeypatch, 1024)
    shape = (64, 64)
    x = rng.standard_normal((1, *shape)).astype(np.float32)
    jplan, tplan, jy, ty = run_both({"type": "r2c", "shape": list(shape),
                                     "direction": "forward"}, x)
    assert not any("chunk" in r for r in tplan.route.reasons)
    assert_close(ty, jy, label="r2c-slabs port vs JAX")
    assert_close(uninterleave(ty), R.r2c_packed(x.astype(np.float64), shape), label="r2c-slabs")


def test_giant_unchunkable_raises(rng, assert_close, monkeypatch):
    """A single transform past the (lowered) bound with nothing to chunk
    over fails at build time in the JAX package; the port has no bound to
    exceed and computes it (two Rader axes)."""
    shrink_bound(monkeypatch, 1024)
    opts = {"type": "c2c", "shape": [2053, 2053], "batch": 1}
    with pytest.raises(W.PlanError, match="operand size"):
        W.create_plan(opts, cache=W.PlanCache())
    tplan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    assert tplan.route.axis_kinds == ("rader", "rader") and tplan.route.mode == "xla"
    z = rand_c(rng, (1, 2053, 2053))
    y = tplan(torch.from_numpy(interleave(z))).numpy()
    assert_close(uninterleave(y), np.fft.fft2(z, axes=(1, 2)), label="2053x2053")


def test_four_step_in_bluestein_inner(rng, assert_close, monkeypatch):
    """Bluestein's inner smooth-M FFTs: four-step by necessity in the JAX
    package under the lowered bound, mixed-radix in the port."""
    shrink_bound(monkeypatch, 4096)
    n = 4099
    z = rand_c(rng, (1, n))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": [n], "batch": 1}, interleave(z))
    assert jplan.route.axis_kinds == tplan.route.axis_kinds == ("bluestein",)
    assert tplan.route.mode == "xla"
    assert_close(ty, jy, label="bluestein-4step port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, [n], "forward"), label="bluestein-4step")


def test_four_step_composes_with_staging(rng, assert_close):
    n = 4096
    z = rand_c(rng, (1, n - 128)) * 0.5
    jplan, tplan, jy, ty = run_both(
        {"type": "c2c", "shape": [n], "batch": 1, "ioView": {"input": {"shape": [n - 128]}},
         "tuning": {"fourStepMinN": n}}, interleave(z))
    assert jplan.route.mode == tplan.route.mode == "four-step-hbm"
    padded = np.zeros((1, n), complex)
    padded[:, :n - 128] = z
    assert_close(ty, jy, label="4step+ioview port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(padded, [n], "forward"), label="4step+ioview")


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_four_step_nd_non_last_axis(impl, rng, assert_close):
    """Four-step on axis 0 of (4096, 4).  Under "auto" the port gives the
    4-point last axis to K1 (4096 lines), so its mode is "pallas-mixed"
    where the JAX package reports "four-step-hbm"."""
    shape = (4096, 4)
    z = rand_c(rng, (1, *shape))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": list(shape), "batch": 1,
                                     "tuning": {"fourStepMinN": 4096}}, interleave(z),
                                    impl=impl)
    assert jplan.route.mode == "four-step-hbm"
    if impl == "xla":
        same_route(jplan, tplan)
    else:
        assert tplan.route.mode == "pallas-mixed"
        assert axis_reasons(tplan.route) == ["c2c-axis0-xla-four-step", "c2c-axis1-fused-lines"]
    assert_close(ty, jy, label="4step-axis0 port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, shape, "forward"), label="4step-axis0")


def test_four_step_in_r2c_c2r(rng, assert_close):
    n = 8192
    x = rng.standard_normal((1, n)).astype(np.float32)
    _, _, jy, ty = run_both({"type": "r2c", "shape": [n], "direction": "forward",
                             "tuning": FS}, x)
    assert_close(ty, jy, label="r2c-4step port vs JAX")
    assert_close(uninterleave(ty), np.fft.rfft(x, axis=1), label="r2c-4step")
    _, _, jb, tb = run_both({"type": "c2r", "shape": [n], "direction": "inverse",
                             "normalize": "backward", "tuning": FS}, ty)
    assert_close(tb, jb, label="c2r-4step port vs JAX")
    assert_close(tb, x, label="c2r-4step roundtrip")


def test_four_step_in_dct_fft_route(rng, assert_close):
    n = 4096
    x = rng.standard_normal((1, n)).astype(np.float32)
    jplan, tplan, jy, ty = run_both({"type": "dct2", "shape": [n], "direction": "forward",
                                     "tuning": {**FS, "dct_fft_min_n": 1024}}, x)
    # the port also names the route of the pass inside the dct axis
    assert axis_reasons(jplan.route) == ["dct-axis0-fft"]
    assert axis_reasons(tplan.route) == ["dct-axis0-fft", "dct-axis0-fft-xla-four-step"]
    assert_close(ty, jy, label="dct2-4step port vs JAX")
    assert_close(ty, R.dct_nd(x.astype(np.float64), [n], "dct2", "forward"), label="dct2-4step")


def test_four_step_in_fftconv(rng, assert_close):
    n = 4096
    z, k = rand_c(rng, (1, n)) * 0.1, rand_c(rng, (n,)) * 0.1
    _, _, jy, ty = run_both({"type": "fftconv", "shape": [n], "batch": 1, "tuning": FS},
                            interleave(z), kernel=interleave(k))
    assert_close(ty, jy, label="fftconv-4step port vs JAX")
    assert_close(uninterleave(ty), R.fftconv(z, k, [n], batch=1), label="fftconv-4step")


def test_four_step_bf16_storage(rng, assert_close):
    n = 4096
    z = rand_c(rng, (1, n)) * 0.5
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": [n], "batch": 1,
                                     "precision": "bf16-storage", "tuning": FS}, interleave(z))
    assert jplan.route.mode == tplan.route.mode == "four-step-hbm"
    assert_close(ty, jy, atol_scale=2e-2, label="4step bf16 port vs JAX")
    ref = R.fft_nd(z, [n], "forward")
    err = np.max(np.abs(uninterleave(ty) - ref)) / np.max(np.abs(ref))
    assert err < 2e-2, err  # bf16 storage rounding dominates


def test_out_of_core_respects_lower_user_threshold(rng, assert_close):
    z = rand_c(rng, (1, 2048))
    jplan, tplan, jy, ty = run_both(
        {"type": "c2c", "shape": [2048], "batch": 1,
         "tuning": {"fourStepMinN": 2048, "largeRoute": "out-of-core"}}, interleave(z))
    assert jplan.route.mode == tplan.route.mode == "four-step-hbm"
    assert_close(ty, jy, label="oc-low-threshold port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, [2048], "forward"), label="oc-low-threshold")


@pytest.mark.parametrize("n,max_sub", [(4096, 8), (4096, 32), (8192, 64), (4096, 16),
                                       (1 << 16, 32)])
def test_two_level_split_matches_jax(n, max_sub):
    """The sub-DFT lengths of a mixed axis (lowered and raised maxSubLength,
    the two-level preference) are the JAX package's."""
    subs = TA.MixedAxisPlan(n, "forward", "t", max_sub=max_sub).subs
    assert subs == JA.MixedAxisPlan(n, "forward", "t", max_sub=max_sub).subs
    assert max(subs) <= max(max_sub, 64) and int(np.prod(subs)) == n
    if (n, max_sub) == (4096, 8):
        assert subs[0] <= 8
    if (n, max_sub) == (4096, 32):
        assert subs == [64, 64]
    if (n, max_sub) == (8192, 64):
        assert max(subs) <= 64


def test_four_step_slabs_are_a_jax_route():
    """The JAX plan bounds its einsum operands by digit slabs (and raises
    when it cannot); the port's four-step plan takes no bound and has no
    slab machinery."""
    ap = JA.FourStepAxisPlan(64, "forward", "f", chunk_elems=16)
    with pytest.raises(ValueError, match="cannot bound"):
        ap._slabs(4)
    tp = TA.FourStepAxisPlan(64, "forward", "f")
    assert not hasattr(tp, "_slabs") and not hasattr(tp, "chunk_elems")
    assert (tp.n1, tp.n2) == (ap.n1, ap.n2)


def test_composed_outer_and_inner_chunking(rng, assert_close, monkeypatch):
    """(64, 4096) past the lowered bound: outer and inner slabs in the JAX
    package; K2 and K1, whole, in the port."""
    shrink_bound(monkeypatch, 1024)
    shape = (64, 4096)
    z = rand_c(rng, (1, *shape))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": list(shape), "batch": 1},
                                    interleave(z))
    assert tplan.route.mode == "pallas-fused"
    assert axis_reasons(tplan.route) == ["c2c-axis0-fused-cols", "c2c-axis1-fused-lines"]
    assert_close(ty, jy, label="composed-chunking port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, shape, "forward"), label="composed-chunking")


def test_disable_out_of_core_four_step(rng, assert_close):
    z = rand_c(rng, (1, 8192))
    jplan, tplan, jy, ty = run_both(
        {"type": "c2c", "shape": [8192], "batch": 1,
         "tuning": {"fourStepMinN": 4096, "disableOutOfCoreFourStep": True}}, interleave(z))
    assert jplan.route.mode == tplan.route.mode == "xla"
    assert_close(ty, jy, label="disable-4step port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, [8192], "forward"), label="disable-4step")


@pytest.mark.parametrize("chunk", [None, 256])
def test_four_step_apply_mid_matches_apply(chunk, rng, assert_close):
    """``apply_mid`` with a riding lane dim equals the movedim + ``apply``
    form and the JAX plan's (whole, and slabbed by a tiny ``chunk_elems``,
    which only the JAX plan has)."""
    jp = JA.FourStepAxisPlan(64, "forward", "fsm", chunk_elems=chunk)
    tp = TA.FourStepAxisPlan(64, "forward", "fsm")
    jc = {k: jnp.asarray(v) for k, v in jp.consts().items()}
    tc = {k: torch.from_numpy(v) for k, v in tp.consts().items()}
    x = rng.standard_normal((3, 64, 5, 2)).astype(np.float32)
    got = tp.apply_mid(torch.from_numpy(x), tc).numpy()
    via_move = torch.movedim(tp.apply(torch.movedim(torch.from_numpy(x), 1, -2).contiguous(), tc),
                             -2, 1).numpy()
    assert_close(got, via_move, label=f"mid-vs-move chunk={chunk}")
    assert_close(got, np.asarray(jp.apply_mid(jnp.asarray(x), jc)), label="mid port vs JAX")
    z = x[..., 0] + 1j * x[..., 1]
    assert_close(got[..., 0] + 1j * got[..., 1], np.fft.fft(z, axis=1), label="mid-oracle")


def test_four_step_mid_structural_and_nested():
    """The mid-form capabilities and preferences are the JAX package's."""
    for make in (lambda A: A.FourStepAxisPlan(4096, "forward", "fss"),
                 lambda A: A.MixedAxisPlan(4096, "forward", "mxp"),
                 lambda A: A.BluesteinAxisPlan(2801, "forward", "bls")):
        jp, tp = make(JA), make(TA)
        assert (tp.supports_mid, tp.prefer_mid) == (jp.supports_mid, jp.prefer_mid)
    tp = TA.FourStepAxisPlan(4096, "forward", "fss")
    assert tp.supports_mid and not tp.prefer_mid
    assert TA.MixedAxisPlan(4096, "forward", "mxp").prefer_mid
    jt = dataclasses.replace(JTuning(), four_step_min_n=2048)
    tt = dataclasses.replace(TTuning(), four_step_min_n=2048)
    jb = JA.BluesteinAxisPlan(2801, "forward", "blm", tuning=jt)
    tb = TA.BluesteinAxisPlan(2801, "forward", "blm", tuning=tt)
    assert isinstance(tb.fwd, TA.FourStepAxisPlan) and isinstance(jb.fwd, JA.FourStepAxisPlan)
    assert tb.supports_mid and not tb.prefer_mid
    rd = TA.RaderAxisPlan(2053, "forward", "rdm", tuning=tt)
    assert isinstance(rd.fwd, TA.FourStepAxisPlan) or rd.supports_mid
    bsm = TA.BluesteinAxisPlan(2801, "forward", "bls")
    assert bsm.supports_mid and bsm.prefer_mid


@pytest.mark.parametrize("shape,minn", [((4096, 4), 4096), ((2801, 3), 2048)])
def test_four_step_nd_non_last_axis_mid_route(shape, minn, rng, assert_close):
    """ND c2c with a four-step axis 0, and a Bluestein axis 0 whose inner
    M-FFT is four-step, under the einsum route of both packages."""
    z = rand_c(rng, (1, *shape))
    jplan, tplan, jy, ty = run_both({"type": "c2c", "shape": list(shape), "batch": 1,
                                     "tuning": {"fourStepMinN": minn}}, interleave(z),
                                    impl="xla")
    same_route(jplan, tplan)
    assert_close(ty, jy, label=f"{shape} port vs JAX")
    assert_close(uninterleave(ty), R.fft_nd(z, shape, "forward"), label=f"{shape}")
