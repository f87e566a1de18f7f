"""The randomized lanes of ``tests/test_fuzz.py`` through both packages.

The same seeded random specs (the JAX file's generators, copied: a seed gives
the same shape, batch, direction, normalize, family and staging in both
files) run through the JAX plan and the port's CPU plan from one options
dict; the port is held to the JAX package's output and to the numpy oracle
at the JAX file's tolerances (1e-5 * max|expected| for c2c and r2c/c2r,
5e-5 for dct/dst and fftconv).  Under ``impl: "auto"`` the JAX package takes
its einsum route and the port its kernels' plain versions, so the routes
differ by design; under ``xla`` they are equal field for field.

The JAX file's three other local lanes run here against the same scipy and
numpy oracles at the same bars, the port under ``default_device("cpu")``:
random filter designs applied by the DSP toolboxes, random ``ShortTimeFFT``
geometries and envelope bands, and random ``s=`` / ``axes=`` combinations
through the N-D façade, where the port must also raise ``PlanError`` exactly
where the oracle raises and agree with the JAX package's result at 1e-5.
The six distributed lanes are mirrored in
``tests/test_torch_distributed_plans.py``, in its 8-rank gloo world.

``chip_smoke.domain_lengths()`` is held here to the two kernels' choosers,
so the card's sweep of every length K1 and K2 accept cannot shrink unseen.
"""

import numpy as np
import pytest

from torch_port_support import assert_close_c, chip_smoke, run_both, same_route, to_numpy
from webgpufft_tpu.core.cplx import interleave, uninterleave
from webgpufft_tpu.utils import mathref as R

AXIS_POOL = [2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 15, 16, 17, 20, 23, 30]
IMPLS = ["auto", "xla"]


def _rand_spec(rng):
    rank = int(rng.integers(1, 5))
    shape = [int(rng.choice(AXIS_POOL)) for _ in range(rank)]
    while np.prod(shape) > 4096:
        shape[int(rng.integers(0, rank))] = 2
    batch = int(rng.choice([1, 2, 3, 5]))
    direction = str(rng.choice(["forward", "inverse"]))
    normalize = str(rng.choice(["none", "backward", "unitary"]))
    return shape, batch, direction, normalize


def both(opts, x, impl, assert_close, label, tol=1e-5, **kw):
    jplan, tplan, jy, ty = run_both(opts, x, impl=impl, **kw)
    assert_close(ty, jy, atol_scale=tol, label=f"{label} port vs JAX ({impl})")
    assert tplan.route.axis_kinds == jplan.route.axis_kinds
    if impl == "xla":
        same_route(jplan, tplan)
    return ty


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(24))
def test_fuzz_c2c(seed, impl, assert_close):
    rng = np.random.default_rng(1000 + seed)
    shape, batch, direction, normalize = _rand_spec(rng)
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    label = f"fuzz c2c seed={seed} {shape} b{batch} {direction}/{normalize}"
    y = both({"type": "c2c", "shape": shape, "batch": batch, "direction": direction,
              "normalize": normalize}, interleave(z), impl, assert_close, label)
    assert_close(uninterleave(y), R.fft_nd(z, shape, direction, normalize), label=label)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(12))
def test_fuzz_r2c_c2r_roundtrip(seed, impl, assert_close):
    rng = np.random.default_rng(2000 + seed)
    shape, batch, _, _ = _rand_spec(rng)
    shape[0] = int(rng.choice([4, 6, 8, 9, 12, 16, 17, 30]))  # incl. odd/prime
    x = rng.standard_normal((batch, *shape)).astype(np.float32)
    y = both({"type": "r2c", "shape": shape, "direction": "forward", "batch": batch},
             x, impl, assert_close, f"fuzz r2c seed={seed} {shape}")
    assert_close(uninterleave(y), R.r2c_packed(x.astype(np.float64), shape),
                 label=f"fuzz r2c seed={seed} {shape}")
    back = both({"type": "c2r", "shape": shape, "direction": "inverse", "normalize": "backward",
                 "batch": batch}, y, impl, assert_close, f"fuzz c2r seed={seed} {shape}")
    assert_close(back, x, label=f"fuzz r2c/c2r roundtrip seed={seed} {shape}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(12))
def test_fuzz_dct_dst(seed, impl, assert_close):
    rng = np.random.default_rng(3000 + seed)
    shape, batch, direction, normalize = _rand_spec(rng)
    kind = str(rng.choice(["dct1", "dct2", "dct3", "dct4", "dst1", "dst2", "dst3", "dst4"]))
    if kind in ("dst1",):  # dst1 domain constraint: keep axes >= 2
        shape = [max(s, 2) for s in shape]
    x = rng.standard_normal((batch, *shape)).astype(np.float32)
    label = f"fuzz {kind} seed={seed} {shape} {direction}/{normalize}"
    y = both({"type": kind, "shape": shape, "batch": batch, "direction": direction,
              "normalize": normalize}, x, impl, assert_close, label, tol=5e-5)
    ref = R.dct_nd(x.astype(np.float64), shape, kind, direction)
    ref = ref * R.normalize_scale(normalize, direction, int(np.prod(shape)))
    assert_close(y, ref, atol_scale=5e-5, label=label)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(8))
def test_fuzz_fftconv(seed, impl, assert_close):
    rng = np.random.default_rng(4000 + seed)
    rank = int(rng.integers(1, 4))
    shape = [int(rng.choice([4, 6, 8, 9, 12, 16])) for _ in range(rank)]
    kshape = [int(rng.integers(1, s + 1)) for s in shape]
    boundary = str(rng.choice(["circular", "linear-full", "linear-same", "linear-valid"]))
    mode = str(rng.choice(["convolution", "correlation"]))
    batch = int(rng.choice([1, 2, 3]))
    z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
    k = rng.standard_normal(kshape) + 1j * rng.standard_normal(kshape)
    label = f"fuzz fftconv seed={seed} {shape}*{kshape} {boundary}/{mode}"
    y = both({"type": "fftconv", "shape": shape, "batch": batch,
              "fftConv": {"boundary": boundary, "mode": mode, "kernelShape": kshape}},
             interleave(z), impl, assert_close, label, tol=5e-5, kernel=interleave(k))
    ref = R.fftconv(z, k, shape, batch=batch, mode=mode, boundary=boundary, kernel_shape=kshape)
    assert_close(uninterleave(y), ref, atol_scale=5e-5, label=label)


def test_domain_lengths_are_the_choosers_eligible_sets():
    """The card's ``domain`` phase sweeps every length the choosers split."""
    from webgpufft_tpu_torch.core import fused, fused_cols, radix
    k1, k2 = chip_smoke().domain_lengths()
    span = range(2, radix.MAX_LENGTH * 2)   # nothing past MAX_LENGTH either
    assert k1 == [n for n in span if fused.choose_split(n)]
    assert k2 == [h for h in span if fused_cols.choose_split(h)]
    assert (len(k1), len(k2)) == (824, 830)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_dsp_toolkit(seed):
    """test_fuzz.py::test_fuzz_dsp_toolkit: the same seeded designs and
    signals through the port's toolboxes, against scipy at the same bars."""
    import scipy.signal as ss
    from webgpufft_tpu_torch import fftapi as TF
    from webgpufft_tpu_torch import filtering as FL
    from webgpufft_tpu_torch import splines as SP
    r = np.random.default_rng(1000 + seed)
    n = int(r.integers(64, 400))
    x = r.standard_normal(n).astype(np.float32)

    ftype = r.choice(["butter", "cheby1", "cheby2", "ellip"])
    order = int(r.integers(2, 7))
    btype = r.choice(["lowpass", "highpass", "bandpass"])
    if btype == "bandpass":
        lo = r.uniform(0.1, 0.4)
        wn = [lo, lo + r.uniform(0.1, 0.4)]
    else:
        wn = r.uniform(0.1, 0.8)
    kw = {}
    if ftype in ("cheby1", "ellip"):
        kw["rp"] = 1.0
    if ftype in ("cheby2", "ellip"):
        kw["rs"] = 40.0
    sos = FL.iirfilter(order, wn, btype=btype, ftype=ftype, output="sos", **kw)
    sos_ref = ss.iirfilter(order, wn, btype=btype, ftype=ftype, output="sos", **kw)
    assert np.allclose(sos, sos_ref, atol=1e-9, rtol=1e-7)

    with TF.default_device("cpu"):
        got = to_numpy(FL.sosfilt(sos, x))
    want = ss.sosfilt(sos_ref, x)
    assert np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6) < 5e-4

    numtaps = int(r.integers(9, 64)) | 1
    cutoff = r.uniform(0.1, 0.9)
    taps = FL.firwin(numtaps, cutoff)
    assert np.allclose(taps, ss.firwin(numtaps, cutoff), atol=1e-13)
    with TF.default_device("cpu"):
        got = to_numpy(FL.lfilter(taps, 1.0, x))
    want = ss.lfilter(taps, [1.0], x)
    assert np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6) < 5e-4

    z1 = float(r.uniform(-0.7, 0.7))
    if abs(z1) > 0.05 and n > 60:
        c0 = float(r.uniform(0.5, 3.0))
        with TF.default_device("cpu"):
            got = to_numpy(SP.symiirorder1(x.astype(np.float64), c0, z1))
        want = ss.symiirorder1(x.astype(np.float64), c0, z1)
        assert np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6) < 5e-4


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_shorttime_and_envelope(seed):
    """test_fuzz.py::test_fuzz_shorttime_and_envelope through the port."""
    import scipy.signal as ss
    from webgpufft_tpu_torch import ShortTimeFFT
    from webgpufft_tpu_torch import fftapi as TF
    r = np.random.default_rng(2000 + seed)
    n = int(r.integers(40, 300))
    x = r.standard_normal(n)

    m = int(r.integers(4, 24))
    hop = int(r.integers(1, m + 1))
    mfft = m + int(r.integers(0, 9))
    mode = r.choice(["onesided", "twosided", "centered"])
    with TF.default_device("cpu"):
        A = ShortTimeFFT(ss.windows.gaussian(m, m / 4), hop=hop, fs=5,
                         fft_mode=mode, mfft=mfft)
        B = ss.ShortTimeFFT(ss.windows.gaussian(m, m / 4), hop=hop, fs=5,
                            fft_mode=mode, mfft=mfft)
        S_g = TF.ascomplex(to_numpy(A.stft(x)))
        S_e = B.stft(x)
        scale = max(np.max(np.abs(S_e)), 1e-6)
        assert np.max(np.abs(S_g - S_e)) / scale < 5e-4, (m, hop, mfft, mode)
        if A.invertible:
            xr = to_numpy(A.istft(S_e.astype(np.complex64), k1=n))
            want = B.istft(S_e, k1=n)
            if mode == "onesided":
                assert np.max(np.abs(xr - want.real)) < 5e-4 * max(
                    np.max(np.abs(want.real)), 1e-6)

        bp0 = int(r.integers(-(n // 2), (n + 1) // 2 - 1))
        bp1 = int(r.integers(bp0 + 1, (n + 1) // 2 + 1))
        res = r.choice(["lowpass", "all"])
        got = to_numpy(TF.envelope(x, (bp0, bp1), residual=res))
    want = ss.envelope(x, (bp0, bp1), residual=res)
    scale = max(np.max(np.abs(want)), 1e-6)
    assert np.max(np.abs(got - want)) / scale < 1e-4, (bp0, bp1, res)


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_facade_nd_s_axes(seed):
    """test_fuzz.py::test_fuzz_facade_nd_s_axes: random s/axes combos
    (negatives, duplicates, -1 entries, over-long) through fftn / rfftn /
    ihfftn / dctn agree with numpy/scipy in value and in the kind of outcome
    (both compute or both raise), and with the JAX package at 1e-5."""
    import scipy.fft as sf
    from webgpufft_tpu import fftapi as F
    from webgpufft_tpu_torch import fftapi as TF
    from webgpufft_tpu_torch.spec import PlanError

    rng = np.random.default_rng(777000 + seed)
    nd = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(3, 12)) for _ in range(nd))
    x = rng.standard_normal(shape)
    z = x + 1j * rng.standard_normal(shape)
    if rng.random() < 0.25:
        axes = None
    else:
        k = int(rng.integers(1, nd + 2))
        axes = tuple(int(rng.integers(-nd, nd)) for _ in range(k))
    if rng.random() < 0.45:
        s = None
    else:
        base = len(axes) if axes is not None else nd
        slen = base if rng.random() < 0.8 else base + 1
        s = tuple(int(rng.choice([-1, 3, 4, 5])) for _ in range(slen))
    norm = [None, "ortho", "forward"][int(rng.integers(0, 3))]
    s_dct = None if s is None else tuple(abs(m) + 2 for m in s)
    cases = [
        ("fftn", (z,), dict(s=s), lambda: np.fft.fftn(z, s=s, axes=axes, norm=norm), True),
        ("rfftn", (x,), dict(s=s), lambda: np.fft.rfftn(x, s=s, axes=axes, norm=norm), True),
        ("ihfftn", (x,), dict(s=s), lambda: sf.ihfftn(x, s=s, axes=axes, norm=norm), True),
        ("dctn", (x,), dict(s=s_dct), lambda: sf.dctn(x, s=s_dct, axes=axes, norm=norm),
         False),
    ]
    for name, args, kw, ref, cplx in cases:
        label = (name, shape, axes, s, norm)
        try:
            want = ref()
            want_exc = False
        except Exception:  # noqa: BLE001
            want, want_exc = None, True
        try:
            with TF.default_device("cpu"):
                got = to_numpy(getattr(TF, name)(*args, axes=axes, norm=norm, **kw))
            got_exc = False
        except PlanError:
            got, got_exc = None, True
        assert got_exc == want_exc, (*label, "outcome-kind mismatch")
        if want_exc:
            continue
        jax_got = np.asarray(getattr(F, name)(*args, axes=axes, norm=norm, **kw))
        assert_close_c(got, jax_got, 1e-5, f"{label} port vs JAX")
        if cplx and np.iscomplexobj(want):
            got = got[..., 0] + 1j * got[..., 1]
        assert got.shape == np.shape(want), label
        scale = max(1.0, float(np.max(np.abs(want))))
        assert float(np.max(np.abs(got - want))) / scale < 5e-3, label


def test_chip_smoke_fuzz_phase_runs_on_the_cpu():
    """``chip_smoke.phase_fuzz``, the card's replay of the lanes above (its
    own copy of their draws), runs through on the CPU device: every draw
    within its bar, none failing."""
    summary = chip_smoke().phase_fuzz("cpu")
    assert summary["failures"] == 0 and summary["draws"] == 294
