"""DCT/DST 1-4: the JAX package against the PyTorch port (``device="cpu"``).

Every case of ``tests/test_dct.py`` under ``impl`` "auto" and "xla": the same
numpy input through both plans, outputs within 1e-5 * max|expected|, and
under "xla" equal route metadata.  On the CPU the port's kernel wrappers
run their plain torch versions, so the kernel-route cases check the glue
around K1/K2 and the reasons the plan records.
"""

import numpy as np
import pytest
import scipy.fft
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.utils import mathref as TR

from torch_port_support import run_both, same_route

ALL_KINDS = ["dct1", "dct2", "dct3", "dct4", "dst1", "dst2", "dst3", "dst4"]
IMPLS = ["auto", "xla"]


def _parity(opts, x, impl, assert_close, label):
    jplan, tplan, jy, ty = run_both(opts, x, impl=impl)
    assert ty.dtype == np.float32 and ty.shape == jy.shape
    assert_close(ty, jy, label=label)
    if impl == "xla":
        same_route(jplan, tplan)
    else:
        assert tplan.route.axis_kinds == jplan.route.axis_kinds
    return jplan, tplan, ty


def _opts(kind, shape, direction="forward", batch=2, normalize="none", **tuning):
    return {"type": kind, "shape": list(shape), "direction": direction, "batch": batch,
            "normalize": normalize, "tuning": tuning}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ALL_KINDS)
@pytest.mark.parametrize("shape", [(8,), (16,), (7,), (8, 8), (5, 12), (4, 3, 6)])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_dct_dst_all_types(kind, shape, direction, impl, rng, assert_close):
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    _, _, y = _parity(_opts(kind, shape, direction), x, impl, assert_close,
                      f"{kind}{shape}:{direction}")
    assert_close(y, TR.dct_nd(x, shape, kind, direction), label="vs numpy oracle")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind,stype,conv", [
    ("dct1", 1, 1.0), ("dst1", 1, 0.5), ("dct2", 2, 0.5), ("dct3", 3, 0.5), ("dct4", 4, 0.5),
    ("dst2", 2, 0.5), ("dst3", 3, 0.5), ("dst4", 4, 0.5),
])
def test_scaling_vs_scipy(kind, stype, conv, impl, rng, assert_close):
    """Types 2-4 and dst1 are scipy's unnormalized transforms / 2; dct1 is
    scipy's exactly."""
    n = 12 if stype == 1 else 16
    x = rng.standard_normal((1, n))
    fn = scipy.fft.dct if kind.startswith("dct") else scipy.fft.dst
    _, _, y = _parity(_opts(kind, (n,), batch=1), x.astype(np.float32), impl, assert_close,
                      f"{kind} vs jax")
    assert_close(y, fn(x, type=stype, norm=None) * conv, label=f"{kind} vs scipy")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["dct2", "dst2"])
def test_forward_inverse_aliasing(kind, impl, rng, assert_close):
    """kindN forward == kind(5-N) inverse up to the normalize factor."""
    x = rng.standard_normal((2, 10)).astype(np.float32)
    alias = {"dct2": "dct3", "dst2": "dst3"}[kind]
    _, _, y1 = _parity(_opts(kind, (10,), "forward"), x, impl, assert_close, kind)
    _, _, y2 = _parity(_opts(alias, (10,), "inverse"), x, impl, assert_close, alias)
    assert_close(y1, y2, label=f"{kind} fwd == {alias} inv")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("normalize", ["none", "backward", "unitary"])
def test_dct_normalize(normalize, impl, rng, assert_close):
    x = rng.standard_normal((2, 8, 8)).astype(np.float32)
    _parity(_opts("dct2", (8, 8), "inverse", normalize=normalize), x, impl, assert_close,
            f"dct2 {normalize}")


def test_dct2_roundtrip(rng, assert_close):
    """dct2 forward then dct2 inverse with backward normalize gives x / 2."""
    x = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    fwd = T.create_plan(_opts("dct2", (16,)), device="cpu")
    inv = T.create_plan(_opts("dct2", (16,), "inverse", normalize="backward"), device="cpu")
    assert_close(inv(fwd(x)).numpy(), x.numpy() / 2.0, label="dct2 roundtrip")


@pytest.mark.parametrize("impl", IMPLS)
def test_dct_8x8_blocks(impl, rng, assert_close):
    x = rng.standard_normal((64, 8, 8)).astype(np.float32)
    _, tplan, y = _parity(_opts("dct2", (8, 8), batch=64), x, impl, assert_close, "8x8 blocks")
    assert y.shape == (64, 8, 8)
    assert "dct-axis0-matmul" in tplan.route.reasons
    assert "dct-axis1-matmul" in tplan.route.reasons


# ---------------------------------------------------------------------------
# FFT route (forced low threshold to exercise it on small shapes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ALL_KINDS)
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("shape", [(16,), (12, 8), (5, 12), (4, 3, 6)])
def test_dct_fft_route(kind, shape, direction, impl, rng, assert_close):
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    _, tplan, y = _parity(_opts(kind, shape, direction, dct_fft_min_n=4), x, impl,
                          assert_close, f"fft-route {kind}{shape}:{direction}")
    assert any(r.endswith("-fft") for r in tplan.route.reasons), tplan.route.reasons
    assert_close(y, TR.dct_nd(x, shape, kind, direction), label="vs numpy oracle")


@pytest.mark.parametrize("impl", IMPLS)
def test_dct_fft_route_large_default(impl, rng, assert_close):
    """Axes >= 512 take the FFT route by default."""
    x = rng.standard_normal((1, 1024)).astype(np.float32)
    _, tplan, y = _parity(_opts("dct2", (1024,), batch=1), x, impl, assert_close, "dct2-1024")
    assert "dct-axis0-fft" in tplan.route.reasons
    assert_close(y, TR.dct_nd(x, (1024,), "dct2", "forward"), label="dct2-1024 vs numpy")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["dct1", "dct4", "dst1", "dst4"])
def test_trig14_fft_route_large_default(kind, impl, rng, assert_close):
    """Types 1 and 4 take the FFT embedding by default at large N, with no
    O(N^2) table; pinned against scipy in float64."""
    n = 4096
    x = rng.standard_normal((2, n)).astype(np.float32)
    _, tplan, y = _parity(_opts(kind, (n,)), x, impl, assert_close, f"{kind}-4096")
    assert "dct-axis0-fft" in tplan.route.reasons
    total = sum(v.numel() for v in tplan.consts.values())
    assert total < n * n // 4, total
    f = scipy.fft.dct if kind.startswith("dct") else scipy.fft.dst
    conv = 1.0 if kind == "dct1" else 0.5
    ref = f(x.astype(np.float64), type=int(kind[-1]), axis=-1) * conv
    assert_close(y, ref, label=f"{kind}-4096 vs scipy")


@pytest.mark.parametrize("kind,n,want", [
    ("dst1", 4096, "dct-axis0-fft-xla-bluestein"),     # 2(N+1) = 8194 = 2 * 17 * 241
    ("dct1", 4096, "dct-axis0-fft-xla"),               # 2(N-1) = 8190 = 2 * 3^2 * 5 * 7 * 13
    ("dct1", 32768, "dct-axis0-fft-xla-bluestein"),    # 65534 = 2 * 7 * 31 * 151
])
def test_type1_inner_axis_kind_is_recorded(kind, n, want):
    """dct1/dst1 work lengths 2(N-1), 2(N+1) are often not smooth at
    N = 2^k: the inner axis then runs Bluestein, and the plan says so."""
    plan = T.create_plan(_opts(kind, (n,)), device="cpu", cache=T.PlanCache())
    assert want in plan.route.reasons, plan.route.reasons


@pytest.mark.parametrize("kind", ["dct1", "dct4", "dst1", "dst4"])
def test_trig14_self_inverse_roundtrip(kind, rng, assert_close):
    n = 1024
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    fwd = T.create_plan(_opts(kind, (n,)), device="cpu")
    inv = T.create_plan(_opts(kind, (n,), "inverse", normalize="backward"), device="cpu")
    assert "dct-axis0-fft" in fwd.route.reasons
    resid = {"dct1": 2.0 * (n - 1) / n, "dct4": 0.5,
             "dst1": (n + 1) / (2.0 * n), "dst4": 0.5}[kind]
    assert_close(inv(fwd(x)).numpy(), x.numpy() * resid, label=f"{kind} roundtrip")


def test_giant_matmul_table_guarded():
    with pytest.raises(T.PlanError, match="trig table"):
        T.create_plan({"type": "dct4", "shape": [1 << 15],
                       "tuning": {"dct_fft_min_n": 1 << 20}}, device="cpu")
    p = T.create_plan({"type": "dct4", "shape": [1 << 15]}, device="cpu")
    assert "dct-axis0-fft" in p.route.reasons


# ---------------------------------------------------------------------------
# the inner FFT on the kernels (their plain versions here)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dct2", "dct3", "dst2", "dst3", "dct4", "dst4"])
@pytest.mark.parametrize("shape,batch,mode,want", [
    ((512, 16), 2, "pallas-mixed", ("dct-axis0-fft-xla", "dct-axis1-matmul")),
    ((16, 512), 2, "pallas-mixed", ("dct-axis0-matmul", "dct-axis1-fft-fused-lines")),
    ((16, 512, 64), 1, "pallas-mixed", ("dct-axis1-fft-fused-cols", "dct-axis2-matmul")),
    ((512,), 8, "pallas-fused", ("dct-axis0-fft-fused-lines",)),
])
def test_dct_inner_fft_on_the_kernels(kind, shape, batch, mode, want, rng, assert_close):
    x = rng.standard_normal((batch, *shape)).astype(np.float32)
    jplan, tplan, jy, ty = run_both(_opts(kind, shape, batch=batch), x)
    if kind in ("dct4", "dst4") and shape == (512, 16):
        # work length 1024 rides 16 lanes: 32 interleaved lanes, below K2's 128
        want = ("dct-axis0-fft-xla", "dct-axis1-matmul")
    for w in want:
        assert w in tplan.route.reasons, tplan.route.reasons
    if any("fused" in w for w in want):
        assert tplan.route.mode == mode, tplan.route.reasons
    assert_close(ty, jy, label=f"{kind}{shape}")


def test_dct_mid_axis_kernel_route_needs_128_lanes():
    """A mid axis of 512 with 64 riding reals is 128 interleaved lanes: K2.
    With 32 it stays on the einsum route."""
    p = T.create_plan(_opts("dct2", (512, 64)), device="cpu", cache=T.PlanCache())
    assert "dct-axis0-fft-fused-cols" in p.route.reasons
    p = T.create_plan(_opts("dct2", (512, 32)), device="cpu", cache=T.PlanCache())
    assert "dct-axis0-fft-xla" in p.route.reasons


def test_dct_bf16_storage_stays_off_the_kernels(rng):
    opts = {**_opts("dct2", (512,), batch=8), "precision": "bf16-storage"}
    x = (rng.standard_normal((8, 512)) * 0.5).astype(np.float32)
    jplan, tplan, jy, ty = run_both(opts, x)
    assert "dct-axis0-fft-xla" in tplan.route.reasons, tplan.route.reasons
    ref = TR.dct_nd(x, (512,), "dct2", "forward")
    assert np.max(np.abs(ty - ref)) / np.max(np.abs(ref)) < 3e-2


# ---------------------------------------------------------------------------
# tables carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,shape,tuning", [
    ("dct2", (8, 8), {}),                                   # trig{d}
    ("dct2", (12, 8), {"dct_fft_min_n": 4}),                # perm, wa, wb + dct{d}/f
    ("dst3", (12, 8), {"dct_fft_min_n": 4}),                # inv, xm, xm0, ua, ub + dct{d}/i
    ("dct4", (16,), {"dct_fft_min_n": 4}),                  # p_re .. t_im
    ("dst1", (16,), {"dct_fft_min_n": 4}),                  # Bluestein/Rader inner axis (34)
    ("dct1", (1024,), {}),                                  # Bluestein inner axis
])
def test_dct_runs_on_the_jax_tables(kind, shape, tuning, rng):
    opts = _opts(kind, shape, **tuning)
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    jplan, tplan, _, own = run_both(opts, x, impl="xla")
    tables = T.tables_from_reference(
        {k: np.array(v) for k, v in jplan._consts.items()}, "cpu")
    assert {k: v.dtype for k, v in tables.items()} == \
        {k: v.dtype for k, v in tplan.consts.items()}
    for name, t in tables.items():
        if name.rsplit("/", 1)[-1] in ("perm", "inv", "xm"):
            assert t.dtype == torch.int32, name
    got = tplan.load_consts(tables)(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, own)
    for name, t in tplan.consts.items():
        if name.rsplit("/", 1)[-1] in ("perm", "inv", "xm"):
            assert t.dtype == torch.int32, name


# ---------------------------------------------------------------------------
# staging on a DCT plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_dct_exec_offsets(impl, rng, assert_close):
    n, batch = 8, 2
    flat = rng.standard_normal(40).astype(np.float32)
    out = np.full(40, 7.5, np.float32)
    _, tplan, jy, ty = run_both(_opts("dct2", (n,)), flat, impl=impl, out=out,
                                input_offset_elements=3, output_offset_elements=4)
    assert tplan.supports_exec_offsets
    assert_close(ty, jy, label="dct exec offsets")
    ref = TR.dct_nd(flat[3:3 + batch * n].reshape(batch, n), (n,), "dct2", "forward")
    assert_close(ty[4:4 + batch * n].reshape(batch, n), ref, label="dct exec offsets vs numpy")
    assert np.all(ty[:4] == 7.5) and np.all(ty[4 + batch * n:] == 7.5)
