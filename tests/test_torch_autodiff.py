"""Autodiff through the PyTorch port's plans, against the JAX package.

The same numpy inputs, made from a seed, go through ``jax.grad`` /
``jax.jvp`` / ``jax.vjp`` of the JAX plan and ``torch.autograd.grad`` /
``torch.func.jvp`` / ``vjp`` / ``vmap`` of the port's CPU plan.  Tolerance:
max|actual - expected| <= 1e-5 * max|expected| (3e-2 for bf16-storage plans,
as for their forward).  The JAX plan runs its einsum route (``impl: "xla"``:
a gradient does not depend on the route); the port's plan runs under
``impl: "auto"``, where K1/K2-eligible passes go through the kernels'
``torch.autograd.Function``s (whose CPU forward and backward are the plain
versions with the hand-written adjoint rule), and under ``impl: "xla"``.

The ``Function``s' hand-written ``backward`` and ``jvp`` are also held
against torch's own autograd through the plain versions called directly.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import webgpufft_tpu as W
import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.core import fused, fused_cols, radix
from webgpufft_tpu_torch.examples import navier_stokes3d as tns

TOL = 1e-5
BF16_TOL = 3e-2
IMPLS = ("auto", "xla")


def _plans(opts, impl):
    jopts = dict(opts, tuning={**(opts.get("tuning") or {}), "impl": "xla"})
    topts = dict(opts, tuning={**(opts.get("tuning") or {}), "impl": impl})
    return (W.create_plan(jopts, cache=W.PlanCache()),
            T.create_plan(topts, device="cpu", cache=T.PlanCache()))


def _input_for(tplan, rng):
    """A numpy input of the port plan's expected shape (a flat buffer of the
    least length for a strided side)."""
    shape = tplan.input_shape
    if tuple(shape) == (None,):
        shape = (tplan._in_need, 2) if tplan.input_interleaved else (tplan._in_need,)
    return rng.standard_normal(tuple(shape)).astype(np.float32)


def _grads(opts, impl, rng, kernel=None, x=None):
    """(jax grads, torch grads, plans) of sum(w * plan(x[, kernel])) with
    respect to x (and the kernel), w a seeded cotangent of the output's
    shape."""
    jplan, tplan = _plans(opts, impl)
    bf16 = tplan.spec.precision == "bf16-storage"
    if x is None:
        x = _input_for(tplan, rng)
    tx = torch.from_numpy(x)
    tx = (tx.to(torch.bfloat16) if bf16 else tx).requires_grad_()
    targs = [tx]
    kw = {}
    if kernel is not None:
        tk = torch.from_numpy(kernel).requires_grad_()
        kw["kernel"] = tk
        targs.append(tk)
    ty = tplan(tx, **kw)
    assert ty.requires_grad and ty.grad_fn is not None
    w = rng.standard_normal(tuple(ty.shape)).astype(np.float32)
    tg = torch.autograd.grad((ty.float() * torch.from_numpy(w)).sum(), targs)

    jx = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    jw = jnp.asarray(w)
    if kernel is None:
        jg = (jax.grad(lambda v: jnp.sum(jw * jplan.exec(v).astype(jnp.float32)))(jx),)
    else:
        jg = jax.grad(lambda v, k: jnp.sum(jw * jplan.exec(v, kernel=k)),
                      argnums=(0, 1))(jx, jnp.asarray(kernel))
    return ([np.asarray(g.astype(jnp.float32)) for g in jg],
            [g.float().numpy() for g in tg], (jplan, tplan))


def _check(opts, impl, rng, assert_close, kernel=None, tol=TOL, x=None):
    jg, tg, plans = _grads(opts, impl, rng, kernel=kernel, x=x)
    for name, a, b in zip(("input", "kernel"), tg, jg):
        assert_close(a, b, atol_scale=tol, label=f"grad wrt {name}")
    return plans


# ---------------------------------------------------------------------------
# c2c: every axis kind, direction and normalize
# ---------------------------------------------------------------------------

C2C_CASES = [
    ([1024], 8, {}),                                  # K1, 32 x 32
    ([2048], 8, {}),                                  # K1, non-square split
    ([360], 8, {}),                                   # K1, odd radices
    ([8192], 8, {}),                                  # K1, 64 x 128
    ([8192], 2, {"fourStepMinN": 4096}),              # four-step (lines < 8)
    ([4093], 2, {}),                                  # Rader
    ([4099], 2, {}),                                  # Bluestein
    ([16, 256], 2, {}),                               # K2 + K1
    ([8, 16, 64], 2, {}),                             # K2, K2, K1
    ([6, 10], 3, {}),                                 # einsum axes only
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("direction,normalize", [
    ("forward", "none"), ("inverse", "backward"), ("forward", "unitary"),
    ("inverse", "none")])
@pytest.mark.parametrize("shape,batch,tuning", C2C_CASES,
                         ids=[f"{'x'.join(map(str, s))}b{b}{'fs' if t else ''}"
                              for s, b, t in C2C_CASES])
def test_grad_c2c(shape, batch, tuning, direction, normalize, impl, rng, assert_close):
    opts = {"type": "c2c", "shape": shape, "batch": batch, "direction": direction,
            "normalize": normalize, "tuning": tuning}
    _, tplan = _check(opts, impl, rng, assert_close)
    if impl == "auto" and shape in ([1024], [2048], [360], [16, 256], [8, 16, 64]):
        assert tplan.route.mode == "pallas-fused", tplan.route


@pytest.mark.parametrize("impl", IMPLS)
def test_grad_c2c_forward_normalize_backward(impl, rng, assert_close):
    _check({"type": "c2c", "shape": [64], "batch": 8, "direction": "forward",
            "normalize": "backward"}, impl, rng, assert_close)


# ---------------------------------------------------------------------------
# r2c / c2r
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("normalize", ["none", "backward", "unitary"])
@pytest.mark.parametrize("kind", ["r2c", "c2r"])
@pytest.mark.parametrize("shape,batch", [([40], 2), ([17], 3), ([9, 4], 2), ([16, 6], 2),
                                         ([16, 8, 64], 2), ([512], 8)])
def test_grad_real(shape, batch, kind, normalize, impl, rng, assert_close):
    opts = {"type": kind, "shape": shape, "batch": batch, "normalize": normalize,
            "direction": "forward" if kind == "r2c" else "inverse"}
    _check(opts, impl, rng, assert_close)


# ---------------------------------------------------------------------------
# DCT / DST 1-4 on the matmul and FFT routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("kind", ["dct1", "dct2", "dct3", "dct4",
                                  "dst1", "dst2", "dst3", "dst4"])
@pytest.mark.parametrize("shape,batch,tuning", [
    ([8, 8], 4, {}),                        # matmul route
    ([64], 8, {"dctFftMinN": 16}),          # FFT route, last axis (K1 where it splits)
    ([16, 128], 2, {"dctFftMinN": 16}),     # FFT route on a mid axis (K2) and the last
], ids=["matmul8x8", "fft64", "fft16x128"])
def test_grad_dct(shape, batch, tuning, kind, direction, impl, rng, assert_close):
    opts = {"type": kind, "shape": shape, "batch": batch, "direction": direction,
            "normalize": "unitary", "tuning": tuning}
    _check(opts, impl, rng, assert_close)


# ---------------------------------------------------------------------------
# fftconv (kernel and input), conv2d
# ---------------------------------------------------------------------------

def _c(rng, *shape):
    return rng.standard_normal((*shape, 2)).astype(np.float32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", ["convolution", "correlation"])
@pytest.mark.parametrize("boundary", ["circular", "linear-full", "linear-same",
                                      "linear-valid"])
def test_grad_fftconv_boundaries(boundary, mode, impl, rng, assert_close):
    opts = {"type": "fftconv", "shape": [64], "batch": 8,
            "fftConv": {"boundary": boundary, "kernelShape": [9], "mode": mode}}
    _check(opts, impl, rng, assert_close, kernel=_c(rng, 1, 9))


@pytest.mark.parametrize("impl", IMPLS)
def test_grad_fftconv_2d_multikernel(impl, rng, assert_close):
    opts = {"type": "fftconv", "shape": [12, 60], "batch": 2,
            "fftConv": {"boundary": "linear-same", "kernelShape": [3, 5], "kernelCount": 2}}
    _check(opts, impl, rng, assert_close, kernel=_c(rng, 2, 3, 5))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("boundary", ["circular", "linear-full"])
def test_grad_fftconv_overlap_save(boundary, impl, rng, assert_close):
    opts = {"type": "fftconv", "shape": [512], "batch": 2,
            "fftConv": {"boundary": boundary, "kernelShape": [9],
                        "tuning": {"overlapSave": "on", "overlapBlock": 64}}}
    _, tplan = _check(opts, impl, rng, assert_close, kernel=_c(rng, 9))
    assert tplan.route.mode == "overlap-save"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("preset_name", ["create_fftconv_kernel_major_channel_lane_preset",
                                         "create_fftconv_batch_major_channel_lane_preset"])
def test_grad_fftconv_channel_lane_preset(preset_name, impl, rng, assert_close):
    preset = getattr(T, preset_name)({
        "shape": [8], "batch": 2, "kernelCount": 2,
        "input": {"channels": 2, "channelIndex": 1},
        "output": {"channels": 4, "channelIndex": 0, "kernelStepChannels": 2}})
    x = _c(rng, 2 * 2 * 8)
    _check({"type": "fftconv", **preset}, impl, rng, assert_close, kernel=_c(rng, 2, 8), x=x)


def test_grad_fftconv_kernel_closed_form(rng, assert_close):
    """d/dk sum((x conv k)_full) has re = sum(x_re) + sum(x_im) and
    im = sum(x_re) - sum(x_im) in every tap."""
    n, kn, b = 64, 9, 2
    plan = T.create_plan(type="fftconv", shape=[n], batch=b, device="cpu",
                         fftConv={"boundary": "linear-full", "kernelShape": [kn]},
                         cache=T.PlanCache())
    x = torch.from_numpy(_c(rng, b, n))
    k = torch.from_numpy(_c(rng, 1, kn)).requires_grad_()
    g, = torch.autograd.grad(plan(x, kernel=k).sum(), k)
    sx = x.sum(dim=(0, 1)).numpy()
    want = np.empty((1, kn, 2), np.float32)
    want[..., 0], want[..., 1] = sx[0] + sx[1], sx[0] - sx[1]
    assert_close(g.numpy(), want, label="conv kernel grad")


@pytest.mark.parametrize("ktype,complex_data", [("real", False), ("real", True),
                                                ("complex", True)])
@pytest.mark.parametrize("padding", ["same", "valid"])
def test_grad_conv2d(ktype, complex_data, padding, rng, assert_close):
    opts = {"type": "conv2d", "shape": [8, 10], "batch": 2,
            "conv": {"kernelSize": 3, "padding": padding, "kernelType": ktype}}
    jplan, tplan = _plans(opts, "auto")
    x = rng.standard_normal((2, *tplan.in_shape) + ((2,) if complex_data else ())
                            ).astype(np.float32)
    k = rng.standard_normal((3, 3) + ((2,) if ktype == "complex" else ())).astype(np.float32)
    _check(opts, "auto", rng, assert_close, kernel=k, x=x)


def test_conv2d_backward_and_jvp_ignore_the_tf32_flag(rng):
    """The backward and forward-mode convolutions run under the plan's own
    cuDNN scope: the caller's flag is what it was, before and after."""
    plan = T.create_plan({"type": "conv2d", "shape": [8, 8], "batch": 1,
                          "conv": {"kernelSize": 3}}, device="cpu", cache=T.PlanCache())
    x = torch.from_numpy(rng.standard_normal((1, *plan.in_shape)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3)).astype(np.float32)).requires_grad_()
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        g, = torch.autograd.grad(plan(x, kernel=k).sum(), k)
        _, t = torch.func.jvp(lambda kk: plan(x, kernel=kk), (k.detach(),),
                              (torch.ones(3, 3),))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = was
    xd = x.double()
    pt, pb, pl, pr = plan.pad
    xp = torch.nn.functional.pad(xd, (pl, pr, pt, pb))
    want = torch.stack([torch.stack([xp[0, i:i + 8, j:j + 8].sum() for j in range(3)])
                        for i in range(3)])
    assert float((g.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((t.double().sum() - want.sum()).abs()) <= 1e-5 * float(want.abs().sum())


# ---------------------------------------------------------------------------
# staging: layout, ioView, zeroPad, bf16-storage
# ---------------------------------------------------------------------------

STAGING = {
    "strided-input": {"layout": {"inputStrides": [2], "inputOffsetElements": 3,
                                 "inputBatchStrideElements": 140}},
    "strided-output": {"layout": {"outputStrides": [3], "outputOffsetElements": 1}},
    "whdcn-output": {"layout": {"whdcn": {"output": {"channels": 3, "channelIndex": 1}}}},
    "ioview-input": {"ioView": {"input": {"shape": [40], "offset": [5]}}},
    "ioview-output": {"ioView": {"output": {"shape": [80], "offset": [-10]}}},
    "zeropad-read": {"zeroPad": {"read": {"start": [4], "end": [50]}}},
    "zeropad-write": {"zeroPad": {"write": {"start": [0], "end": [33]}}},
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["c2c", "r2c", "dct2"])
@pytest.mark.parametrize("name", sorted(STAGING))
def test_grad_staging(name, kind, impl, rng, assert_close):
    opts = {"type": kind, "shape": [64], "batch": 8, "normalize": "unitary", **STAGING[name]}
    _check(opts, impl, rng, assert_close)


@pytest.mark.parametrize("opts", [
    {"type": "c2c", "shape": [64], "batch": 8, "normalize": "unitary"},
    {"type": "r2c", "shape": [16, 64], "batch": 2},
    {"type": "dct2", "shape": [16, 16], "batch": 2, "normalize": "unitary"},
], ids=["c2c", "r2c", "dct2"])
def test_grad_bf16_storage(opts, rng, assert_close):
    _check({**opts, "precision": "bf16-storage"}, "auto", rng, assert_close, tol=BF16_TOL)


def test_out_and_inplace_edges(rng):
    """``out=`` that requires grad raises ``PlanError``; a gradient still
    flows from x into a plain ``out=``; ``inPlace`` on a leaf that requires
    grad raises torch's own in-place error."""
    opts = {"type": "c2c", "shape": [64], "batch": 8,
            "ioView": {"output": {"shape": [80], "offset": [-10]}}}
    plan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    x = torch.from_numpy(_c(rng, 8, 64)).requires_grad_()
    with pytest.raises(T.PlanError, match="out="):
        plan(x, out=torch.zeros(8, 80, 2, requires_grad=True))
    out = torch.full((8, 80, 2), 7.5)
    y = plan(x, out=out)
    assert y is out and y.requires_grad
    g, = torch.autograd.grad(y.sum(), x)
    ref, = torch.autograd.grad(plan(x).sum(), x)
    assert torch.equal(g, ref)
    inplace = T.create_plan({"type": "c2c", "shape": [64], "batch": 8, "inPlace": True},
                            device="cpu", cache=T.PlanCache())
    with pytest.raises(RuntimeError):
        inplace(x)
    z = x * 1.0                                   # a non-leaf may be overwritten
    assert inplace(z) is z


# ---------------------------------------------------------------------------
# the counterparts of the JAX package's own autodiff tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,b", [(32, 4), (1024, 8)])
def test_grad_plan_c2c_parseval(n, b, rng, assert_close):
    """d/dx sum|F x|^2 = 2 n x (forward, normalize='none'), by
    ``torch.autograd.grad`` and by ``torch.func.grad``."""
    plan = T.create_plan(type="c2c", shape=[n], batch=b, device="cpu", cache=T.PlanCache())
    x = torch.from_numpy(_c(rng, b, n))

    def loss(v):
        return plan(v).pow(2).sum()

    g, = torch.autograd.grad(loss(x.requires_grad_()), x)
    assert_close(g.numpy(), 2.0 * n * x.detach().numpy(), label="c2c grad")
    gf = torch.func.grad(loss)(x.detach())
    assert_close(gf.numpy(), g.numpy(), atol_scale=1e-6, label="func.grad")


@pytest.mark.parametrize("n,b", [(24, 3), (256, 8)])
def test_grad_plan_roundtrip_identity(n, b, rng, assert_close):
    """grad of sum(w * ifft(fft(x))) through two plans is exactly w."""
    fwd = T.create_plan(type="c2c", shape=[n], batch=b, normalize="unitary", device="cpu")
    inv = T.create_plan(type="c2c", shape=[n], batch=b, normalize="unitary",
                        direction="inverse", device="cpu")
    x = torch.from_numpy(_c(rng, b, n)).requires_grad_()
    w = torch.from_numpy(_c(rng, b, n))
    g, = torch.autograd.grad((w * inv(fwd(x))).sum(), x)
    assert_close(g.numpy(), w.numpy(), label="roundtrip grad")


@pytest.mark.parametrize("opts", [
    {"type": "r2c", "shape": [40], "batch": 2},
    {"type": "r2c", "shape": [16, 8, 64], "batch": 2},
    {"type": "c2c", "shape": [1024], "batch": 8},
    {"type": "dct2", "shape": [64], "batch": 8, "tuning": {"dctFftMinN": 16}},
], ids=["r2c40", "r2c3d", "c2c1024", "dct2fft"])
def test_jvp_linearity(opts, rng, assert_close):
    """Transforms are linear: jvp(f, x, v) == f(v), and equals jax.jvp."""
    jplan, tplan = _plans(opts, "auto")
    x, v = _input_for(tplan, rng), _input_for(tplan, rng)
    y, t = torch.func.jvp(lambda a: tplan(a), (torch.from_numpy(x),), (torch.from_numpy(v),))
    assert_close(t.numpy(), tplan(torch.from_numpy(v)).numpy(), atol_scale=1e-6,
                 label="jvp == apply")
    _, jt = jax.jvp(lambda a: jplan.exec(a), (jnp.asarray(x),), (jnp.asarray(v),))
    assert_close(t.numpy(), np.asarray(jt), label="jvp == jax.jvp")


@pytest.mark.parametrize("opts", [
    {"type": "c2c", "shape": [16], "batch": 2},
    {"type": "c2c", "shape": [16, 256], "batch": 2, "normalize": "unitary"},
    {"type": "c2r", "shape": [16, 8, 64], "batch": 2, "direction": "inverse"},
], ids=["c2c16", "c2c2d", "c2r3d"])
def test_vjp_adjoint_inner_product(opts, rng, assert_close):
    """<f(x), u> == <x, vjp(u)>, and the vjp equals jax.vjp's."""
    jplan, tplan = _plans(opts, "auto")
    x = _input_for(tplan, rng)
    y, vjp_fn = torch.func.vjp(lambda a: tplan(a), torch.from_numpy(x))
    u = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    xt, = vjp_fn(torch.from_numpy(u))
    lhs = float((y.double() * torch.from_numpy(u).double()).sum())
    rhs = float((torch.from_numpy(x).double() * xt.double()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), 1e-12) < 1e-5
    _, jvjp = jax.vjp(lambda a: jplan.exec(a), jnp.asarray(x))
    assert_close(xt.numpy(), np.asarray(jvjp(jnp.asarray(u))[0]), label="vjp == jax.vjp")


@pytest.mark.parametrize("shape,k", [([32], 6), ([1024], 16), ([8, 256], 4)])
def test_vmap_plan_exec(shape, k, rng, assert_close):
    """vmap over an extra leading dim == the same plan at a wider batch."""
    p1 = T.create_plan(type="c2c", shape=shape, batch=1, device="cpu", cache=T.PlanCache())
    pk = T.create_plan(type="c2c", shape=shape, batch=k, device="cpu", cache=T.PlanCache())
    x = torch.from_numpy(_c(rng, k, 1, *shape))
    y = torch.func.vmap(lambda xi: p1(xi))(x)
    ref = pk(x.reshape(k, *shape, 2))
    assert_close(y.reshape(k, *shape, 2).numpy(), ref.numpy(), atol_scale=1e-6,
                 label="vmap == batch")


def test_vmap_of_grad_through_kernel_passes(rng, assert_close):
    """Per-sample gradients: vmap(grad(loss)) through a K1/K2-routed plan
    equals the gradients taken one sample at a time."""
    plan = T.create_plan(type="c2c", shape=[8, 256], batch=8, device="cpu",
                         cache=T.PlanCache())
    assert plan.route.mode == "pallas-fused"
    xs = torch.from_numpy(_c(rng, 3, 8, 8, 256))
    w = torch.from_numpy(_c(rng, 8, 8, 256))

    def loss(v):
        return (w * plan(v)).pow(2).sum()

    got = torch.func.vmap(torch.func.grad(loss))(xs)
    for i in range(3):
        assert_close(got[i].numpy(), torch.func.grad(loss)(xs[i]).numpy(),
                     atol_scale=1e-6, label=f"sample {i}")


def test_ns3d_step_gradient_adjoint_identity(rng):
    """Reverse mode through one Navier-Stokes step (r2c b3 + c2r b6 plans,
    twice) against forward mode: <J v, u> == <v, J^T u>."""
    n = 16
    step, to_spectral, _ = tns.make_stepper3(n, 2e-2, 1e-2, device="cpu")
    u_hat = to_spectral(torch.from_numpy(
        0.1 * rng.standard_normal((3, n, n, n)).astype(np.float32)))
    v = torch.from_numpy(rng.standard_normal(tuple(u_hat.shape)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal(tuple(u_hat.shape)).astype(np.float32))
    _, jv = torch.func.jvp(step, (u_hat,), (v,))
    _, vjp_fn = torch.func.vjp(step, u_hat)
    jtu, = vjp_fn(u)
    lhs, rhs = float((jv.double() * u.double()).sum()), float((v.double() * jtu.double()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), 1e-12) < 1e-4


# ---------------------------------------------------------------------------
# the kernels' Functions against autograd through the plain versions
# ---------------------------------------------------------------------------

def _tables(consts):
    return {k.rsplit("/", 1)[1]: torch.as_tensor(v) for k, v in consts.items()}


def _scale(n, direction, normalize):
    return {"none": 1.0, "unitary": 1.0 / math.sqrt(n),
            "backward": 1.0 / n if direction == "inverse" else 1.0}[normalize]


K1_SHAPES = [(1024, 8), (2048, 8), (360, 9), (8192, 8), (2310, 8), (16, 37), (6, 11)]
K2_SHAPES = [(3, 256, 128), (2, 128, 130), (2, 1024, 128), (2, 360, 128), (4, 16, 128),
             (4, 13, 128)]


@pytest.mark.parametrize("direction,normalize", [("forward", "none"), ("inverse", "backward"),
                                                 ("forward", "unitary")])
@pytest.mark.parametrize("n,lines", K1_SHAPES)
def test_fused_lines_function_rules(n, lines, direction, normalize, rng, assert_close):
    """``FusedLines``: backward == autograd through ``fused_lines_reference``;
    the adjoint switch == that backward; jvp == the pass on the tangent;
    <K x, u> == <x, K^H u>; and the pass-schedule model's adjoint agrees."""
    t = _tables(fused.lines_consts(n, direction, _scale(n, direction, normalize), "p"))
    x = torch.from_numpy(_c(rng, lines, n))
    u = torch.from_numpy(_c(rng, lines, n))
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad((fused.fused_lines_reference(xr, t) * u).sum(), xr)
    xf = x.clone().requires_grad_()
    y = fused.fused_lines(xf, t)
    assert isinstance(y.grad_fn, torch.autograd.function.BackwardCFunction)
    got, = torch.autograd.grad((y * u).sum(), xf)
    assert_close(got.numpy(), want.numpy(), label="backward")
    assert_close(fused.fused_lines(u, t, adjoint=True).numpy(), want.numpy(), label="adjoint")
    assert_close(fused.fused_lines_chain_reference(u, t, adjoint=True).numpy(), want.numpy(),
                 label="pass-schedule adjoint")
    _, tang = torch.func.jvp(lambda a: fused.fused_lines(a, t), (x,), (u,))
    assert_close(tang.numpy(), fused.fused_lines_reference(u, t).numpy(), atol_scale=1e-6,
                 label="jvp")
    lhs = float((y.detach().double() * u.double()).sum())
    rhs = float((x.double() * got.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1e-12)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("pre,h,lanes", K2_SHAPES)
def test_fused_cols_function_rules(pre, h, lanes, direction, rng, assert_close):
    t = _tables(fused_cols.cols_consts(h, direction, 1.0 / math.sqrt(h), "p"))
    x = torch.from_numpy(rng.standard_normal((pre, h, lanes)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((pre, h, lanes)).astype(np.float32))
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad((fused_cols.fused_cols_reference(xr, t) * u).sum(), xr)
    xf = x.clone().requires_grad_()
    y = fused_cols.fused_cols(xf, t)
    assert isinstance(y.grad_fn, torch.autograd.function.BackwardCFunction)
    got, = torch.autograd.grad((y * u).sum(), xf)
    assert_close(got.numpy(), want.numpy(), label="backward")
    assert_close(fused_cols.fused_cols(u, t, adjoint=True).numpy(), want.numpy(),
                 label="adjoint")
    assert_close(fused_cols.fused_cols_chain_reference(u, t, adjoint=True).numpy(),
                 want.numpy(), label="pass-schedule adjoint")
    _, tang = torch.func.jvp(lambda a: fused_cols.fused_cols(a, t), (x,), (u,))
    assert_close(tang.numpy(), fused_cols.fused_cols_reference(u, t).numpy(), atol_scale=1e-6,
                 label="jvp")
    lhs = float((y.detach().double() * u.double()).sum())
    rhs = float((x.double() * got.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1e-12)


@pytest.mark.parametrize("which", ["lines", "cols"])
def test_function_double_backward_and_noncontiguous_grad(which, rng, assert_close):
    """grad of a grad (the backward is the Function again), a JVP of a VJP,
    and a non-contiguous incoming gradient (an expanded ``sum()`` cotangent,
    a transposed one)."""
    if which == "lines":
        t = _tables(fused.lines_consts(64, "forward", 0.125, "p"))
        f, ref, shape = fused.fused_lines, fused.fused_lines_reference, (8, 64, 2)
    else:
        t = _tables(fused_cols.cols_consts(16, "forward", 0.25, "p"))
        f, ref, shape = fused_cols.fused_cols, fused_cols.fused_cols_reference, (2, 16, 128)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def second(fn):
        a = x.clone().requires_grad_()
        g, = torch.autograd.grad(fn(a, t).pow(2).sum(), a, create_graph=True)
        gg, = torch.autograd.grad(g.pow(3).sum(), a)
        return gg

    assert_close(second(f).numpy(), second(ref).numpy(), label="double backward")
    a = x.clone().requires_grad_()
    g, = torch.autograd.grad(f(a, t).sum(), a)            # expanded ones cotangent
    b = x.clone().requires_grad_()
    gr, = torch.autograd.grad(ref(b, t).sum(), b)
    assert_close(g.numpy(), gr.numpy(), label="expanded cotangent")
    w = torch.from_numpy(rng.standard_normal(shape[::-1]).astype(np.float32)).permute(2, 1, 0)
    assert not w.is_contiguous()
    g, = torch.autograd.grad(f(a, t), a, grad_outputs=w)
    gr, = torch.autograd.grad(ref(b, t), b, grad_outputs=w)
    assert_close(g.numpy(), gr.numpy(), label="non-contiguous cotangent")
    # forward over reverse
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    _, t1 = torch.func.jvp(torch.func.grad(lambda v: f(v, t).pow(2).sum()), (x,), (u,))
    _, t2 = torch.func.jvp(torch.func.grad(lambda v: ref(v, t).pow(2).sum()), (x,), (u,))
    assert_close(t1.numpy(), t2.numpy(), label="jvp of grad")


def test_untracked_calls_skip_the_function(rng):
    """Without grad, forward mode or a ``torch.func`` transform the wrappers
    run the pass directly (no graph node); any of them goes through the
    ``Function``."""
    t = _tables(fused.lines_consts(64, "forward", 1.0, "p"))
    x = torch.from_numpy(_c(rng, 8, 64))
    assert not radix.tracked(x) and fused.fused_lines(x, t).grad_fn is None
    assert radix.tracked(x.clone().requires_grad_())
    with torch.no_grad():
        assert not radix.tracked(x.clone().requires_grad_())
    seen = []
    torch.func.vmap(lambda v: seen.append(radix.tracked(v)) or v)(x)
    with torch.autograd.forward_ad.dual_level():
        seen.append(radix.tracked(x))
    assert seen == [True, True]
