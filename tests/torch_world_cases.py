"""Rank-side bodies of the distributed tests that are more than one builder
call (run through ``world.run("call", "torch_world_cases", name, ...)``).
Imports torch and the port only: the ranks never import JAX.  Each returns
numpy (or plain Python) from rank 0's point of view."""

from __future__ import annotations

import torch

from torch_world import Collectives, _mesh, _np


def shard_batch_c2c(x, axes):
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.parallel import shard_batch
    mesh = _mesh(axes)
    batch, n = x.shape[0], x.shape[1]
    plan = T.create_plan(type="c2c", shape=[n], batch=batch // mesh.size(0),
                         direction="forward", tuning={"impl": "xla"}, device="cpu")
    return _np(shard_batch(plan, mesh, "dp")(torch.from_numpy(x)))


def fft_roundtrip(x, n, axes):
    """Forward, then the backward-normalized inverse fed the flat forward
    output."""
    from webgpufft_tpu_torch.parallel import build_distributed_fft_1d
    mesh = _mesh(axes)
    b = x.shape[0]
    fwd = build_distributed_fft_1d(n, mesh, "dp", "forward")
    inv = build_distributed_fft_1d(n, mesh, "dp", "inverse", "backward")
    yf = fwd(torch.from_numpy(x)).full_tensor().reshape(b, n, 2)
    return _np(inv(yf).full_tensor().reshape(b, n, 2))


def axis0_then_local(x, shape, axes):
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.parallel import build_distributed_fft_axis0
    mesh = _mesh(axes)
    b = x.shape[0]
    fn0 = build_distributed_fft_axis0(tuple(shape), mesh, "dp", "forward")
    p1 = T.create_plan(type="c2c", shape=[shape[1]], batch=b * shape[0],
                       direction="forward", tuning={"impl": "xla"}, device="cpu")
    y0 = fn0(torch.from_numpy(x)).full_tensor().reshape(-1, shape[1], 2)
    return _np(p1(y0.contiguous()).reshape(b, *shape, 2))


def stft_collectives(n):
    """The collectives one distributed STFT makes (``Collectives.summary``)."""
    from webgpufft_tpu_torch.parallel import sharded
    mesh = _mesh({"sp": 8})
    _, _, fn = sharded.build_distributed_stft(n, mesh, "sp", nperseg=256,
                                              noverlap=192)
    with Collectives() as rec:
        fn(torch.zeros(1, n))
    return rec.summary()


def stft_istft_infer(x, n):
    from webgpufft_tpu_torch.parallel import (build_distributed_istft,
                                              build_distributed_stft)
    mesh = _mesh({"sp": 8})
    _, _, fn = build_distributed_stft(n, mesh, "sp", nperseg=128, noverlap=64,
                                      nfft=256)
    ifn = build_distributed_istft(n, mesh, "sp", nperseg=128, noverlap=64)
    return _np(ifn(fn(torch.from_numpy(x))))


def workspace_and_destroy():
    from webgpufft_tpu_torch.parallel import create_distributed_plan
    plan = create_distributed_plan(type="c2c", shape=[512], batch=8,
                                   mesh=_mesh({"sp": 8}), seq_axis="sp")
    ws = plan.get_workspace_size_bytes()
    plan.destroy()
    return ws, plan._fn is None


def plan_collectives(opts, axes, batch_axis, seq_axis):
    """The collectives of one exec of a distributed plan on zeros
    (``Collectives.summary``: counts by kind and the largest group any of
    them used)."""
    from webgpufft_tpu_torch.parallel import create_distributed_plan
    mesh = _mesh(axes)
    if mesh.get_coordinate() is None:
        return None
    plan = create_distributed_plan(dict(opts), mesh=mesh, batch_axis=batch_axis,
                                   seq_axis=seq_axis)
    spec = plan.spec
    x = torch.zeros(spec.batch, *spec.shape, 2)
    kw = {}
    if plan.needs_kernel:
        fc = spec.fft_conv
        ks = fc.kernel_shape if fc.kernel_shape is not None else spec.shape
        kw["kernel"] = torch.zeros(*ks, 2)
    with Collectives() as rec:
        plan(x, **kw)
    return rec.summary()


def bf16_vs_local(opts, axes, x):
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.parallel import create_distributed_plan
    mesh = _mesh(axes)
    if mesh.get_coordinate() is None:
        return None
    xb = torch.from_numpy(x).to(torch.bfloat16)
    dp = create_distributed_plan(dict(opts), mesh=mesh, seq_axis="sp")
    lp = T.create_plan(dict(opts), device="cpu", cache=T.PlanCache())
    got = dp(xb).full_tensor().float().numpy()
    want = lp.exec(xb).float().numpy()
    return got, want


def nufft_collectives(builder, args, kw, c):
    """The collectives of one distributed NUFFT call."""
    from webgpufft_tpu_torch.parallel import nufft as N
    fn = getattr(N, builder)(*args, _mesh({"sp": 8}), **kw)
    with Collectives() as rec:
        fn(torch.from_numpy(c))
    return rec.summary()


def nufft1_grad(x, n, ci):
    """d/dc sum(type1(c)**2), distributed and single-device."""
    from webgpufft_tpu_torch import fftapi, nufft
    from webgpufft_tpu_torch.parallel import build_distributed_nufft_type1
    fn = build_distributed_nufft_type1(x, n, _mesh({"sp": 8}))
    c = torch.from_numpy(ci).requires_grad_()
    g, = torch.autograd.grad((fn(c).full_tensor() ** 2).sum(), c)
    c2 = torch.from_numpy(ci).requires_grad_()
    with fftapi.default_device("cpu"):
        g2, = torch.autograd.grad((nufft.nufft1d1(x, c2, n) ** 2).sum(), c2)
    return g.numpy(), g2.numpy()


def nufft_tracked_points(builder, x):
    """A point tensor that requires grad is refused."""
    from webgpufft_tpu_torch.parallel import nufft as N
    xt = torch.from_numpy(x).requires_grad_()
    if builder == "build_distributed_nufft_type3":
        return N.build_distributed_nufft_type3(xt, x, _mesh({"sp": 8}))
    return getattr(N, builder)(xt, 16, _mesh({"sp": 8}))


def ns2d_run(w0, n, nu, dt, steps, axes, seq_axis):
    from webgpufft_tpu_torch.examples import navier_stokes2d as ns
    mesh = _mesh(axes)
    if mesh.get_coordinate() is None:
        return None
    return ns.run(w0, n, nu, dt, steps, mesh=mesh, seq_axis=seq_axis)


def ns3d_run(u0, n, nu, dt, steps, axes, seq_axis):
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    mesh = _mesh(axes)
    if mesh.get_coordinate() is None:
        return None
    return _np(ns.run3(u0, n, nu, dt, steps, mesh=mesh, seq_axis=seq_axis))


def example_run(name, **kw):
    """An example's ``run`` over the whole world (device "cpu")."""
    import importlib
    mod = importlib.import_module(f"webgpufft_tpu_torch.examples.{name}")
    return mod.run("cpu", verbose=False, **kw)


def ns_step_collectives(dim, n, axes, seq_axis):
    """The collectives of one distributed NS step (``dim`` 2 or 3) and the
    shape of the rank's spectral shard: the pointwise layer works on the
    shards, so only the transforms' exchanges run and nothing gathers."""
    import numpy as np
    from webgpufft_tpu_torch.examples import navier_stokes2d as ns2
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns3
    mesh = _mesh(axes)
    if mesh.get_coordinate() is None:
        return None
    if dim == 2:
        step, to_spectral, _ = ns2.make_stepper(n, 1e-2, 1e-2, mesh=mesh,
                                                seq_axis=seq_axis)
        u = torch.from_numpy(ns2.taylor_green(n, 0.0, 1e-2))
    else:
        step, to_spectral, _ = ns3.make_stepper3(n, 2e-2, 1e-2, mesh=mesh,
                                                 seq_axis=seq_axis)
        u = ns3.abc_flow(n, 0.0, 2e-2, device="cpu")
    u_hat = to_spectral(u)
    with Collectives() as rec:
        step(u_hat)
    return rec.summary(), tuple(np.shape(u_hat))
