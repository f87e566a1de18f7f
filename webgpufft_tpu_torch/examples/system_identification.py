"""Training through the port: gradient-based system identification (a
learned deconvolution kernel) through the fftconv plan, on one device and
over a mesh.

Port of ``examples/system_identification.py``.  An unknown FIR system
k_true filters known probe signals,

    y = conv(x, k_true) + noise          (boundary "linear-same"),

and k_true is recovered by minimizing L(k) = mean((conv(x, k) - y)^2) with
``torch.optim.Adam`` (as ``optax.adam``: eps 1e-8 added to sqrt(v_hat)),
differentiating straight through the plan: every step runs the plan
forward (K1 on the card) and its backward, whose kernel passes are the
kernels' adjoint launches.  The loop is a Python loop.  With ``mesh`` the
same step runs batch-parallel over ``dp`` and sequence-parallel over
``sp`` (``create_distributed_plan``); the loss is taken shard by shard on
DTensors, so no output is gathered.

    python -m webgpufft_tpu_torch.examples.system_identification            # on the card
    python -m webgpufft_tpu_torch.examples.system_identification --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import create_plan


def make_problem(n: int, klen: int, batch: int, noise: float, seed: int = 0):
    """Probe signals x (batch, n), smooth FIR k_true (klen,), and the
    observation noise (batch, n), all numpy float32."""
    rng = np.random.default_rng(seed)
    t = np.linspace(-2.5, 2.5, klen)
    k_true = (np.exp(-t * t) * np.cos(3.0 * t)).astype(np.float32)
    k_true /= np.abs(k_true).sum()
    x = rng.standard_normal((batch, n)).astype(np.float32)
    return x, k_true, rng.standard_normal((batch, n)).astype(np.float32) \
        * noise


def fit(model, x, y, k0, steps: int, lr: float):
    """``steps`` Adam iterations on mean((model(k, x) - y)^2) from ``k0``;
    returns (k_hat, losses) as tensors (each loss taken before its step)."""
    from torch.distributed.tensor import DTensor
    k = k0.detach().clone().requires_grad_()
    opt = torch.optim.Adam([k], lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((model(k, x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        loss = loss.detach()
        losses.append(loss.full_tensor() if isinstance(loss, DTensor) else loss)
    return k.detach(), torch.stack(losses)


def _like(t, ref):
    """A tensor every rank holds, laid out as the DTensor ``ref`` (its
    shard cut locally, no collective)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, ref.placements)


def make_model(n: int, klen: int, batch: int, *, mesh=None, device="cuda"):
    """(model, device): ``model(k, xi)`` is the real part of the fftconv
    plan's output for the real kernel ``k`` (klen,) on the interleaved
    probes ``xi`` (batch, n, 2); over ``mesh`` a DTensor."""
    conv = {"type": "fftconv", "shape": [n], "batch": batch,
            "fftConv": {"boundary": "linear-same", "kernelShape": [klen]}}
    if mesh is not None:
        from ..parallel import create_distributed_plan
        from ..parallel.sharded import mesh_device
        plan = create_distributed_plan(conv, mesh=mesh, batch_axis="dp", seq_axis="sp")
        device = mesh_device(mesh)
    else:
        plan = create_plan(conv, device=device)
        device = plan.device

    def model(k, xi):
        return plan(xi, kernel=torch.stack([k, torch.zeros_like(k)], -1))[..., 0]
    model.plan = plan
    return model, device


def make_trainer(n: int, klen: int, batch: int, steps: int, lr: float, *,
                 mesh=None, device="cuda"):
    """fit(x, y, k0) -> (k_hat, losses): ``steps`` Adam iterations through
    the plan on ``device`` (or over ``mesh``: dp x sp)."""
    model, dev = make_model(n, klen, batch, mesh=mesh, device=device)

    def trainer(x, y, k0):
        x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        xi = torch.stack([x, torch.zeros_like(x)], -1)
        if mesh is not None:
            y = _like(y, model(torch.as_tensor(k0, device=dev), xi))
        return fit(model, xi, y, torch.as_tensor(k0, device=dev), steps, lr)
    trainer.model = model
    return trainer


def observations(x, k_true, eps):
    """y from the TRUE kernel by numpy (independent of the trained path)."""
    batch, n = x.shape
    half = k_true.size // 2
    y = np.zeros((batch, n), np.float32)
    for b in range(batch):
        y[b] = np.convolve(x[b], k_true, mode="full")[half:half + n]
    return y + eps


def run(n: int, klen: int, batch: int, steps: int, lr: float = 2e-2,
        noise: float = 1e-3, *, mesh=None, seed: int = 0, device="cuda"):
    """Identify the system; returns (k_hat, k_true, losses) as numpy."""
    x, k_true, eps = make_problem(n, klen, batch, noise, seed)
    fit_ = make_trainer(n, klen, batch, steps, lr, mesh=mesh, device=device)
    k_hat, losses = fit_(x, observations(x, k_true, eps), np.zeros(klen, np.float32))
    return k_hat.cpu().numpy(), k_true, losses.cpu().numpy()


def main(argv=None):
    import torch.distributed as dist

    from ..parallel import make_mesh
    from ._world import rank0, world
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, klen, batch, steps = 512, 33, 8, 400
    with world(args.device) as dev:
        say = print if rank0() else (lambda *a, **k: None)
        k_hat, k_true, losses = run(n, klen, batch, steps, device=dev)
        err = np.max(np.abs(k_hat - k_true)) / np.max(np.abs(k_true))
        say(f"one device: loss {losses[0]:.3e} -> {losses[-1]:.3e}, kernel rel err {err:.2e}")
        assert losses[-1] < 1e-5 and err < 2e-2
        ndev = dist.get_world_size()
        dp = 2 if ndev % 2 == 0 else 1
        mesh = make_mesh({"dp": dp, "sp": ndev // dp}, device=args.device)
        kd, _, ld = run(n, klen, batch, steps, mesh=mesh)
        dk = np.max(np.abs(kd - k_hat)) / np.max(np.abs(k_hat))
        say(f"distributed (dp={dp} x sp={ndev // dp}): final loss {ld[-1]:.3e}, "
            f"kernel vs one device {dk:.2e}")
        assert dk < 1e-4
        say("OK")


if __name__ == "__main__":
    main()
