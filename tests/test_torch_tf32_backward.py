"""The einsum route's products run in full float32 in the backward too.

With the caller's TF32 flag on, a ``TorchDispatchMode`` records the flag at
every matmul that a backward dispatches (``aten.mm`` / ``bmm`` / ``addmm``
/ ``baddbmm``): through a Bluestein plan, a DCT matmul axis and a
distributed four-step plan (a one-rank gloo world in this process), each
must see it off.  Autograd runs a backward after the forward's
``full_f32`` block has closed, so only contractions whose backward opens
the block again (``core.precision.einsum``) pass.  A CPU matmul has no TF32
mode; the flag is recorded, not its effect (the card case is in
test_torch_cuda.py)."""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

import webgpufft_tpu_torch as T

_MM = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
       torch.ops.aten.baddbmm)


class _FlagAtMatmul(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _MM:
            # the new interface's value is readable whichever set it last
            self.seen.append((str(func),
                              torch.backends.cuda.matmul.fp32_precision == "tf32"))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def tf32_on():
    m = torch.backends.cuda.matmul
    saved = m.fp32_precision            # readable whichever interface set it
    m.allow_tf32 = True
    try:
        yield
    finally:
        if saved == "none":
            m.fp32_precision = "none"
        else:
            m.allow_tf32 = saved == "tf32"


def _backward_flags(loss, x):
    rec = _FlagAtMatmul()
    with rec:
        g, = torch.autograd.grad(loss, x)
    assert torch.isfinite(g).all()
    return rec.seen


@pytest.mark.parametrize("opts", [
    {"type": "c2c", "shape": [202], "batch": 2},            # Bluestein axis
    {"type": "c2c", "shape": [24, 20], "batch": 2},         # mixed-radix, mid form
    {"type": "dct2", "shape": [16, 12], "batch": 2},        # trig matmuls
], ids=["bluestein", "mixed-2d", "dct-matmul"])
def test_backward_products_see_tf32_off(tf32_on, opts):
    plan = T.create_plan({**opts, "tuning": {"impl": "xla"}}, device="cpu",
                         cache=T.PlanCache())
    rng = np.random.default_rng(3)
    shape = (opts["batch"], *opts["shape"]) + ((2,) if opts["type"] == "c2c" else ())
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
    if opts["type"] == "c2c":
        assert plan.route.axis_kinds[0] == ("bluestein" if opts["shape"] == [202]
                                            else "mixed")
    seen = _backward_flags(plan(x).pow(2).sum(), x)
    assert seen, "the backward dispatched no matmul"
    assert all(not flag for _, flag in seen), seen
    assert torch.backends.cuda.matmul.fp32_precision == "tf32"


def test_distributed_four_step_backward_sees_tf32_off(tf32_on, tmp_path):
    from webgpufft_tpu_torch.parallel import create_distributed_plan, make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh({"sp": 1}, device="cpu")
        plan = create_distributed_plan({"type": "c2c", "shape": [256], "batch": 2},
                                       mesh=mesh, seq_axis="sp")
        assert any(r.startswith("digit-split:") for r in plan.route.reasons)
        rng = np.random.default_rng(4)
        x = torch.from_numpy(rng.standard_normal((2, 256, 2)).astype(np.float32))
        x.requires_grad_()
        seen = _backward_flags(plan(x).full_tensor().pow(2).sum(), x)
        assert len(seen) >= 2, seen          # both digit stages
        assert all(not flag for _, flag in seen), seen
    finally:
        dist.destroy_process_group()
