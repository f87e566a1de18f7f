"""The process group the distributed examples run in.

Under ``torchrun --nproc-per-node N`` (``RANK`` / ``WORLD_SIZE`` in the
environment) the group is made from the environment; run alone it is a
one-rank world over an in-process ``HashStore``.  NCCL on a card, gloo on
the CPU.  The library itself never creates a group: this is the caller's
job, done here for the examples."""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist


def init_world(device: str = "cuda") -> torch.device:
    """Join (or create) the default process group; returns this rank's
    device (``cuda:LOCAL_RANK`` for ``device="cuda"``).  A failed init
    raises: nothing falls back to another backend."""
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        dev = torch.device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        timeout = datetime.timedelta(seconds=60)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, timeout=timeout, **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout, **kw)
    return dev


@contextlib.contextmanager
def world(device: str = "cuda"):
    """``init_world(device)`` for the block (yields the device); a group
    this block made is destroyed at its end, one the caller made stays."""
    made = not dist.is_initialized()
    dev = init_world(device)
    try:
        yield dev
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class MeshFields:
    """The pointwise layer of a distributed example on this rank's shards.

    The r2c / c2r plans over ``seq_axis`` (one mesh dim: grid axis 0 is
    sharded; a pair: axes 0 and 1) take and return DTensors; the example
    keeps only their local shards, so the pointwise layer never gathers a
    field.  ``plan(dp, kind)`` wraps a distributed plan as local shard ->
    local shard, ``cut(t)`` slices a spectral grid constant (packed axis
    first, a size-1 dim broadcasts) to this rank's shard, ``scatter(x)`` and
    ``gather(y)`` move a whole physical field in and out (at the start and
    the end of a run)."""

    def __init__(self, mesh, seq_axis, n: int, rank: int):
        self.mesh, self.n, self.rank = mesh, n, rank
        self.axes = (tuple(seq_axis) if isinstance(seq_axis, (tuple, list))
                     else (seq_axis,))
        self.phys_spec = (None, *self.axes) + (None,) * (rank - len(self.axes))
        self.spec_spec = self.phys_spec + (None,)
        self.spec_lens = (n // 2 + 1,) + (n,) * (rank - 1)

    def _shapes(self, kind, b):
        if kind == "r2c":
            return self.phys_spec, (b,) + (self.n,) * self.rank
        return self.spec_spec, (b, *self.spec_lens, 2)

    def plan(self, dp, kind: str):
        from ..parallel.sharded import shard_out

        def run(x_loc):
            spec, shape = self._shapes(kind, x_loc.shape[0])
            return dp(shard_out(x_loc, self.mesh, spec, shape)).to_local()
        return run

    def cut(self, t):
        from ..parallel.collectives import chunk_range
        from ..parallel.sharded import axis_index, axis_size
        for d, a in enumerate(self.axes):
            if t.shape[d] > 1:
                lo, hi = chunk_range(self.spec_lens[d], axis_size(self.mesh, a),
                                     axis_index(self.mesh, a))
                t = t.narrow(d, lo, hi - lo)
        return t

    def scatter(self, x):
        """A whole physical field (b, n, ..) every rank holds -> its shard."""
        from ..parallel.sharded import shard_in
        return shard_in(x, self.mesh, self.phys_spec)

    def gather(self, y_loc):
        """This rank's shard of a physical field (b, n, ..) -> the whole."""
        from ..parallel.sharded import shard_out
        spec, shape = self._shapes("r2c", y_loc.shape[0])
        return shard_out(y_loc, self.mesh, spec, shape).full_tensor()
