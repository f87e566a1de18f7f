"""A persistent gloo world of CPU ranks for the distributed layer's tests.

``World(n)`` starts ``n`` worker processes (``python tests/torch_world.py``),
each one rank of a gloo process group made through a ``FileStore`` in a
temporary directory (no fixed port, so parallel test workers never collide),
with ``torch.set_num_threads(1)`` and a 60 s collective timeout.  The ranks
import torch and the port, never JAX.  ``world.run("job", *args)`` sends the
same job to every rank and returns rank 0's result; a rank's exception comes
back as ``RankError`` (the exception's class name in ``type_name``).  When a
job does not finish within its timeout the world is killed, the test fails,
and the next ``run`` starts a fresh world, so the suite moves on.

Jobs are the ``job_*`` functions below (they run inside the ranks): a mesh
is made once per (axes, dcn) and kept; a rank outside a job's mesh returns
None without calling any collective.  Results travel as numpy.

Test files take the ``world`` fixture from ``world_fixture()``: one world
per test file (module scope).
"""

from __future__ import annotations

import os
import secrets
import subprocess
import sys
import tempfile
import traceback
from multiprocessing.connection import Client, Listener
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 240.0


class RankError(Exception):
    def __init__(self, type_name, message, tb=""):
        super().__init__(message)
        self.type_name = type_name
        self.tb = tb


class World:
    def __init__(self, n: int = 8):
        self.n = n
        self._procs = []
        self._conns = []

    def start(self):
        self._dir = tempfile.TemporaryDirectory(prefix="wgfft_world_")
        key = secrets.token_bytes(16)
        listener = Listener(("localhost", 0), authkey=key, backlog=64)
        store = os.path.join(self._dir.name, "store")
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        for r in range(self.n):
            self._procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "worker",
                 str(listener.address[1]), key.hex(), str(r), str(self.n), store],
                cwd=str(REPO), env=env))
        conns = {}
        listener._listener._socket.settimeout(120)
        try:
            for _ in range(self.n):
                c = listener.accept()
                conns[c.recv()] = c
        finally:
            listener.close()
        self._conns = [conns[r] for r in range(self.n)]
        for r, c in enumerate(self._conns):       # the process group is up
            if not c.poll(120) or c.recv() != "ready":
                self.kill()
                raise RuntimeError(f"rank {r} did not join the gloo world")

    def close(self):
        for c in self._conns:
            try:
                c.send(None)
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        self.kill()

    def kill(self):
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            p.wait()
        self._procs, self._conns = [], []
        if hasattr(self, "_dir"):
            self._dir.cleanup()
            del self._dir

    def run(self, job: str, *args, timeout: float = JOB_TIMEOUT, **kw):
        """Run ``job_<job>(*args, **kw)`` on every rank; rank 0's result."""
        if not self._conns:
            self.start()
        for c in self._conns:
            c.send((job, args, kw))
        results = []
        for r, c in enumerate(self._conns):
            if not c.poll(timeout):
                self.kill()
                raise TimeoutError(f"rank {r} did not finish job {job!r} "
                                   f"within {timeout} s; world killed")
            try:
                results.append(c.recv())
            except EOFError:
                self.kill()
                raise RuntimeError(f"rank {r} died during job {job!r}")
        for ok, payload in results:
            if not ok:
                raise RankError(*payload)
        return results[0][1]


def world_fixture(n: int = 8):
    import pytest

    @pytest.fixture(scope="module")
    def world():
        w = World(n)
        yield w
        w.close()
    return world


def raises(world, type_name: str, match: str, job: str, *args, **kw):
    """The job raises on the ranks an exception of class ``type_name`` whose
    message contains the regex ``match``; returns the message."""
    import re
    try:
        world.run(job, *args, **kw)
    except RankError as e:
        assert e.type_name == type_name, (e.type_name, str(e), e.tb)
        assert re.search(match, str(e)), (match, str(e))
        return str(e)
    raise AssertionError(f"{job} did not raise {type_name}")


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------

_MESHES = {}


def _mesh(axes, dcn=None):
    from webgpufft_tpu_torch.parallel import make_mesh
    key = (tuple(axes.items()), tuple((dcn or {}).items()))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes), dcn=dcn, device="cpu")
    return _MESHES[key]


def _member(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _np(y):
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(y, DTensor):
        y = y.full_tensor()
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    if isinstance(y, (tuple, list)):
        return type(y)(_np(v) for v in y)
    return y


class Collectives:
    """Every collective this rank issues while active, as (kind, group
    size): a dispatch mode sees the ``c10d`` ops of ``torch.distributed``
    calls and the ``_c10d_functional`` ops of DTensor's redistributes
    alike.  Kinds: all_gather, all_to_all, all_reduce, p2p (one per send),
    other."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        calls = self.calls = []

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.name()
                if name.startswith(("c10d::", "_c10d_functional::")):
                    kind = _coll_kind(name.split("::", 1)[1])
                    if kind is not None:
                        calls.append((kind, _group_size(args)))
                return func(*args, **(kwargs or {}))

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def count(self, kind):
        return sum(1 for k, _ in self.calls if k == kind)

    def summary(self):
        out = {k: self.count(k) for k in ("all_gather", "all_to_all", "all_reduce",
                                          "p2p", "other")}
        out["max_group"] = max((g for _, g in self.calls), default=0)
        return out


def _coll_kind(op: str):
    if op in ("wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier_"):
        return None
    if op.startswith("recv"):
        return None
    for kind, keys in (("all_gather", ("allgather", "all_gather")),
                       ("all_to_all", ("alltoall", "all_to_all")),
                       ("all_reduce", ("allreduce", "all_reduce")),
                       ("p2p", ("send",))):
        if any(k in op for k in keys):
            return kind
    return "other"


def _group_size(args):
    import torch
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except Exception:  # noqa: BLE001 - not a process group
                continue
        if isinstance(a, str):
            return dist.distributed_c10d._resolve_process_group(a).size()
    return 0


def _placements(y):
    """{mesh dim: "S<dim>" | "R" | "P"} of a DTensor result (None else)."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(y, (tuple, list)):
        y = y[-1] if y else None
    if not isinstance(y, DTensor):
        return None
    return {n: (f"S{p.dim}" if isinstance(p, Shard) else
                "R" if p.is_replicate() else "P")
            for n, p in zip(y.device_mesh.mesh_dim_names, y.placements)}


def _t(a):
    import torch
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return a


def _sub(v, mesh):
    if isinstance(v, str) and v == "MESH":
        return mesh
    if isinstance(v, list):
        return [_sub(u, mesh) for u in v]
    return v


def _attr(fn, name):
    v = getattr(fn, name, None)
    return v if isinstance(v, (int, float, tuple, list, str, type(None))) else repr(v)


def job_build(builder, bargs, bkw, axes, inputs=(), attrs=(), dcn=None,
              call=True):
    """``parallel.sharded.<builder>(*bargs with "MESH", **bkw)``, then its
    fn on ``inputs`` (numpy, every rank the same); returns
    {"out", "extra", "attrs"}.  A builder returning a tuple has its fn
    last."""
    import webgpufft_tpu_torch.parallel.sharded as S
    import webgpufft_tpu_torch.parallel.nufft as N
    mesh = _mesh(axes, dcn)
    if not _member(mesh):
        return None
    b = getattr(S, builder, None) or getattr(N, builder)
    res = b(*_sub(list(bargs), mesh), **{k: _sub(v, mesh) for k, v in bkw.items()})
    extra = ()
    fn = res
    if isinstance(res, tuple):
        extra, fn = tuple(np.asarray(e) for e in res[:-1]), res[-1]
    out = coll = place = None
    if call:
        with Collectives() as rec:
            y = fn(*[_t(a) for a in inputs])
        out, coll, place = _np(y), rec.summary(), _placements(y)
    return {"out": out, "extra": extra, "coll": coll, "placements": place,
            "attrs": {a: _attr(fn, a) for a in attrs}}


def _plan(opts, axes, batch_axis, seq_axis, kw):
    from webgpufft_tpu_torch.parallel import create_distributed_plan
    mesh = _mesh(axes)
    if not _member(mesh):
        return None, None
    plan = create_distributed_plan(dict(opts), mesh=mesh, batch_axis=batch_axis,
                                   seq_axis=seq_axis, **kw)
    return mesh, plan


def _route(plan):
    r = plan.route
    return {"mode": r.mode, "impl": r.impl, "axis_kinds": tuple(r.axis_kinds),
            "reasons": tuple(r.reasons)}


def job_plan(opts, axes, batch_axis=None, seq_axis=None, inputs=(), kernel=None,
             chain=None, kw=None, call=True):
    """create_distributed_plan(opts, ...) on ``inputs``; ``chain`` is a
    second options dict whose plan takes the first one's output.  Returns
    {"out", "route", "workspace"}."""
    mesh, plan = _plan(opts, axes, batch_axis, seq_axis, kw or {})
    if mesh is None:
        return None
    res = {"route": _route(plan), "workspace": plan.get_workspace_size_bytes()}
    if call:
        with Collectives() as rec:
            y = plan(*[_t(a) for a in inputs],
                     **({"kernel": _t(kernel)} if kernel is not None else {}))
            if chain is not None:
                _, p2 = _plan(chain, axes, batch_axis, seq_axis, {})
                res["route2"] = _route(p2)
                y = p2(y)
        res["out"] = _np(y)
        res["coll"], res["placements"] = rec.summary(), _placements(y)
    return res


def job_plan_grad(opts, axes, batch_axis, seq_axis, x, w):
    """Gradient of sum(w * plan(x)) (sum(plan(x)**2) when ``w`` is None)
    with respect to x: the distributed plan's and the local plan's (same
    options, CPU), both as numpy."""
    import torch
    import webgpufft_tpu_torch as T
    mesh, plan = _plan(opts, axes, batch_axis, seq_axis, {})
    if mesh is None:
        return None
    def loss(y):
        return (y * _t(w)).sum() if w is not None else (y ** 2).sum()

    xt = _t(x).clone().requires_grad_()
    g, = torch.autograd.grad(loss(plan(xt).full_tensor()), xt)
    local = T.create_plan({**opts, "tuning": {"impl": "xla"}}, device="cpu",
                          cache=T.PlanCache())
    xl = _t(x).clone().requires_grad_()
    gl, = torch.autograd.grad(loss(local(xl)), xl)
    return g.numpy(), gl.numpy()


def job_mesh(axes, devices=None, dcn=None):
    """make_mesh's rank array and dim names."""
    from webgpufft_tpu_torch.parallel import make_mesh
    m = make_mesh(dict(axes), devices, dcn=dcn, device="cpu")
    return m.mesh.numpy(), tuple(m.mesh_dim_names)


def job_call(module, name, *args, **kw):
    """Any function of the port on plain arguments (a case's own job)."""
    import importlib
    return _np(getattr(importlib.import_module(module), name)(*args, **kw))


def _worker(port, key, rank, world, store):
    import datetime
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import time
    for attempt in range(100):
        try:
            conn = Client(("localhost", int(port)), authkey=bytes.fromhex(key))
            break
        except ConnectionRefusedError:
            time.sleep(0.1 * (attempt + 1))
    conn.send(int(rank))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store, int(world)),
                            rank=int(rank), world_size=int(world),
                            timeout=datetime.timedelta(seconds=60))
    conn.send("ready")
    mod = sys.modules[__name__]
    while True:
        msg = conn.recv()
        if msg is None:
            break
        job, args, kw = msg
        try:
            conn.send((True, getattr(mod, "job_" + job)(*args, **kw)))
        except Exception as e:  # noqa: BLE001 - reported to the parent
            conn.send((False, (type(e).__name__, str(e), traceback.format_exc())))
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    import torch_world as _self     # jobs resolve in the importable module
    _self._worker(*sys.argv[2:7])
