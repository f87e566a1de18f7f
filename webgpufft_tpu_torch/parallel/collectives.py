"""The collectives of the distributed layer, differentiable.

The JAX package's ``parallel/`` runs its per-device bodies under
``shard_map`` and exchanges data with ``jax.lax`` collectives, which JAX
differentiates.  Here each is a ``torch.autograd.Function`` over the public
``torch.distributed`` calls, on the process group of one mesh dim:

- ``all_to_all`` (``lax.all_to_all(tiled=True)``): split ``split_axis`` into
  one chunk per rank of the group, send chunk j to rank j and concatenate
  what arrives along ``concat_axis`` (``dist.all_to_all_single``); its
  backward is the reverse exchange.
- ``ppermute`` (``lax.ppermute``): each ``(src, dst)`` pair of group ranks
  moves ``x`` from src to dst (``dist.batch_isend_irecv``); a rank that no
  pair sends to gets zeros.  A pair whose ends are one rank is a local copy.
  Its backward is the inverse permutation.
- ``psum`` (``lax.psum``): ``dist.all_reduce``.  Its result is replicated,
  so its gradient arrives replicated and passes back unchanged (JAX's
  transpose of a psum whose output is replicated); an ``all_reduce`` of it
  would count the gradient once per rank.
- ``psum_grad``: the identity on a value every rank holds whole and uses on
  its own part of the work (a kernel); its backward all_reduces the
  gradient, each rank's being its part's contribution.
- ``axis_index`` (``lax.axis_index``): ``mesh.get_local_rank(dim)``.
- ``AxisMap`` / ``remap``: a static gather along one tensor dim that is
  sharded over a group (the flips, rolls, pads, crops, permutations and
  folds that XLA's partitioner lowers to its own collectives when a jnp op
  indexes across a sharded dim).  Each rank keeps the shard it holds and
  receives only the elements it needs: point-to-point sends when each rank
  trades with at most two others (a shift, flip, pad or crop), else ONE
  ``dist.all_to_all_single`` with per-rank counts; a map whose every element
  stays on its rank calls no collective.  Its backward is the reverse exchange and a scatter-add.

Every rank of a group calls the same collectives in the same order: the
layer never branches on its rank in a way that changes which it calls.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def group_of(mesh, dim: str):
    """The process group of this rank along mesh dim ``dim``."""
    return mesh.get_group(mesh_dim=dim)


def axis_index(mesh, dim: str) -> int:
    """This rank's coordinate along mesh dim ``dim``."""
    return mesh.get_local_rank(mesh_dim=dim)


def _exchange(x: torch.Tensor, group, split_axis: int, concat_axis: int):
    ndev = dist.get_world_size(group)
    split_axis %= x.ndim
    concat_axis %= x.ndim
    # chunk j of the split axis goes to rank j: stack the chunks on a new
    # leading dim so the send buffer is rank-major and contiguous
    send = torch.stack(x.chunk(ndev, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _AllToAll.apply(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _permute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]):
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    send = x.contiguous()
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.args = (group, perm)
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        group, perm = ctx.args
        inverse = tuple((dst, src) for src, dst in perm)
        return _Permute.apply(g, group, inverse), None, None


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]):
    """``lax.ppermute(x, axis, perm)`` over the ranks of ``group``."""
    return _Permute.apply(x, group, tuple(perm))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        # the sum is replicated, and a replicated value's gradient is the
        # same on every rank (DTensor's and shard_map's convention): the
        # transpose of the all_reduce hands each rank that gradient as it is
        return g, None


def psum(x: torch.Tensor, group):
    """``lax.psum(x, axis)``, its result replicated over ``group``."""
    return _AllReduce.apply(x, group)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        for group in ctx.groups:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g, None


def psum_grad(x: torch.Tensor, mesh, dims):
    """``x``, a value every rank holds whole (a convolution kernel), used on
    this rank's part of work split over the mesh dims ``dims`` (names; None
    skipped): the identity, whose backward sums the gradient over those
    dims, since each rank's is its own part's contribution (what JAX's
    transpose of a replicated operand does under ``shard_map``)."""
    groups = tuple(group_of(mesh, d) for d in dict.fromkeys(dims)
                   if d is not None and mesh.size(mesh.mesh_dim_names.index(d)) > 1)
    return _SumGrad.apply(x, groups) if groups else x


def chunk_range(n: int, ndev: int, r: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``r``'s shard of a length-``n`` dim in DTensor's
    ``Shard`` layout (``torch.chunk``: ceil(n/ndev) per rank, the last
    ranks shorter or empty)."""
    c = -(-n // ndev) if n else 0
    lo = min(r * c, n)
    return lo, min(lo + c, n)


class AxisMap:
    """Output j is ``src[s_j][idx_j[k]]`` along one dim (zero where
    ``idx_j[k] < 0``), every source and output in the ``Shard`` layout of
    ``chunk_range`` over ``group`` (``group=None``: the dim is whole on
    this rank).  ``in_lens``: the sources' global lengths; ``maps``:
    ``(s_j, idx_j)`` pairs.  Built once from static index arrays; one
    exchange serves all the outputs.  What stays on the rank moves as a few
    strided slices where the map is made of runs (a pad, crop, flip, shift),
    else as one gather."""

    MAX_RUNS = 16

    def __init__(self, in_lens, maps, group, device):
        p = dist.get_world_size(group) if group is not None else 1
        me = dist.get_rank(group) if group is not None else 0
        self.group = group
        self.maps = [(s, np.asarray(idx)) for s, idx in maps]
        in_lens = [int(n) for n in in_lens]
        out_lens = [len(idx) for _, idx in maps]

        def loc_len(n, r):
            lo, hi = chunk_range(n, p, r)
            return hi - lo

        self.in_len_g, self.device = in_lens, device
        self.in_lens = [loc_len(n, me) for n in in_lens]
        self.out_lens = [loc_len(n, me) for n in out_lens]
        cols = []                      # (owner, dest, j, k, s, i_loc, k_loc)
        for j, (s, idx) in enumerate(self.maps):
            idx = idx.astype(np.int64)
            k = np.nonzero(idx >= 0)[0]
            i = idx[k]
            if i.size and i.max() >= in_lens[s]:
                raise ValueError("AxisMap index past its source")
            cin = max(-(-in_lens[s] // p), 1)
            cout = max(-(-len(idx) // p), 1)
            o, d = i // cin, k // cout
            cols.append(np.stack([o, d, np.full_like(k, j), k, np.full_like(k, s),
                                  i - o * cin, k - d * cout]))
        e = np.concatenate(cols, 1) if cols else np.zeros((7, 0), np.int64)
        o, d = e[0], e[1]
        self.exchange = bool(np.any(o != d))
        # a shift-like map (each rank trades with at most two others, as a
        # flip, roll, pad or crop does) moves by point-to-point sends, as
        # XLA lowers such slices to collective-permutes; any other pattern
        # is one all_to_all
        cross = o != d
        peers = [len(set(d[cross & (o == r)]) | set(o[cross & (d == r)]))
                 for r in range(p)]
        self.p2p = max(peers, default=0) <= 2
        self._ranks = ([dist.get_global_rank(group, r) for r in range(p)]
                       if group is not None else [0])

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                                   device=device)

        self.local = self._local_plan(e[:, (o == me) & (d == me)], t)
        # outputs that the local runs write whole need no zero fill
        cover = [0] * len(out_lens)
        if self.local[0] == "runs":
            for _, j, _, _, n, _ in self.local[1]:
                cover[j] += n
        self.covered = [c == n for c, n in zip(cover, self.out_lens)]
        snd = e[:, (o == me) & (d != me)]
        snd = snd[:, np.lexsort((snd[3], snd[2], snd[1]))]
        rcv = e[:, (d == me) & (o != me)]
        rcv = rcv[:, np.lexsort((rcv[3], rcv[2], rcv[0]))]
        self.send_counts = np.bincount(snd[1], minlength=p).tolist()
        self.recv_counts = np.bincount(rcv[0], minlength=p).tolist()
        # per source: (its rows of the send buffer, its positions); per
        # output: (its rows of the receive buffer, its positions)
        self.send = [(t(np.nonzero(snd[4] == s)[0]), t(snd[5][snd[4] == s]))
                     for s in range(len(in_lens))]
        self.recv = [(t(np.nonzero(rcv[2] == j)[0]), t(rcv[6][rcv[2] == j]))
                     for j in range(len(out_lens))]

    def _local_plan(self, e, t):
        """The entries that stay on this rank, as runs (s, j, to, from, n,
        step) when there are few, else one (s, j, to, from) gather each."""
        runs, gathers = [], []
        for s in np.unique(e[4]):
            for j in np.unique(e[2][e[4] == s]):
                g = e[:, (e[4] == s) & (e[2] == j)]
                g = g[:, np.argsort(g[6], kind="stable")]
                to, frm = g[6], g[5]
                gathers.append((int(s), int(j), t(to), t(frm)))
                start = 0
                for q in range(1, len(to) + 1):
                    step = frm[start + 1] - frm[start] if start + 1 < len(to) else 1
                    if (q == len(to) or to[q] != to[q - 1] + 1
                            or abs(step) != 1 or frm[q] != frm[q - 1] + step):
                        n = q - start
                        runs.append((int(s), int(j), int(to[start]),
                                     int(frm[start]), n, int(step) if n > 1 else 1))
                        start = q
        return ("runs", runs) if len(runs) <= self.MAX_RUNS else ("gather", gathers)

    def apply(self, xs, dim, forward=True):
        """The outputs (``forward``) or, from the outputs' gradients, the
        sources' gradients: the transpose moves every element back and
        adds it."""
        a, b = (xs, self.out_lens) if forward else (xs, self.in_lens)
        shape = a[0].shape
        out = [a[0].new_empty(shape[:dim] + (n,) + shape[dim + 1:])
               if forward and self.covered[i]
               else a[0].new_zeros(shape[:dim] + (n,) + shape[dim + 1:])
               for i, n in enumerate(b)]
        kind, plan = self.local
        if kind == "runs":
            for s, j, to, frm, n, step in plan:
                lo = frm if step == 1 else frm - n + 1
                if forward:                  # each output position once
                    piece = a[s].narrow(dim, lo, n)
                    out[j].narrow(dim, to, n).copy_(piece if step == 1
                                                    else piece.flip(dim))
                else:
                    piece = a[j].narrow(dim, to, n)
                    out[s].narrow(dim, lo, n).add_(piece if step == 1
                                                   else piece.flip(dim))
        else:
            for s, j, to, frm in plan:
                if forward:
                    out[j].index_add_(dim, to, a[s].index_select(dim, frm))
                else:
                    out[s].index_add_(dim, frm, a[j].index_select(dim, to))
        if self.exchange:
            take, put = (self.send, self.recv) if forward else (self.recv, self.send)
            counts = ((self.send_counts, self.recv_counts) if forward
                      else (self.recv_counts, self.send_counts))
            n_send = sum(counts[0])
            buf = a[0].new_empty(a[0].shape[:dim] + (n_send,) + a[0].shape[dim + 1:])
            for x, (rows, pos) in zip(a, take):
                if rows.numel():
                    buf.index_copy_(dim, rows, x.index_select(dim, pos))
            recv = self._exchange(buf.movedim(dim, 0).contiguous(), *counts)
            recv = recv.movedim(0, dim)
            for y, (rows, pos) in zip(out, put):
                if rows.numel():
                    y.index_add_(dim, pos, recv.index_select(dim, rows))
        return out

    def _exchange(self, send, send_counts, recv_counts):
        recv = send.new_empty((sum(recv_counts),) + send.shape[1:])
        if self.p2p:
            ops = []
            for r, (sv, rv) in enumerate(zip(send.split(send_counts),
                                             recv.split(recv_counts))):
                if sv.shape[0]:
                    ops.append(dist.P2POp(dist.isend, sv, self._ranks[r], self.group))
                if rv.shape[0]:
                    ops.append(dist.P2POp(dist.irecv, rv, self._ranks[r], self.group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        else:
            dist.all_to_all_single(recv, send, recv_counts, send_counts,
                                   group=self.group)
        return recv


class _Remap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, amap, dim, *xs):
        ctx.amap, ctx.dim = amap, dim
        return tuple(amap.apply(list(xs), dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(ctx.amap.apply(list(gs), ctx.dim, forward=False))


def remap(amap: AxisMap, dim: int, *xs):
    """The outputs of ``amap`` along ``dim`` of the local shards ``xs`` (one
    per source): a tuple, or the tensor when there is one output."""
    out = _Remap.apply(amap, dim % xs[0].ndim, *xs)
    return out[0] if len(out) == 1 else out
