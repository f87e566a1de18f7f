"""Distributed NUFFT: nonuniform points sharded over a mesh dim.

Port of ``webgpufft_tpu/parallel/nufft.py``.  The single-device module is
bound by the spreading / interpolation stage ((2*Msp)^d Gaussian taps per
point) while the fine grid is comparatively small, so the work distributes
by POINTS:

- **Type 1** (nonuniform -> uniform): each rank spreads its point shard
  onto a whole local fine grid; spreading is linear, so ONE ``psum`` merges
  the partial grids; the fine-grid FFT (the port's facade: K1/K2 on the
  card), mode extraction and deconvolution then run on every rank.
- **Type 2** (uniform -> nonuniform): deconvolve + fine-grid FFT on every
  rank (the modes are replicated input); each rank interpolates only its
  own point shard.  No collective.
- **Type 3**: pre-phase, spread the source shard (one psum), the inner
  distributed type 2 at the rescaled targets, post-phase.

The builders take concrete points: the per-axis fine-grid base index and
residual (host float64 split, ``nufft._base_residual``) are kept on the
mesh's device, padded to a multiple of the mesh dim.  Strengths and modes
may be tracked (autograd flows through them and through the psum).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..core import cplx
from ..nufft import (_as_points, _as_strengths, _base_residual, _check_grid,
                     _check_isign, _free_coords, _geometry, _grid_from_modes,
                     _interp_taps, _modes_from_grid, _n_modes_tuple,
                     _phase_rot, _sep_taps_from_base, _spread_taps,
                     _type3_setup)
from ..spec import PlanError
from .collectives import axis_index, chunk_range, group_of, psum
from .sharded import as_global, axis_size, mesh_device, shard_in, shard_out

__all__ = ["build_distributed_nufft_type1", "build_distributed_nufft_type2",
           "build_distributed_nufft_type3"]


def _check_mesh_axes(mesh, axis_name: str, batch_axis_name):
    names = tuple(mesh.mesh_dim_names)
    if axis_name not in names:
        raise PlanError(f"mesh has no axis {axis_name!r} (axes: {names})")
    if batch_axis_name is not None and batch_axis_name not in names:
        raise PlanError(f"mesh has no batch axis {batch_axis_name!r} "
                        f"(axes: {names})")


class _PointShard:
    """This rank's share of the points: per-axis (m0, r) device vectors of
    the padded point list, sliced to the rank's contiguous range."""

    def __init__(self, points, hs, mesh, axis_name: str):
        self.m = points[0].shape[0]
        ndev = axis_size(mesh, axis_name)
        self.mp = -(-self.m // ndev) * ndev
        dev = mesh_device(mesh)
        loc = self.mp // ndev
        start = axis_index(mesh, axis_name) * loc
        self.m0s, self.rs = [], []
        for p, h in zip(points, hs):
            m0, r = _base_residual(p, h, dev)
            m0 = F.pad(m0, (0, self.mp - self.m))
            r = F.pad(r, (0, self.mp - self.m))
            self.m0s.append(m0[start:start + loc])
            self.rs.append(r[start:start + loc])
        self.m_loc = loc
        self.start = start
        lo, hi = chunk_range(self.m, ndev, axis_index(mesh, axis_name))
        self.n_here = hi - lo             # real (unpadded) points on this rank

    def taps(self, hs, taus, msp, mrs):
        return lambda s, e: _sep_taps_from_base(self.m0s, self.rs, hs, taus,
                                                msp, mrs, s, e)


def _strength_shard(c, m: int, mesh, axis_name: str, batch_axis_name, dev):
    """This rank's (B_loc, m_loc, 2) shard of the strengths (points over
    ``axis_name`` in the ``Shard`` layout, zero-padded to the padded point
    list's shard) and the leading batch shape.  A DTensor (B, m, 2) keeps
    its shards; anything else every rank holds whole."""
    c = as_global(c, mesh)
    spec = (batch_axis_name, axis_name, None)
    if isinstance(c, DTensor) and c.ndim == 3 and tuple(c.shape[1:]) == (m, 2):
        lead = (c.shape[0],)
        loc = shard_in(c, mesh, spec)
    else:
        if isinstance(c, DTensor):
            c = c.full_tensor()
        ci, lead = _as_strengths(c, m, dev)
        loc = shard_in(ci, mesh, spec)
    m_loc = -(-m // axis_size(mesh, axis_name))
    if loc.shape[1] < m_loc:
        loc = F.pad(loc, (0, 0, 0, m_loc - loc.shape[1]))
    return loc, lead


def _build_point_spread(points, hs, taus, msp: int, mrs, total: int, mesh,
                        axis_name: str):
    """apply(c_loc (B_loc, m_loc, 2)) -> (B_loc, total, 2) fine grid on
    every rank of ``axis_name``: each rank spreads its point shard, ONE psum
    merges them."""
    shard = _PointShard(points, hs, mesh, axis_name)
    group = group_of(mesh, axis_name)
    rank = len(mrs)

    def apply(c_loc):
        grid = _spread_taps(c_loc, shard.taps(hs, taus, msp, mrs),
                            (2 * msp) ** rank, total)
        return psum(grid, group)                    # (B_loc, total, 2)
    apply.shard = shard
    return apply


def _out(y_loc, lead, mesh, batch_axis_name, tail_spec, tail_shape):
    """The per-rank (B_loc, *tail) result as the DTensor (*lead, *tail):
    the batch over ``batch_axis_name``, the tail under ``tail_spec``."""
    tail_shape = tuple(tail_shape)
    if not lead:
        return shard_out(y_loc[0], mesh, tail_spec, tail_shape)
    loc = (y_loc.shape[0] * lead[0] // math.prod(lead), *lead[1:], *tail_shape)
    spec = (batch_axis_name,) + (None,) * (len(lead) - 1) + tuple(tail_spec)
    shape = (*lead, *tail_shape)
    return shard_out(y_loc.reshape(loc[:len(lead)] + tuple(y_loc.shape[1:])),
                     mesh, spec, shape)


def _prep(points, n_modes, mesh, axis_name: str, eps: float, isign: int,
          batch_axis_name):
    _check_isign(isign)
    _check_mesh_axes(mesh, axis_name, batch_axis_name)
    if not isinstance(points, (list, tuple)):
        points = (points,)
    rank = len(points)
    if rank not in (1, 2, 3):
        raise PlanError(f"points must be 1-3 coordinate arrays, got {rank}")
    pts = []
    for p in points:
        if isinstance(p, torch.Tensor):
            if p.requires_grad:
                raise PlanError(
                    "distributed NUFFT points must be concrete (they are "
                    "builder-time constants; only the strengths/modes may be "
                    "traced)")
            p = p.detach().cpu().numpy()
        pts.append(_as_points(np.asarray(p, np.float64)))
    if not all(p.shape == pts[0].shape for p in pts[1:]):
        raise PlanError(
            "point coordinate arrays must have the same number of points")
    m = pts[0].shape[0]
    if m == 0:
        raise PlanError("distributed NUFFT needs at least one point")
    ns = _n_modes_tuple(n_modes, rank)
    msp, mrs, hs, taus, total = _geometry(ns, eps)
    return rank, m, ns, msp, mrs, hs, taus, total, pts


def _batch_spec(batch_axis_name, ndim):
    return (batch_axis_name,) + (None,) * (ndim - 1)


def build_distributed_nufft_type1(points, n_modes, mesh, axis_name: str = "sp",
                                  *, eps: float = 1e-6, isign: int = 1,
                                  batch_axis_name: Optional[str] = None):
    """Build fn(c) -> (..., *n_modes, 2): type-1 NUFFT with the points
    sharded over mesh dim ``axis_name``.  ``points``: 1-3 concrete
    coordinate arrays (M,) in radians; ``c``: (..., M) complex or
    (..., M, 2) interleaved strengths.  The modes come out on every rank of
    ``axis_name``.  One psum of the (B, Mr^d, 2) fine grid."""
    (rank, m, ns, msp, mrs, hs, taus, total, pts) = _prep(
        points, n_modes, mesh, axis_name, eps, isign, batch_axis_name)
    spread = _build_point_spread(pts, hs, taus, msp, mrs, total, mesh, axis_name)
    dev = mesh_device(mesh)

    def fn(c):
        c_loc, lead = _strength_shard(c, m, mesh, axis_name, batch_axis_name, dev)
        out = _modes_from_grid(spread(c_loc), ns, mrs, hs, taus, isign)
        return _out(out, lead, mesh, batch_axis_name, (None,) * (rank + 1),
                    (*ns, 2))

    fn.n_modes = ns
    fn.n_points = m
    return fn


def _interp_shard(grid, shard, hs, taus, msp, mrs):
    """Values (B_loc, n_here, 2) at this rank's (unpadded) points of a fine
    grid every rank holds."""
    vals = _interp_taps(grid, shard.taps(hs, taus, msp, mrs), shard.m_loc,
                        (2 * msp) ** len(mrs))
    return vals[:, :shard.n_here]


def build_distributed_nufft_type2(points, n_modes, mesh, axis_name: str = "sp",
                                  *, eps: float = 1e-6, isign: int = -1,
                                  batch_axis_name: Optional[str] = None):
    """Build fn(f) -> (..., M, 2): type-2 NUFFT evaluating the uniform CMCL
    modes ``f`` (..., *n_modes) at the points, which are sharded over mesh
    dim ``axis_name`` (each rank interpolates its own shard; no
    collective)."""
    (rank, m, ns, msp, mrs, hs, taus, total, pts) = _prep(
        points, n_modes, mesh, axis_name, eps, isign, batch_axis_name)
    shard = _PointShard(pts, hs, mesh, axis_name)
    dev = mesh_device(mesh)

    def local(fb):
        """Modes (B_loc, *n_modes, 2) every rank of ``axis_name`` holds ->
        values (B_loc, n_here, 2) at this rank's points."""
        grid = _grid_from_modes(fb, ns, mrs, hs, taus, isign)
        return _interp_shard(grid, shard, hs, taus, msp, mrs)

    def fn(f):
        from ..fftapi import asinterleaved
        f = as_global(f, mesh)
        if isinstance(f, DTensor):
            f = f.full_tensor() if f.ndim < rank + 2 else f
        fb = f if isinstance(f, DTensor) else asinterleaved(f, device=dev)
        if tuple(fb.shape[-rank - 1:]) != (*ns, 2):
            raise PlanError(
                f"uniform modes must have trailing shape {(*ns, 2)} "
                f"(interleaved); got {tuple(np.shape(f))}")
        lead = tuple(fb.shape[:fb.ndim - rank - 1])
        b = math.prod(lead)
        fb = shard_in(fb, mesh, _batch_spec(batch_axis_name, rank + 2), (b, *ns, 2))
        vals = local(fb)
        return _out(vals, lead, mesh, batch_axis_name, (axis_name, None), (m, 2))

    fn.n_modes = ns
    fn.n_points = m
    fn.local = local
    return fn


def build_distributed_nufft_type3(sources, targets, mesh, axis_name: str = "sp",
                                  *, eps: float = 1e-6, isign: int = 1,
                                  batch_axis_name: Optional[str] = None):
    """Build fn(c) -> (..., K, 2): type-3 NUFFT (real source locations ->
    real target frequencies) with both point sets sharded over mesh dim
    ``axis_name``: pre-phase, spread the source shard (one psum), inner
    distributed type 2 at the rescaled targets, post-phase + deconvolution."""
    _check_isign(isign)
    _check_mesh_axes(mesh, axis_name, batch_axis_name)
    if not isinstance(sources, (list, tuple)):
        sources = (sources,)
    if not isinstance(targets, (list, tuple)):
        targets = (targets,)
    if len(sources) != len(targets):
        raise PlanError(
            f"sources and targets must have the same rank, got "
            f"{len(sources)} vs {len(targets)}")
    rank = len(sources)
    if rank not in (1, 2, 3):
        raise PlanError(f"points must be 1-3 coordinate arrays, got {rank}")
    xs = _free_coords(sources, "source locations")
    ss = _free_coords(targets, "target frequencies")
    m, k = xs[0].shape[0], ss[0].shape[0]
    (msp, nfs, hs, taus, us, thetas,
     pre_angle, post_angle, deconv) = _type3_setup(xs, ss, eps)
    total = _check_grid(nfs)
    spread = _build_point_spread(us, hs, taus, msp, nfs, total, mesh, axis_name)
    inner = build_distributed_nufft_type2(
        thetas, tuple(nfs), mesh, axis_name, eps=eps, isign=isign,
        batch_axis_name=batch_axis_name)
    dev = mesh_device(mesh)
    like = torch.empty(0, device=dev)
    sh = spread.shard
    pre = np.zeros(sh.mp)
    pre[:m] = isign * pre_angle
    pre_rot = _phase_rot(pre[sh.start:sh.start + sh.m_loc], like)
    lo, hi = chunk_range(k, axis_size(mesh, axis_name), axis_index(mesh, axis_name))
    post_rot = _phase_rot(isign * np.asarray(post_angle)[lo:hi], like,
                          np.broadcast_to(deconv, np.shape(post_angle))[lo:hi])

    def fn(c):
        c_loc, lead = _strength_shard(c, m, mesh, axis_name, batch_axis_name, dev)
        grid = spread(cplx.cmul_t4(c_loc, pre_rot))     # (B_loc, total, 2)
        vals = inner.local(grid.reshape((grid.shape[0], *nfs, 2)))
        out = cplx.cmul_t4(vals, post_rot)
        return _out(out, lead, mesh, batch_axis_name, (axis_name, None), (k, 2))

    fn.n_points = m
    fn.n_targets = k
    return fn
