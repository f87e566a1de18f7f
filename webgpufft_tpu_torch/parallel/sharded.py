"""Batch sharding and the distributed single-transform FFT on
``torch.distributed``.

Port of ``webgpufft_tpu/parallel/sharded.py``.  Two modes, as there:

- **Batch sharding** ("dp"): batched transforms partitioned over the mesh's
  batch dim; collective-free, each rank runs the plan on its shard.
- **Distributed single FFT** ("sp"): one transform spanning ranks runs as a
  distributed four-step: local DFT over the n1 digit -> twiddle ->
  all_to_all digit exchange -> local DFT over the n2 digit.

How JAX's global view maps onto torch:

- A ``jax.Array`` under a ``NamedSharding`` is a ``DTensor`` with ``Shard`` /
  ``Replicate`` placements on a ``DeviceMesh``; a ``PartitionSpec`` is a
  tuple with one mesh-dim name (or None) per tensor dim (``placements``).
  Every builder's ``fn`` takes a ``DTensor``, or a tensor / array that every
  rank holds (it becomes a replicated ``DTensor`` that is then sharded, so a
  gradient reaches the caller's tensor whole), and returns a ``DTensor``
  whose ``.full_tensor()`` is the JAX package's output, same shape and order.
- A ``shard_map`` body is a function on the local shards (``fn.local`` of
  the four-step builders, ``fn.local_flat`` of the flat-line ones); the
  collectives are ``parallel/collectives.py``.
- What the XLA partitioner inserts silently is explicit here: the
  ``swapaxes`` of a sharded digit grid is a local transpose of the shard; a
  reshape between the flat line and the digit grid is one all_to_all
  (``_flat_to_grid_local`` / ``_grid_to_flat_local``); the stages between
  cores that index across the sharded dim (the half-complex untangle and
  re-tangle, the Hermitian unpack, the trig embeddings, the Bluestein pad
  and crop, the circular fold, the boundary crops, the signal slabs) are
  static gathers of the sharded dim (``collectives.AxisMap``): each rank
  receives only the elements it needs, and every result stays sharded.  A
  sharded dim whose length does not split evenly takes DTensor's ``Shard``
  layout (``collectives.chunk_range``); the riding axes transform on the
  local shard.
- The JAX package bounds per-device einsum operands and slabs the batch
  (``_check_per_device_operands``, ``_maybe_batch_slab``) because of
  XLA-TPU facts; the port runs every local stage whole.

The digit stages are einsums in full float32 (``core.precision.einsum``:
values and gradients), as the JAX package's ``Precision.HIGHEST``.  Every
table a builder keeps is built on the mesh's device.  The library never
calls ``init_process_group``: the caller does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core import dft
from ..core.cplx import cmul_const, const_pair, to_w4
from ..core.precision import einsum
from ..utils import factors
from ..utils.mathref import normalize_scale
from .collectives import (AxisMap, all_to_all, axis_index, chunk_range, group_of,
                          ppermute, psum, psum_grad, remap)


class UnsplittableAxisError(ValueError):
    """A transform axis has no smooth mesh-divisible digit split.

    Raised (instead of a plain ValueError) so callers with a documented
    fallback route, such as the pencil fftconv builder falling back to the
    single-axis padded-circular route (parallel/plans.py), can catch exactly
    this condition without swallowing unrelated builder errors."""


# ---------------------------------------------------------------------------
# Mesh and DTensor plumbing
# ---------------------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    """The size of mesh dim ``name`` (a JAX ``mesh.shape[name]``)."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r} (axes: {tuple(names)})")
    return mesh.size(names.index(name))


def mesh_shape(mesh) -> dict:
    """{name: size} of every mesh dim, in order (a JAX ``Mesh.shape``)."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards and the builders' tables live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _table(a, mesh, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=mesh_device(mesh))


def placements(mesh, spec: Sequence[Optional[str]]):
    """DTensor placements of a JAX ``PartitionSpec``: one mesh-dim name (or
    None) per tensor dim."""
    pl = [Replicate()] * mesh.ndim
    for d, name in enumerate(spec):
        if name is not None:
            pl[mesh.mesh_dim_names.index(name)] = Shard(d)
    return pl


def as_global(x, mesh):
    """A builder's input as a DTensor or a float32 (complex64 for complex
    data) tensor on the mesh's device (a JAX builder takes host arrays
    too)."""
    if isinstance(x, DTensor):
        return x
    dev = mesh_device(mesh)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.complex64 if x.is_complex()
                    else torch.float32)
    a = np.asarray(x)
    a = a.astype(np.complex64 if np.iscomplexobj(a) else np.float32)
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _stride(shape):
    st, acc = [], 1
    for d in reversed(tuple(shape)):
        st.append(acc)
        acc *= d
    return tuple(reversed(st))


def shard_in(x, mesh, spec, shape=None) -> torch.Tensor:
    """This rank's shard of ``x`` under ``spec`` (of global ``shape`` when
    given): a DTensor is redistributed (a local view change when only its
    shape differs and its sharded dims keep their extents); anything else
    is taken as held by every rank and sliced, through a replicated DTensor
    so that the backward gathers the whole gradient."""
    pl = placements(mesh, spec)
    if isinstance(x, DTensor):
        if shape is not None and tuple(x.shape) != tuple(shape):
            x = _reshape_global(x, mesh, shape)
        if tuple(x.placements) != tuple(pl):
            x = x.redistribute(mesh, pl)
        return x.to_local()
    if shape is not None:
        x = x.reshape(shape)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, pl).to_local()


def _reshape_global(x, mesh, shape):
    """A DTensor viewed as another global shape, shard by shard: each
    sharded dim must lead a group of dims that it alone spans (so that the
    local view is the same reshape), else the data is gathered."""
    shape = tuple(shape)
    src = tuple(x.shape)
    sharded = {p.dim: i for i, p in enumerate(x.placements)
               if isinstance(p, Shard)}
    groups, i, j = [], 0, 0            # (src dims, dst dims) of equal product
    while i < len(src) or j < len(shape):
        si, sj, a, b = i, j, 1, 1
        if i < len(src):
            a, i = src[i], i + 1
        if j < len(shape):
            b, j = shape[j], j + 1
        while a != b and (i < len(src) or j < len(shape)):
            if (a < b and i < len(src)) or j == len(shape):
                a, i = a * src[i], i + 1
            else:
                b, j = b * shape[j], j + 1
        groups.append((range(si, i), range(sj, j)))
    new_pl = list(x.placements)
    loc = []
    for sd, dd in groups:
        hit = [d for d in sd if d in sharded]
        if not hit:
            loc.extend(shape[k] for k in dd)
            continue
        ndev = mesh.size(sharded[hit[0]])
        if (len(hit) > 1 or hit[0] != sd.start or not len(dd)
                or src[sd.start] % ndev or shape[dd.start] % ndev
                or src[sd.start] // ndev * math.prod(src[k] for k in sd[1:])
                != shape[dd.start] // ndev * math.prod(shape[k] for k in dd[1:])):
            return DTensor.from_local(x.full_tensor().reshape(shape), mesh,
                                      [Replicate()] * mesh.ndim, run_check=False)
        new_pl[sharded[hit[0]]] = Shard(dd.start)
        loc.append(shape[dd.start] // ndev)
        loc.extend(shape[k] for k in dd[1:])
    return DTensor.from_local(x.to_local().reshape(loc), mesh, new_pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=_stride(shape))


def shard_out(y_loc, mesh, spec, shape=None) -> DTensor:
    """Local shards as the DTensor of ``spec``; ``shape`` (the global shape)
    is needed where a sharded dim does not split evenly."""
    kw = {}
    if shape is not None:
        kw = {"shape": torch.Size(shape), "stride": _stride(shape)}
    return DTensor.from_local(y_loc, mesh, placements(mesh, spec),
                              run_check=False, **kw)


def _rows(a, n: int, mesh, axis_name, dim: int = 1, dtype=torch.float32):
    """A table whose dim ``dim`` has length ``n``, cut to this rank's shard
    of that dim over ``axis_name`` (whole when None), on the mesh's device."""
    a = np.asarray(a)
    if axis_name is not None:
        lo, hi = chunk_range(n, axis_size(mesh, axis_name),
                             axis_index(mesh, axis_name))
        a = np.take(a, np.arange(lo, hi), axis=dim)
    return _table(a, mesh, dtype)


def _amap(mesh, axis_name, in_lens, maps):
    """An ``AxisMap`` over mesh dim ``axis_name`` (None: a local gather)."""
    return AxisMap(in_lens, maps, group_of(mesh, axis_name) if axis_name else None,
                   mesh_device(mesh))


def _whole(amap: AxisMap) -> AxisMap:
    """The one-output ``amap`` applied to a tensor every rank holds whole
    (built once, kept on ``amap``)."""
    if not hasattr(amap, "whole"):
        (s, idx), = amap.maps
        amap.whole = AxisMap([amap.in_len_g[s]], [(0, idx)], None,
                             amap.device)
    return amap.whole


def _enter(x, mesh, spec, shape, amap, dim: int = 1):
    """This rank's shard (under ``spec``) of the one-output ``amap`` applied
    along ``dim`` of the global ``x`` of ``shape``.  A DTensor is sharded
    and remapped (its exchange); a tensor every rank holds is remapped whole
    and sliced, which moves nothing."""
    if isinstance(x, DTensor):
        return remap(amap, dim, shard_in(x, mesh, spec, shape))
    return shard_in(remap(_whole(amap), dim, x.reshape(shape)), mesh, spec)


def _drop_lead(y, mesh) -> DTensor:
    """y[0] of a DTensor whose lead dim is not sharded, shard by shard."""
    pl = []
    for p in y.placements:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("the lead dim is sharded")
            p = Shard(p.dim - 1)
        pl.append(p)
    shape = tuple(y.shape[1:])
    return DTensor.from_local(y.to_local()[0], mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=_stride(shape))


def _flat_to_grid_local(x_loc, group, n1: int, ndev: int, axis: int = 1):
    """Contiguous shard of a length n = n1*n2 axis (dim ``axis``) -> the
    local (.., n1, n2_loc, ..) digit grid: one all_to_all (the reshape of a
    sharded line the partitioner would lower)."""
    sh = x_loc.shape
    n_loc = sh[axis]
    x = x_loc.reshape(*sh[:axis], n1 // ndev, n_loc * ndev // n1, *sh[axis + 1:])
    return all_to_all(x, group, axis + 1, axis)


def _grid_to_flat_local(y_loc, group, axis: int = 1):
    """Local (.., k2, k1_loc, ..) digit grid at dims (axis, axis+1) -> the
    contiguous shard of the flat k = k1 + n1*k2 axis: one all_to_all."""
    z = all_to_all(y_loc, group, axis, axis + 1)      # (.., k2_loc, k1, ..)
    sh = z.shape
    return z.reshape(*sh[:axis], sh[axis] * sh[axis + 1], *sh[axis + 2:])


def _conj(y):
    return y * y.new_tensor([1.0, -1.0])


# ---------------------------------------------------------------------------
# Batch sharding
# ---------------------------------------------------------------------------

def shard_batch(plan, mesh, axis_name: str = "dp"):
    """Wrap a plan so exec runs with the batch dim sharded over
    ``axis_name``: each rank runs the local plan on its batch shard (no
    collectives).  Returns run(x) -> a DTensor sharded on the batch dim."""
    def run(x):
        x = as_global(x, mesh)
        spec = (axis_name,) + (None,) * (x.ndim - 1)
        return shard_out(plan(shard_in(x, mesh, spec)), mesh, spec)
    return run


# ---------------------------------------------------------------------------
# Distributed single-transform FFT (four-step, one all_to_all)
# ---------------------------------------------------------------------------

def choose_distributed_split(n: int, ndev: int) -> Optional[Tuple[int, int]]:
    """(n1, n2) with n = n1*n2, ndev | n1 and ndev | n2, both smooth and as
    balanced as possible; None when impossible."""
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            for n1 in (d, n // d):
                n2 = n // n1
                if (n1 % ndev == 0 and n2 % ndev == 0
                        and factors.is_smooth(n1) and factors.is_smooth(n2)):
                    key = abs(n1 - n2)
                    if best is None or key < best[0]:
                        best = (key, (n1, n2))
        d += 1
    return best[1] if best else None


def _four_step_tables(n: int, n1: int, n2: int, direction: str, scale: float,
                      mesh, bshape):
    w1 = _table(to_w4(dft.dft_matrix(n1, direction)), mesh)
    w2 = _table(to_w4(dft.dft_matrix(n2, direction) * np.complex64(scale)), mesh)
    sign = -1.0 if direction == "forward" else 1.0
    tw = np.exp(sign * 2j * np.pi *
                (np.outer(np.arange(n1), np.arange(n2)) % n) / n)     # [k1, n2]
    twa, twb = const_pair(tw)
    return w1, w2, _table(twa.reshape(bshape), mesh), _table(twb.reshape(bshape), mesh)


def _resolve_split(n: int, ndev: int, split, what: str):
    if split is None:
        split = choose_distributed_split(n, ndev)
    if split is None:
        raise UnsplittableAxisError(
            f"cannot split {what}={n} into two smooth factors divisible by {ndev}")
    n1, n2 = split
    if n1 * n2 != n or n1 % ndev or n2 % ndev:
        raise ValueError(f"invalid split {split} for n={n}, ndev={ndev}")
    return n1, n2


def build_distributed_fft_axis0(shape, mesh, axis_name: str = "sp",
                                direction: str = "forward",
                                normalize: str = "none",
                                batch_axis_name: Optional[str] = None,
                                split: Optional[Tuple[int, int]] = None,
                                rest_specs: Optional[Tuple] = None):
    """Distributed FFT along logical AXIS 0 of an ND array, trailing axes
    riding locally.

    x: (batch, n0, *shape[1:], 2).  Output: the digit grid
    (batch, k2, k1, *shape[1:], 2) with axis-0 index k = k1 + n1*k2 and k1
    sharded over ``axis_name`` (reshape merges (k2, k1) back to n0).  The
    riding axes are NOT transformed.  ``rest_specs``: one mesh-dim name or
    None per riding axis when riding axes are themselves sharded (the
    pencil composition).  ``fn.local`` is the per-rank body: local digit
    grid (b, n1, n2_loc, *rest, 2) -> local (b, k2, k1_loc, *rest, 2).
    """
    n0 = shape[0]
    rest = tuple(shape[1:])
    ndev = axis_size(mesh, axis_name)
    if rest_specs is None:
        rest_specs = (None,) * len(rest)
    if len(rest_specs) != len(rest):
        raise ValueError("rest_specs must have one entry per riding axis")
    n1, n2 = _resolve_split(n0, ndev, split, "n0")
    scale = normalize_scale(normalize, direction, n0)
    bshape = (n1, n2) + (1,) * len(rest) + (2,)
    w1, w2, twa, twb = _four_step_tables(n0, n1, n2, direction, scale, mesh, bshape)
    n2_loc = n2 // ndev
    group = group_of(mesh, axis_name)
    in_spec = (batch_axis_name, None, axis_name, *rest_specs, None)
    flat_spec = (batch_axis_name, axis_name, *rest_specs, None)

    def local(x_loc):
        idx = axis_index(mesh, axis_name)
        # stage 1: contract the n1 digit
        y = einsum("baj...i,aick->bcj...k", x_loc, w1)
        # twiddle W_N^{n2*k1}, sliced to this rank's n2 range
        sl = slice(idx * n2_loc, (idx + 1) * n2_loc)
        y = cmul_const(y, twa[:, sl], twb[:, sl])
        # digit exchange: shard k1, gather full n2 (sharded.py:290)
        y = all_to_all(y, group, 1, 2)                    # (b, k1_loc, n2, ...)
        y = einsum("bca...i,aimk->bcm...k", y, w2)        # contract n2 digit
        return y.transpose(1, 2)                          # (b, k2, k1_loc, ...)

    def local_flat(x_loc):
        """This rank's shard of the flat line (contiguous, standard order)
        in and out: the reshapes at sharded.py:1045/1066, one all_to_all
        each side."""
        y = local(_flat_to_grid_local(x_loc, group, n1, ndev))
        return _grid_to_flat_local(y, group)

    def local_in(x):
        """This rank's digit-grid shard of a flat or grid-shaped input."""
        x = as_global(x, mesh)
        b = x.shape[0]
        grid = (b, n1, n2, *rest, 2)
        if isinstance(x, DTensor) and tuple(x.shape) == (b, n0, *rest, 2):
            return _flat_to_grid_local(shard_in(x, mesh, flat_spec), group,
                                       n1, ndev)
        return shard_in(x, mesh, in_spec, grid)

    def fn(x):
        # the swapaxes of jnp.swapaxes(y, 1, 2) (sharded.py:305) is the
        # local transpose inside ``local``
        return shard_out(local(local_in(x)), mesh, in_spec)

    fn.split = (n1, n2)
    fn.local = local
    fn.local_in = local_in
    fn.local_flat = local_flat
    fn.spec = in_spec
    fn.flat_spec = flat_spec
    fn.shape = (n0, *rest)
    return fn


def build_distributed_fft_1d(n: int, mesh, axis_name: str = "sp",
                             direction: str = "forward",
                             normalize: str = "none",
                             batch_axis_name: Optional[str] = None,
                             split: Optional[Tuple[int, int]] = None):
    """Build fn(x) computing a length-n FFT distributed over mesh dim
    ``axis_name``.

    x: (batch, n, 2) or the digit grid (batch, n1, n2, 2).  Returns the
    digit grid (batch, k2, k1, 2) with k = k1 + n1*k2 and k1 sharded;
    ``.full_tensor().reshape(batch, n, 2)`` restores the flat line.

    ``split`` overrides the balanced (n1, n2) choice: a forward plan's
    (k2, k1) output grid IS the digit grid of an inverse plan built with the
    swapped split, so spectra flow between them without resharding.
    """
    inner = build_distributed_fft_axis0((n,), mesh, axis_name, direction,
                                        normalize, batch_axis_name, split)
    n1, n2 = inner.split

    def fn(x):
        x = as_global(x, mesh)
        if x.ndim == 4 and tuple(x.shape[1:]) != (n1, n2, 2):
            raise ValueError(
                f"expected (b, n, 2) or (b, {n1}, {n2}, 2), got {tuple(x.shape)}")
        if x.ndim not in (3, 4):
            raise ValueError(
                f"expected (b, n, 2) or (b, {n1}, {n2}, 2), got {tuple(x.shape)}")
        return inner(x)

    for attr in ("split", "local", "local_in", "local_flat", "spec", "flat_spec",
                 "shape"):
        setattr(fn, attr, getattr(inner, attr))
    return fn


def _flat_output(inner, mesh, axis_name):
    """Wrap a digit-grid builder so it returns the flat standard-order
    array, sharded contiguously over ``axis_name`` (the reshape at
    sharded.py:1045/1066, one all_to_all)."""
    group = group_of(mesh, axis_name)

    def fn(x):
        x = as_global(x, mesh)
        b = x.shape[0]
        y = inner.local(inner.local_in(x))
        return shard_out(_grid_to_flat_local(y, group), mesh, inner.flat_spec,
                         (b, *inner.shape, 2))

    for attr in ("split", "local_flat", "flat_spec", "shape"):
        setattr(fn, attr, getattr(inner, attr))
    return fn


def build_distributed_pencil_axes01(shape, mesh,
                                    axes: Tuple[str, str] = ("sp0", "sp1"),
                                    direction: str = "forward",
                                    batch_axis_name: Optional[str] = None,
                                    splits=None):
    """Pencil-decomposed distributed FFT: logical axes 0 AND 1 each span
    their own mesh dim (a 2-D rank decomposition), one all_to_all per
    decomposed axis, each on its own mesh dim's group.

    x: (batch, n0, n1, *rest, 2) -> same shape, axes 0 and 1 transformed
    (normalize is the caller's job).  Riding axes are NOT transformed.
    The result is sharded on axis 0 over ``axes[0]`` and on axis 1 over
    ``axes[1]``, contiguously.
    """
    a0, a1 = axes
    if a0 == a1:
        raise ValueError("pencil axes must be two distinct mesh axes")
    n0, n1 = shape[0], shape[1]
    rest = tuple(shape[2:])
    p0, p1 = axis_size(mesh, a0), axis_size(mesh, a1)
    s0 = splits[0] if splits else choose_distributed_split(n0, p0)
    s1 = splits[1] if splits else choose_distributed_split(n1, p1)
    if s0 is None or s1 is None:
        bad = f"n0={n0} over {p0}" if s0 is None else f"n1={n1} over {p1}"
        raise UnsplittableAxisError(
            f"pencil decomposition needs both sharded axes to split into "
            f"two smooth mesh-divisible factors; cannot split {bad} "
            f"(single seq_axis handles any length via Bluestein)")
    q1, q2 = s1
    w1q, w2q, twqa, twqb = _four_step_tables(
        n1, q1, q2, direction, 1.0, mesh, (1, q1, q2) + (1,) * len(rest) + (2,))
    q2_loc = q2 // p1
    g1 = group_of(mesh, a1)
    rest_none = (None,) * len(rest)
    # axis-0 stage: the axis-0 builder with the axis-1 digit grid (k1q
    # sharded over a1) riding through via rest_specs
    fft0 = build_distributed_fft_axis0(
        (n0, q1, q2, *rest), mesh, a0, direction, "none", batch_axis_name,
        split=s0, rest_specs=(a1, None, *rest_none))
    m1 = s0[0]
    g0 = group_of(mesh, a0)
    in_spec = (batch_axis_name, a0, None, a1, *rest_none, None)
    out_spec = (batch_axis_name, a0, a1, *rest_none, None)

    def ax1(x_loc):
        # x_loc: (b, n0_loc, q1, q2_loc, *rest, 2)
        idx = axis_index(mesh, a1)
        y = einsum("bxaj...i,aick->bxcj...k", x_loc, w1q)
        sl = slice(idx * q2_loc, (idx + 1) * q2_loc)
        y = cmul_const(y, twqa[:, :, sl], twqb[:, :, sl])
        y = all_to_all(y, g1, 2, 3)              # (b, n0_loc, k1q_loc, q2, ...)
        return einsum("bxca...i,aimk->bxcm...k", y, w2q)

    def local(x_loc):
        """(b, n0_loc, n1_loc, *rest, 2), both contiguous -> the same."""
        b, n0l, n1l = x_loc.shape[:3]
        y = ax1(_flat_to_grid_local(x_loc, g1, q1, p1, axis=2))
        # (b, n0_loc, k1q_loc, k2q, ..): contiguous n0 rows -> axis-0 digit
        # grid (the reshape the partitioner inserts at sharded.py:401)
        y = _flat_to_grid_local(y, g0, m1, p0, axis=1)
        y = fft0.local(y)                        # (b, k2m, k1m_loc, k1q_loc, k2q, ..)
        y = _grid_to_flat_local(y, g0, axis=1)   # (b, n0_loc, k1q_loc, k2q, ..)
        y = y.transpose(2, 3)                    # (b, n0_loc, k2q, k1q_loc, ..)
        return _grid_to_flat_local(y, g1, axis=2)    # (b, n0_loc, n1_loc, ..)

    def fn(x):
        x = as_global(x, mesh)
        b = x.shape[0]
        return shard_out(local(shard_in(x, mesh, out_spec, (b, n0, n1, *rest, 2))),
                         mesh, out_spec)

    fn.split = (s0, s1)
    fn.local = local
    fn.spec = out_spec
    return fn


# ---------------------------------------------------------------------------
# Any length: Bluestein embedding at a smooth distributed length
# ---------------------------------------------------------------------------

def smooth_distributed_len_at_least(m0: int, ndev: int) -> int:
    """Smallest smooth length >= m0 admitting a two-factor digit split with
    both digits divisible by ndev (the distributed four-step requirement)."""
    m = m0
    for _ in range(64):
        m = factors.next_smooth_at_least(m)
        if choose_distributed_split(m, ndev) is not None:
            return m
        m += 1
    raise ValueError(
        f"no smooth distributed length >= {m0} for {ndev} devices")


def build_distributed_bluestein_axis0(shape, mesh, axis_name: str = "sp",
                                      direction: str = "forward",
                                      normalize: str = "none",
                                      batch_axis_name: Optional[str] = None):
    """Distributed axis-0 FFT of ARBITRARY length n0 with riding trailing
    axes: chirp mul -> distributed forward M-FFT -> pointwise kernel
    spectrum in the sharded (k2, k1) grid -> distributed inverse M-FFT with
    the swapped split (grid to grid, no resharding) -> crop + chirp mul.
    The zero-pad to M and the crop back to n0 are shifts of the sharded
    line (``AxisMap``); 1/M is folded into the kernel spectrum.

    x: (batch, n0, *shape[1:], 2) -> (batch, n0, *shape[1:], 2), standard
    axis-0 bin order, sharded over ``axis_name`` (``Shard`` layout)."""
    n0, rest = shape[0], tuple(shape[1:])
    ndev = axis_size(mesh, axis_name)
    m = smooth_distributed_len_at_least(max(2 * n0 - 1, ndev * ndev), ndev)
    fwd = build_distributed_fft_axis0((m, *rest), mesh, axis_name, "forward",
                                      "none", batch_axis_name)
    n1, n2 = fwd.split
    inv = build_distributed_fft_axis0((m, *rest), mesh, axis_name, "inverse",
                                      "none", batch_axis_name, split=(n2, n1))
    line = (1, n0) + (1,) * len(rest) + (2,)
    ca_, cb_ = const_pair(dft.bluestein_chirp(n0, direction))
    ca = _rows(ca_.reshape(line), n0, mesh, axis_name)
    cb = _rows(cb_.reshape(line), n0, mesh, axis_name)
    h = dft.bluestein_kernel_fft(n0, m, direction)     # (m,), 1/m folded
    grid = (1, n2, n1) + (1,) * len(rest) + (2,)
    ha_, hb_ = const_pair(h.reshape(n2, n1))
    ha, hb = _table(ha_.reshape(grid), mesh), _table(hb_.reshape(grid), mesh)
    scale = normalize_scale(normalize, direction, n0)
    n1_loc = n1 // ndev
    group = group_of(mesh, axis_name)
    ar = np.arange(m)
    pad = _amap(mesh, axis_name, [n0], [(0, np.where(ar < n0, ar, -1))])
    crop = _amap(mesh, axis_name, [m], [(0, np.arange(n0))])
    spec = (batch_axis_name, axis_name) + (None,) * (len(rest) + 1)

    def local_flat(x_loc):
        a = remap(pad, 1, cmul_const(x_loc, ca, cb))
        s = fwd.local(_flat_to_grid_local(a, group, n1, ndev))   # (b, k2, k1_loc, ..)
        idx = axis_index(mesh, axis_name)
        sl = slice(idx * n1_loc, (idx + 1) * n1_loc)
        s = cmul_const(s, ha[:, :, sl], hb[:, :, sl])
        y = _grid_to_flat_local(inv.local(s), group)              # flat chunk of m
        y = cmul_const(remap(crop, 1, y), ca, cb)
        return y if scale == 1.0 else y * scale

    def fn(x):
        x = as_global(x, mesh)
        full_shape = (x.shape[0], n0, *rest, 2)
        return shard_out(local_flat(shard_in(x, mesh, spec, full_shape)), mesh,
                         spec, full_shape)

    fn.split = fwd.split
    fn.bluestein_m = m
    fn.local_flat = local_flat
    fn.flat_spec = spec
    fn.shape = (n0, *rest)
    return fn


def build_distributed_bluestein_1d(n: int, mesh, axis_name: str = "sp",
                                   direction: str = "forward",
                                   normalize: str = "none",
                                   batch_axis_name: Optional[str] = None):
    """Distributed 1D FFT of ARBITRARY length via the chirp-Z embedding
    (the rank-1 case of ``build_distributed_bluestein_axis0``).
    x: (batch, n, 2) -> (batch, n, 2), standard bin order."""
    return build_distributed_bluestein_axis0((n,), mesh, axis_name, direction,
                                             normalize, batch_axis_name)


def build_distributed_fft_any_axis0(shape, mesh, axis_name: str = "sp",
                                    direction: str = "forward",
                                    normalize: str = "none",
                                    batch_axis_name: Optional[str] = None):
    """Distributed axis-0 FFT for ANY n0 with riding axes: four-step digit
    plan when n0 admits a divisible smooth split, Bluestein embedding
    otherwise.  fn(x: (batch, n0, *rest, 2)) -> flat (batch, n0, *rest, 2)."""
    if choose_distributed_split(shape[0], axis_size(mesh, axis_name)) is not None:
        return _flat_output(build_distributed_fft_axis0(
            shape, mesh, axis_name, direction, normalize, batch_axis_name),
            mesh, axis_name)
    return build_distributed_bluestein_axis0(shape, mesh, axis_name, direction,
                                             normalize, batch_axis_name)


def build_distributed_fft_any_1d(n: int, mesh, axis_name: str = "sp",
                                 direction: str = "forward",
                                 normalize: str = "none",
                                 batch_axis_name: Optional[str] = None):
    """Distributed 1D FFT for any length; fn(x: (batch, n, 2)) -> flat
    (batch, n, 2)."""
    return build_distributed_fft_any_axis0((n,), mesh, axis_name, direction,
                                           normalize, batch_axis_name)


# ---------------------------------------------------------------------------
# Real transforms
# ---------------------------------------------------------------------------

def _untangle_map(h: int, mesh, axis_name):
    """Z[k mod h] and Z[-k mod h] for k = 0..h along the sharded half
    spectrum: the rev+concat of sharded.py:448-452 as one exchange."""
    k = np.arange(h + 1)
    return _amap(mesh, axis_name, [h], [(0, k % h), (0, (-k) % h)])


def _untangle(z, amap, ca, cb):
    """Half-complex forward untangle along dim 1 of this rank's shard of the
    flat half spectrum z (b, h, ..., 2) -> its shard of packed (b, h+1, ..)."""
    zpad, zf = remap(amap, 1, z)
    zf = _conj(zf)                                        # conj(Z[-k])
    return (zpad + zf) * 0.5 + cmul_const(zpad - zf, ca, cb)


def _retangle_tables(h: int, rest, mesh, axis_name, ca_, cb_):
    """The exchange, self-conjugate mask and constants of the inverse
    re-tangle on shards of the packed axis (h+1 bins -> h)."""
    k = np.arange(h)
    amap = _amap(mesh, axis_name, [h + 1], [(0, k), (0, h - k)])
    mask = np.ones((1, h + 1) + (1,) * len(rest) + (2,), np.float32)
    mask[:, [0, h], ..., 1] = 0.0
    cshape = (1, h) + (1,) * len(rest) + (2,)
    return (amap, _rows(mask, h + 1, mesh, axis_name),
            _rows(ca_.reshape(cshape), h, mesh, axis_name),
            _rows(cb_.reshape(cshape), h, mesh, axis_name))


def _retangle(y, tables):
    """Half-complex inverse re-tangle along dim 1 of this rank's shard of
    packed y (b, h+1, .., 2) -> its shard of the half-length spectrum;
    self-conjugate bins 0 and h lose their imaginary part."""
    amap, mask, ca, cb = tables
    xk, xf = remap(amap, 1, y * mask)
    xf = _conj(xf)                                        # conj(X[h-k])
    return (xk + xf) + cmul_const(xk - xf, ca, cb)


def _scaled(y, scale):
    return y if scale == 1.0 else y * scale


def _io(local, mesh, in_spec, out_spec, in_shape, out_shape):
    """fn(x) of a builder whose per-rank body is ``local``: shard in, run,
    shard out; the global shapes take the batch from x."""
    def call(x):
        x = as_global(x, mesh)
        b = x.shape[0]
        y = local(shard_in(x, mesh, in_spec, (b, *in_shape)))
        return shard_out(y, mesh, out_spec, (b, *out_shape))
    return call


def build_distributed_r2c_1d(n: int, mesh, axis_name: str = "sp",
                             normalize: str = "none",
                             batch_axis_name: Optional[str] = None):
    """Distributed real -> packed-complex 1D FFT.  x: (batch, n) real ->
    (batch, n//2 + 1, 2), sharded over ``axis_name``.  Even n whose half
    splits over the mesh dim runs the half-complex trick on the distributed
    length-n/2 plan; otherwise the input widens to a full-length complex
    FFT (Bluestein when n has no split)."""
    from ..plans.transforms import _half_trick_consts
    packed = n // 2 + 1
    in_spec = (batch_axis_name, axis_name)
    out_spec = (batch_axis_name, axis_name, None)
    if n % 2 or choose_distributed_split(n // 2, axis_size(mesh, axis_name)) is None:
        fftc = build_distributed_fft_any_1d(n, mesh, axis_name, "forward",
                                            normalize, batch_axis_name)
        crop = _amap(mesh, axis_name, [n], [(0, np.arange(packed))])

        def local(x):
            v = torch.stack([x, torch.zeros_like(x)], dim=-1)
            return remap(crop, 1, fftc.local_flat(v))
    else:
        h = n // 2
        fftc = build_distributed_fft_any_1d(h, mesh, axis_name, "forward", "none",
                                            batch_axis_name)
        cc = _half_trick_consts(n, inverse=False)
        ca = _rows(cc["rc/ca"].reshape(1, h + 1, 2), h + 1, mesh, axis_name)
        cb = _rows(cc["rc/cb"].reshape(1, h + 1, 2), h + 1, mesh, axis_name)
        unt = _untangle_map(h, mesh, axis_name)
        scale = normalize_scale(normalize, "forward", n)

        def local(x):
            # adjacent real pairs ARE the interleaved complex line v[m]
            v = x.reshape(x.shape[0], -1, 2)
            return _scaled(_untangle(fftc.local_flat(v), unt, ca, cb), scale)

    fn = _io(local, mesh, in_spec, out_spec, (n,), (packed, 2))
    fn.split = fftc.split
    return fn


def build_distributed_c2r_1d(n: int, mesh, axis_name: str = "sp",
                             normalize: str = "none",
                             batch_axis_name: Optional[str] = None):
    """Distributed packed-complex -> real inverse 1D FFT, the mirror of
    ``build_distributed_r2c_1d``.  x: (batch, n//2 + 1, 2) -> (batch, n)."""
    from ..plans.transforms import _half_trick_consts
    packed = n // 2 + 1
    in_spec = (batch_axis_name, axis_name, None)
    out_spec = (batch_axis_name, axis_name)
    if n % 2 or choose_distributed_split(n // 2, axis_size(mesh, axis_name)) is None:
        ifftc = build_distributed_fft_any_1d(n, mesh, axis_name, "inverse",
                                             "none", batch_axis_name)
        # bin k > n//2 reads conj(packed[n-k]); bin 0's imag is zeroed
        mirror = np.concatenate([np.arange(packed), np.arange(n - packed, 0, -1)])
        conj_mask = np.concatenate([np.ones(packed), -np.ones(n - packed)])
        mir = _amap(mesh, axis_name, [packed], [(0, mirror)])
        cm = _rows(np.stack([np.ones(n), conj_mask], -1)[None], n, mesh, axis_name)
        m0 = np.ones((1, packed, 2), np.float32)
        m0[0, 0, 1] = 0.0
        m0 = _rows(m0, packed, mesh, axis_name)
        scale = normalize_scale(normalize, "inverse", n)

        def local(xp):
            f = remap(mir, 1, xp * m0) * cm
            return _scaled(ifftc.local_flat(f)[..., 0], scale)

        fn = _io(local, mesh, in_spec, out_spec, (packed, 2), (n,))
        fn.split = ifftc.split
        return fn
    h = n // 2
    ifftc = build_distributed_fft_any_1d(h, mesh, axis_name, "inverse", "none",
                                         batch_axis_name)
    cc = _half_trick_consts(n, inverse=True)
    tabs = _retangle_tables(h, (), mesh, axis_name, cc["cr/ca"], cc["cr/cb"])
    scale = normalize_scale(normalize, "inverse", n)

    def local(xp):
        z = ifftc.local_flat(_retangle(xp, tabs))
        # (re, im) pairs ARE (x[2m], x[2m+1])
        return _scaled(z.reshape(z.shape[0], -1), scale)

    fn = _io(local, mesh, in_spec, out_spec, (packed, 2), (n,))
    fn.split = ifftc.split
    return fn


def _local_rest_axis_plans(rest, direction: str, tuning, mesh, prefix="dr"):
    """Einsum axis plans and their tables (on the mesh's device) for the
    locally transformed riding axes of an ND distributed plan (logical
    axes 1..rank-1)."""
    from ..core.axis import build_axis_plan
    from ..spec import TuningSpec
    tuning = tuning if tuning is not None else TuningSpec()
    plans, consts = [], {}
    for d, m in enumerate(rest):
        ap = build_axis_plan(m, d + 1, direction, tuning, f"{prefix}{d}")
        consts.update(ap.consts())
        plans.append(ap)
    dev = mesh_device(mesh)
    return plans, {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                   for k, v in consts.items()}


def _apply_rest(y, plans, consts, first_dim: int):
    """Riding axis d at array dim first_dim + d, last axis first (as
    engine.apply_nd)."""
    from ..core.axis import apply_along_axis
    if y.numel() == 0:                 # an empty shard of an uneven split
        return y
    for d in range(len(plans) - 1, -1, -1):
        if plans[d].n > 1:
            y = apply_along_axis(y, plans[d], first_dim + d, consts)
    return y


def _nd_core(shape, mesh, axis_name, direction, batch_axis_name, pencil_axes):
    """The complex core of the ND real transforms and its per-rank body
    ``core.run`` (contiguous shard in, contiguous shard out)."""
    if pencil_axes is not None:
        core = build_distributed_pencil_axes01(shape, mesh, tuple(pencil_axes),
                                               direction, batch_axis_name)
        core.run = core.local
    else:
        core = build_distributed_fft_any_axis0(shape, mesh, axis_name, direction,
                                               "none", batch_axis_name)
        core.run = core.local_flat
    return core


def _use_half(n0: int, ndev: int, pencil_axes) -> bool:
    # route priority: half-trick four-step when n0/2 splits > widen
    # four-step when n0 splits > half-trick Bluestein (even n0) > widen
    # Bluestein.  Pencil always widens: the half-complex unpack conjugates,
    # which does not commute with the axis-1 FFT inside the pencil core.
    even = n0 % 2 == 0 and n0 >= 4
    return pencil_axes is None and even and (
        choose_distributed_split(n0 // 2, ndev) is not None
        or choose_distributed_split(n0, ndev) is None)


def _nd_specs(rest, batch_axis_name, axis_name, pencil_axes):
    """(real-side spec, complex-side spec) of the ND real transforms."""
    if pencil_axes is not None:
        lead = (batch_axis_name, pencil_axes[0], pencil_axes[1])
        tail = (None,) * (len(rest) - 1)
    else:
        lead = (batch_axis_name, axis_name)
        tail = (None,) * len(rest)
    return lead + tail, lead + tail + (None,)


def build_distributed_r2c_nd(shape, mesh, axis_name: str = "sp",
                             normalize: str = "none",
                             batch_axis_name: Optional[str] = None,
                             tuning=None, pencil_axes=None):
    """Distributed ND real -> packed-complex FFT, axis 0 spanning ranks
    (packed), the other axes transformed locally on the packed shard.
    ``pencil_axes`` routes the complex core through the axes-0/1 pencil.
    x: (batch, *shape) real -> (batch, n0//2+1, *shape[1:], 2), sharded as
    the input (axis 0 over ``axis_name``, or axes 0 and 1 over the pencil)."""
    from ..plans.transforms import _half_trick_consts
    n0, rest = shape[0], tuple(shape[1:])
    assert rest, "rank >= 2 (use build_distributed_r2c_1d for rank 1)"
    p0 = n0 // 2 + 1
    a0 = pencil_axes[0] if pencil_axes else axis_name
    ndev = axis_size(mesh, a0)
    scale = normalize_scale(normalize, "forward", math.prod(shape))
    skip = 1 if pencil_axes else 0           # the pencil core covers axis 1 too
    plans, consts = _local_rest_axis_plans(rest[skip:], "forward", tuning, mesh)
    in_spec, out_spec = _nd_specs(rest, batch_axis_name, axis_name, pencil_axes)

    def finish(y):
        return _scaled(_apply_rest(y, plans, consts, 2 + skip), scale)

    if not _use_half(n0, ndev, pencil_axes):
        fft0 = _nd_core(shape, mesh, axis_name, "forward", batch_axis_name,
                        pencil_axes)
        crop = _amap(mesh, a0, [n0], [(0, np.arange(p0))])

        def local(x):
            z = fft0.run(torch.stack([x, torch.zeros_like(x)], dim=-1))
            return finish(remap(crop, 1, z))
    else:
        h = n0 // 2
        fft0 = _nd_core((h, *rest), mesh, axis_name, "forward", batch_axis_name,
                        None)
        cc = _half_trick_consts(n0, inverse=False)
        cshape = (1, p0) + (1,) * len(rest) + (2,)
        ca = _rows(cc["rc/ca"].reshape(cshape), p0, mesh, axis_name)
        cb = _rows(cc["rc/cb"].reshape(cshape), p0, mesh, axis_name)
        unt = _untangle_map(h, mesh, axis_name)
        # adjacent axis-0 real pairs ARE the interleaved complex line: shard
        # by shard when the shards hold whole pairs in the half line's
        # layout, else one exchange gathers each rank's pairs
        pairs = (None if n0 % (2 * ndev) == 0 else _amap(
            mesh, axis_name, [n0], [(0, 2 * np.arange(h)), (0, 2 * np.arange(h) + 1)]))

        def local(x):
            if pairs is None:
                v = torch.movedim(x.reshape(x.shape[0], -1, 2, *rest), 2, -1)
            else:
                v = torch.stack(remap(pairs, 1, x), dim=-1)
            return finish(_untangle(fft0.run(v), unt, ca, cb))

    fn = _io(local, mesh, in_spec, out_spec, shape, (p0, *rest, 2))
    fn.split = fft0.split
    return fn


def build_distributed_c2r_nd(shape, mesh, axis_name: str = "sp",
                             normalize: str = "none",
                             batch_axis_name: Optional[str] = None,
                             tuning=None, pencil_axes=None):
    """Distributed ND packed-complex -> real inverse FFT, the mirror of
    ``build_distributed_r2c_nd``.
    x: (batch, n0//2+1, *shape[1:], 2) -> (batch, *shape) real."""
    from ..plans.transforms import _half_trick_consts
    n0, rest = shape[0], tuple(shape[1:])
    assert rest, "rank >= 2 (use build_distributed_c2r_1d for rank 1)"
    p0 = n0 // 2 + 1
    a0 = pencil_axes[0] if pencil_axes else axis_name
    ndev = axis_size(mesh, a0)
    scale = normalize_scale(normalize, "inverse", math.prod(shape))
    skip = 1 if pencil_axes else 0
    plans, consts = _local_rest_axis_plans(rest[skip:], "inverse", tuning, mesh)
    out_spec, in_spec = _nd_specs(rest, batch_axis_name, axis_name, pencil_axes)

    if not _use_half(n0, ndev, pencil_axes):
        ifft0 = _nd_core(shape, mesh, axis_name, "inverse", batch_axis_name,
                         pencil_axes)
        k_max = n0 // 2 - 1 if n0 % 2 == 0 else n0 // 2
        # ND Hermitian mirror X[(N-k) mod N] = conj(X[k]): axis-0 bin k >=
        # p0 reads bin n0-k of the mirror M, M = conj(X) with every riding
        # axis flipped and wrapped (its index -j mod n); the pencil's axis
        # 1 is sharded, so its flip is an exchange over pencil_axes[1]
        k = np.arange(n0)
        unpack = _amap(mesh, a0, [p0, p0], [
            (0, np.where(k < p0, k, -1)),
            (1, np.where((k >= p0) & (n0 - k >= 1) & (n0 - k <= k_max), n0 - k, -1))])
        wrap1 = (_amap(mesh, pencil_axes[1], [rest[0]], [(0, (-np.arange(rest[0])) % rest[0])])
                 if pencil_axes else None)

        def local(xp):
            mir = _conj(xp)
            for d in range(2 + skip, mir.ndim - 1):
                mir = torch.roll(torch.flip(mir, dims=(d,)), 1, dims=d)
            if wrap1 is not None:
                mir = remap(wrap1, 2, mir)
            lo, hi = remap(unpack, 1, xp, mir)
            z = _apply_rest(ifft0.run(lo + hi), plans, consts, 2 + skip)
            return _scaled(z[..., 0], scale)
    else:
        h = n0 // 2
        ifft0 = _nd_core((h, *rest), mesh, axis_name, "inverse", batch_axis_name,
                         None)
        cc = _half_trick_consts(n0, inverse=True)
        tabs = _retangle_tables(h, rest, mesh, axis_name, cc["cr/ca"], cc["cr/cb"])
        k = np.arange(n0)
        unpairs = (None if n0 % (2 * ndev) == 0 else _amap(
            mesh, axis_name, [h, h], [(0, np.where(k % 2 == 0, k // 2, -1)),
                                      (1, np.where(k % 2 == 1, k // 2, -1))]))

        def local(xp):
            # inverse-transform the riding axes first (on the packed domain)
            y = _apply_rest(xp, plans, consts, 2)
            z = ifft0.run(_retangle(y, tabs))
            if unpairs is not None:
                re, im = remap(unpairs, 1, z[..., 0], z[..., 1])
                return _scaled(re + im, scale)
            out = torch.movedim(z, -1, 2)
            return _scaled(out.reshape(out.shape[0], -1, *rest), scale)

    fn = _io(local, mesh, in_spec, out_spec, (p0, *rest, 2), shape)
    fn.split = ifft0.split
    return fn


# ---------------------------------------------------------------------------
# Trig transforms
# ---------------------------------------------------------------------------

_TRIG_ALIAS = {"dct2": "dct3", "dct3": "dct2", "dst2": "dst3", "dst3": "dst2"}
_TRIG14 = ("dct1", "dst1", "dct4", "dst4")


def _trig_rest(rest, kind: str, eff: str, direction: str, tuning, mesh,
               guard: bool):
    """The riding axes of an ND distributed trig plan: the local per-axis
    trig machinery of plans/transforms.build_dct (FFT embedding from
    tuning.dctFftMinN on, a dense full-float32 matmul below).  Returns
    apply(y) on real y (b, n0, *rest), rest axis d at dim 2 + d."""
    from ..core.axis import apply_along_axis
    from ..plans.transforms import (DCT_MATMUL_MAX_ELEMS, _apply_dct_fft_axis,
                                    _dct_axis_fft_consts)
    from ..spec import PlanError, TuningSpec
    from ..utils.mathref import trig_matrix
    tuning = tuning if tuning is not None else TuningSpec()
    mdir = "forward" if kind in _TRIG14 else direction
    modes, objs, consts = [], [], {}
    for d, m in enumerate(rest):
        if m >= tuning.dct_fft_min_n:
            ap, cc = _dct_axis_fft_consts(m, eff, f"ddct{d}", tuning)
            consts.update(cc)
            consts.update(ap.consts())
            objs.append(ap)
            modes.append("fft")
        else:
            if guard and m * m > DCT_MATMUL_MAX_ELEMS:
                raise PlanError(
                    f"{kind} riding axis {d} of length {m} would build a "
                    f"dense {m}x{m} trig table; lower tuning.dctFftMinN")
            consts[f"dtrig{d}"] = trig_matrix(kind, m, mdir).T.astype(np.float32)
            objs.append(None)
            modes.append("matmul")
    dev = mesh_device(mesh)
    consts = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
              for k, v in consts.items()}

    def apply(y):
        if y.numel() == 0:             # an empty shard of an uneven split
            return y
        for d, m in enumerate(rest):
            ax = 2 + d
            mid = ax < y.ndim - 1
            v = y.reshape(*y.shape[:ax], m, -1) if mid else y
            if modes[d] == "fft":
                def fft(vi, c, ap=objs[d], mid=mid):
                    return apply_along_axis(vi, ap, vi.ndim - (3 if mid else 2), c)
                v = _apply_dct_fft_axis(v, consts, fft, f"ddct{d}", eff, m, mid=mid)
            else:
                v = einsum("...aL,ak->...kL" if mid else "...a,ak->...k",
                           v, consts[f"dtrig{d}"])
            y = v.reshape(y.shape)
        return y

    return apply


def _trig23_stages(n: int, eff: str, mesh, axis_name, lead_shape):
    """Tables and exchanges of the dct2/dct3-family axis-0 embedding
    (even/odd reorder + half-sample phase twist) on shards of axis 0,
    broadcast over ``lead_shape`` riding dims."""
    from ..plans.transforms import _dct_reorder_perms
    perm, inv = _dct_reorder_perms(n)
    w = np.exp(-1j * np.pi * np.arange(n) / (2 * n))
    cshape = (1, n) + (1,) * len(lead_shape) + (2,)
    rshape = (1, n) + (1,) * len(lead_shape)
    k = np.arange(n)
    sgn = np.where(k % 2 == 0, 1.0, -1.0).reshape(rshape)
    t = {"sgn": _rows(sgn, n, mesh, axis_name)}
    if eff in ("dct2", "dst2"):
        wa, wb = const_pair(w)
        t["perm"] = _amap(mesh, axis_name, [n], [(0, perm)])
        t["flip"] = _amap(mesh, axis_name, [n], [(0, n - 1 - k)])
    else:
        wa, wb = const_pair(0.5 * np.conj(w))
        xm = np.concatenate([[0], np.arange(n - 1, 0, -1)])
        # dst3 = altsign(dct3(flip(x))): the flip folds into both reads
        src = n - 1 - k if eff == "dst3" else k
        t["pre"] = _amap(mesh, axis_name, [n], [(0, src), (0, src[xm])])
        t["xm0"] = _rows(np.concatenate([[0.0], np.ones(n - 1)]).reshape(rshape),
                         n, mesh, axis_name)
        t["inv"] = _amap(mesh, axis_name, [n], [(0, inv)])
    t["wa"] = _rows(wa.reshape(cshape), n, mesh, axis_name)
    t["wb"] = _rows(wb.reshape(cshape), n, mesh, axis_name)
    return t


def _trig23_apply(x, fft0, eff: str, t):
    """dct2/dct3-family along dim 1 of this rank's shard of real x around
    the distributed complex FFT's per-rank body ``fft0`` (flat shards)."""
    dst = eff.startswith("dst")
    if eff in ("dct2", "dst2"):
        if dst:                                  # dst2 = flip(dct2(altsign(x)))
            x = x * t["sgn"]
        v = remap(t["perm"], 1, x)
        V = fft0(torch.stack([v, torch.zeros_like(v)], dim=-1))
        y = cmul_const(V, t["wa"], t["wb"])[..., 0]
        return remap(t["flip"], 1, y) if dst else y
    xs, xm = remap(t["pre"], 1, x)
    u = cmul_const(torch.stack([xs, -xm * t["xm0"]], dim=-1), t["wa"], t["wb"])
    y = remap(t["inv"], 1, fft0(u)[..., 0])              # Re(IFFT_unnorm)
    return y * t["sgn"] if dst else y


def _trig14_embed(n: int, kind: str):
    """(work_len, pre-twiddle pair or None, post pair or None) for the
    self-inverse trig embeddings."""
    if kind == "dct1":
        return 2 * n - 2, None, None
    if kind == "dst1":
        return 2 * n + 2, None, None
    nn = np.arange(n, dtype=np.float64)
    pre = (np.cos(np.pi * nn / (2 * n)), -np.sin(np.pi * nn / (2 * n)))
    post = np.exp(-1j * np.pi * (2 * nn + 1) / (4 * n))
    return 2 * n, pre, (post.real, post.imag)


def _trig14_stages(n: int, kind: str, mesh, axis_name, nrest: int):
    """The embedding of a self-inverse trig type along axis 0 on shards:
    (work_len, build(x) -> interleaved work shard, post(V) -> real shard).
    dct1: [x, flip(x[1:n-1])]; dst1: [0, x, 0, -flip(x)]; dct4/dst4: the
    pre-twiddled line zero-padded to 2n; each read is one exchange."""
    m, pre, post = _trig14_embed(n, kind)
    k = np.arange(m)
    sign = None
    if kind == "dct1":
        idx = np.where(k < n, k, 2 * n - 2 - k)
    elif kind == "dst1":
        idx = np.where((k >= 1) & (k <= n), k - 1,
                       np.where(k >= n + 2, 2 * n + 1 - k, -1))
        sign = _rows(np.where(k >= n + 2, -1.0, 1.0).reshape((1, m) + (1,) * nrest),
                     m, mesh, axis_name)
    else:
        idx = np.where(k < n, k, -1)
    build_map = _amap(mesh, axis_name, [n], [(0, idx)])
    post_map = _amap(mesh, axis_name, [m],
                     [(0, np.arange(n) + (1 if kind == "dst1" else 0))])
    bshape = (1, n) + (1,) * nrest
    if pre is not None:
        pre = tuple(_rows(p.reshape(bshape), n, mesh, axis_name) for p in pre)
        post = tuple(_rows(p.reshape(bshape), n, mesh, axis_name) for p in post)

    def build(x):
        if pre is not None:
            return remap(build_map, 1, torch.stack([x * pre[0], x * pre[1]], dim=-1))
        v = remap(build_map, 1, x)
        if sign is not None:
            v = v * sign
        return torch.stack([v, torch.zeros_like(v)], dim=-1)

    def finish(V):
        U = remap(post_map, 1, V)
        ur, ui = U[..., 0], U[..., 1]
        if kind == "dct1":
            return ur
        if kind == "dst1":
            return ui * (-0.5)
        if kind == "dct4":
            return ur * post[0] - ui * post[1]
        return -(ui * post[0] + ur * post[1])

    return m, build, finish


def build_distributed_trig_1d(n: int, kind: str, mesh, axis_name: str = "sp",
                              direction: str = "forward",
                              normalize: str = "none",
                              batch_axis_name: Optional[str] = None):
    """Distributed 1D DCT/DST, all eight types: the per-type embedding runs
    as pointwise stages and exchanges of the sharded line around the
    distributed c2c.  x: (batch, n) real -> (batch, n) real, sharded."""
    return build_distributed_trig_nd((n,), kind, mesh, axis_name, direction,
                                     normalize, batch_axis_name)


def build_distributed_trig_nd(shape, kind: str, mesh, axis_name: str = "sp",
                              direction: str = "forward",
                              normalize: str = "none",
                              batch_axis_name: Optional[str] = None,
                              tuning=None):
    """Distributed ND DCT/DST with axis 0 spanning ranks: the axis-0
    embedding around the distributed axis-0 FFT (riding axes carried
    through), then the local per-axis trig machinery on the other axes.
    x: (batch, *shape) real -> (batch, *shape) real, axis 0 sharded."""
    shape = tuple(shape)
    n0, rest = shape[0], shape[1:]
    scale = normalize_scale(normalize, direction, math.prod(shape))
    spec = (batch_axis_name, axis_name) + (None,) * len(rest)
    if kind in _TRIG14:
        m, build, finish = _trig14_stages(n0, kind, mesh, axis_name, len(rest))
        fft0 = build_distributed_fft_any_axis0((m,) + rest, mesh, axis_name,
                                               "forward", "none", batch_axis_name)
        local_rest = _trig_rest(rest, kind, kind, "forward", tuning, mesh, True)

        def local(x):
            return _scaled(local_rest(finish(fft0.local_flat(build(x)))), scale)
    else:
        if kind not in _TRIG_ALIAS:
            raise ValueError(f"distributed trig supports dct1..4/dst1..4, got {kind!r}")
        eff = kind if direction == "forward" else _TRIG_ALIAS[kind]
        fdir = "forward" if eff in ("dct2", "dst2") else "inverse"
        fft0 = build_distributed_fft_any_axis0(shape, mesh, axis_name, fdir, "none",
                                               batch_axis_name)
        t = _trig23_stages(n0, eff, mesh, axis_name, rest)
        local_rest = _trig_rest(rest, kind, eff, direction, tuning, mesh, False)

        def local(x):
            return _scaled(local_rest(_trig23_apply(x, fft0.local_flat, eff, t)),
                           scale)

    fn = _io(local, mesh, spec, spec, shape, shape)
    fn.split = fft0.split
    return fn


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

def _kernel_shard(kernel, mesh, shape, spec, batch_axis_name=None):
    """This rank's shard of a time-domain kernel (*shape, 2) |
    (kc, *shape, 2) as (kc, *shape, 2) under ``spec`` (its kc dim whole).
    The shard meets this rank's batch shard only, so its gradient is summed
    over ``batch_axis_name`` (``psum_grad``); over the sharded dims the
    distributed transforms carry it."""
    kernel = as_global(kernel, mesh)
    if kernel.ndim == len(shape) + 1 and isinstance(kernel, DTensor):
        k = shard_in(kernel, mesh, spec[1:], (*shape, 2))[None]
    else:
        if kernel.ndim == len(shape) + 1:
            kernel = kernel[None]
        k = shard_in(kernel, mesh, spec, (kernel.shape[0], *shape, 2))
    return psum_grad(k, mesh, [batch_axis_name])


def _fold_map(n: int, m: int, mode: str, mesh, axis_name):
    """Fold a length-m padded-circular convolution / correlation result
    back to circular length n (m >= 2n-1), as (head, tail) reads of one
    exchange: convolution folds the tail [n, 2n-1) onto [0, n-1);
    correlation's negative lags sit at the END of m and fold onto [1, n)."""
    k = np.arange(n)
    if mode == "convolution":
        tail = np.where(k < n - 1, n + k, -1)
    else:
        tail = np.where(k >= 1, m - n + k, -1)
    return _amap(mesh, axis_name, [m], [(0, k), (0, tail)])


def _spectral_product(xf, kf):
    """(1, b, ..., 2) x (kc, 1, ..., 2) complex product -> (kc, b, ..., 2)."""
    yr = xf[..., :1] * kf[..., :1] - xf[..., 1:] * kf[..., 1:]
    yi = xf[..., :1] * kf[..., 1:] + xf[..., 1:] * kf[..., :1]
    return torch.cat([yr, yi], dim=-1)


def _conv_mode(mode: str):
    if mode not in ("convolution", "correlation"):
        raise ValueError(f"mode must be convolution|correlation, got {mode}")


def build_distributed_fftconv_nd(shape, mesh, axis_name: str = "sp",
                                 mode: str = "convolution",
                                 batch_axis_name: Optional[str] = None):
    """Distributed circular ND FFT convolution: logical axis 0 spans ranks
    (distributed four-step), the remaining axes transform locally on each
    shard of the (k2, k1) grid, and the inverse runs with the swapped split
    so the product grid feeds it directly: two all_to_alls, plus the ones
    that lay the flat line out as digits and back.  Lengths with no
    mesh-divisible split run the same pipeline at a smooth padded work
    length (a zero-pad exchange in) and fold back mod n0 (one exchange out).

    fn(x, kernel): x (batch, *shape, 2), kernel (*shape, 2) |
    (1, *shape, 2) | (kcount, *shape, 2) -> (batch, *shape, 2), or
    kernel-major (kcount, batch, *shape, 2) when kcount > 1; axis 0 sharded
    over ``axis_name``."""
    _conv_mode(mode)
    shape = tuple(shape)
    rest = shape[1:]
    ndev = axis_size(mesh, axis_name)
    n0 = shape[0]
    work0 = (n0 if choose_distributed_split(n0, ndev) is not None
             else smooth_distributed_len_at_least(max(2 * n0 - 1, ndev * ndev), ndev))
    wshape = (work0, *rest)
    fwd0 = build_distributed_fft_axis0(wshape, mesh, axis_name, "forward",
                                       batch_axis_name=batch_axis_name)
    n1, n2 = fwd0.split
    inv0 = build_distributed_fft_axis0(wshape, mesh, axis_name, "inverse",
                                       "backward", batch_axis_name=batch_axis_name,
                                       split=(n2, n1))
    fplans, fconsts = _local_rest_axis_plans(rest, "forward", None, mesh, "df")
    iplans, iconsts = _local_rest_axis_plans(rest, "inverse", None, mesh, "di")
    rest_scale = 1.0 / math.prod(rest) if rest else 1.0
    group = group_of(mesh, axis_name)
    tail = (None,) * (len(rest) + 1)
    kspec = (None, axis_name) + tail
    xspec = (batch_axis_name, axis_name) + tail
    out_spec = (None, batch_axis_name, axis_name) + tail
    padded = work0 != n0
    if padded:
        ar = np.arange(work0)
        pad = _amap(mesh, axis_name, [n0], [(0, np.where(ar < n0, ar, -1))])
        fold = _fold_map(n0, work0, mode, mesh, axis_name)

    def spectrum(v):                                   # flat shard -> grid
        if padded:
            v = remap(pad, 1, v)
        return _apply_rest(fwd0.local(_flat_to_grid_local(v, group, n1, ndev)),
                           fplans, fconsts, 3)

    def fn(x, kernel):
        k_loc = _kernel_shard(kernel, mesh, shape, kspec, batch_axis_name)
        kc = k_loc.shape[0]
        x = as_global(x, mesh)
        b = x.shape[0]
        kf = spectrum(k_loc)
        if mode == "correlation":
            kf = _conj(kf)
        xf = spectrum(shard_in(x, mesh, xspec, (b, *shape, 2)))
        y = _spectral_product(xf[None], kf[:, None])      # (kc, b_loc, grid, 2)
        bl = y.shape[1]
        y = _apply_rest(y.reshape(kc * bl, *y.shape[2:]), iplans, iconsts, 3)
        if rest_scale != 1.0:
            y = y * rest_scale
        z = _grid_to_flat_local(inv0.local(y), group)      # (kc*b_loc, w_loc, ..)
        if padded:
            head, back = remap(fold, 1, z)
            z = head + back
        z = shard_out(z.reshape(kc, bl, *z.shape[1:]), mesh, out_spec,
                      (kc, b, *shape, 2))
        return _drop_lead(z, mesh) if kc == 1 else z

    fn.split = (n1, n2)
    if padded:
        fn.padded_work_len = work0
    return fn


def build_distributed_fftconv_1d(n: int, mesh, axis_name: str = "sp",
                                 mode: str = "convolution",
                                 batch_axis_name: Optional[str] = None):
    """Distributed circular FFT convolution / correlation over one giant
    line (the rank-1 case of ``build_distributed_fftconv_nd``).

    fn(x, kernel): x (batch, n, 2), kernel (n, 2) | (1, n, 2) |
    (kcount, n, 2) -> (batch, n, 2), or kernel-major (kcount, batch, n, 2)
    when kcount > 1."""
    return build_distributed_fftconv_nd((n,), mesh, axis_name, mode,
                                        batch_axis_name)


def build_distributed_fftconv_pencil(shape, mesh,
                                     axes: Tuple[str, str] = ("sp0", "sp1"),
                                     mode: str = "convolution",
                                     batch_axis_name: Optional[str] = None):
    """Distributed circular ND FFT convolution on a 2-D pencil
    decomposition: logical axes 0 and 1 each span their own mesh dim; the
    remaining axes transform locally on each pencil.  Same contract as
    ``build_distributed_fftconv_nd``."""
    _conv_mode(mode)
    shape = tuple(shape)
    if len(shape) < 2:
        raise ValueError("pencil fftconv needs rank >= 2")
    rest = shape[2:]
    fwd = build_distributed_pencil_axes01(shape, mesh, axes, "forward",
                                          batch_axis_name)
    s0, s1 = fwd.split
    swapped = ((s0[1], s0[0]), (s1[1], s1[0]))
    inv = build_distributed_pencil_axes01(shape, mesh, axes, "inverse",
                                          batch_axis_name, splits=swapped)
    fplans, fconsts = _local_rest_axis_plans(rest, "forward", None, mesh, "pf")
    iplans, iconsts = _local_rest_axis_plans(rest, "inverse", None, mesh, "pi")
    inv_scale = 1.0 / math.prod(shape)            # whole-volume backward 1/N
    a0, a1 = axes
    rest_none = (None,) * len(rest)
    kspec = (None, a0, a1, *rest_none, None)
    out_spec = (None, batch_axis_name, a0, a1, *rest_none, None)

    def fn(x, kernel):
        k_loc = _kernel_shard(kernel, mesh, shape, kspec, batch_axis_name)
        kc = k_loc.shape[0]
        x = as_global(x, mesh)
        b = x.shape[0]
        # riding axes first on the forward, the pencil exchange after; the
        # inverse mirrors it
        kf = fwd.local(_apply_rest(k_loc, fplans, fconsts, 3))
        if mode == "correlation":
            kf = _conj(kf)
        kf = kf * inv_scale
        x_loc = shard_in(x, mesh, fwd.spec, (b, *shape, 2))
        xf = fwd.local(_apply_rest(x_loc, fplans, fconsts, 3))
        y = _spectral_product(xf[None], kf[:, None])
        bl = y.shape[1]
        y = _apply_rest(y.reshape(kc * bl, *y.shape[2:]), iplans, iconsts, 3)
        z = inv.local(y)
        z = shard_out(z.reshape(kc, bl, *z.shape[1:]), mesh, out_spec,
                      (kc, b, *shape, 2))
        return _drop_lead(z, mesh) if kc == 1 else z

    fn.split = (s0, s1)
    return fn


def halo_conv_geometry(n: int, k: int, ndev: int,
                       boundary: str) -> Optional[Tuple[int, int]]:
    """(C, n_ext) for the halo-exchange convolution, or None when the shape
    cannot take the route.  C is the per-rank shard length; n_ext = ndev*C
    the padded signal.  Linear modes round C up until the per-shard FFT
    length C + 2(k-1) is smooth; circular needs ndev | n exactly."""
    pad_k = k - 1
    if k < 2:
        return None
    if boundary == "circular":
        if n % ndev:
            return None
        C = n // ndev
        return (C, n) if C >= pad_k else None
    C = -(-(n + pad_k) // ndev)
    if C < pad_k:
        return None
    for _ in range(4096):
        if factors.is_smooth(C + 2 * pad_k):
            return C, ndev * C
        C += 1
    return None


def build_distributed_fftconv_halo_1d(n: int, k: int, batch: int, mesh,
                                      axis_name: str = "sp",
                                      boundary: str = "linear-full",
                                      batch_axis_name: Optional[str] = None,
                                      tuning=None, overlap_save: str = "auto",
                                      overlap_block: Optional[int] = None):
    """Halo-exchange distributed 1-D convolution, the rank-1 case of
    ``build_distributed_fftconv_halo_nd``.
    fn(x, kernel): x (batch, n, 2), kernel (k, 2) -> (batch, out_len, 2)."""
    return build_distributed_fftconv_halo_nd(
        [n], [k], batch, mesh, axis_name, boundary, batch_axis_name,
        tuning=tuning, overlap_save=overlap_save, overlap_block=overlap_block)


def build_distributed_fftconv_halo_nd(shape, kshape, batch: int, mesh,
                                      axis_name: str = "sp",
                                      boundary: str = "linear-full",
                                      batch_axis_name: Optional[str] = None,
                                      tuning=None, overlap_save: str = "auto",
                                      overlap_block: Optional[int] = None):
    """ND halo-exchange convolution: logical axis 0 shards contiguously
    with a (k0-1)-slab ppermute halo; the remaining axes convolve locally
    per shard, through the port's local fftconv plan (K1/K2 on the card).
    No all_to_all: the zero tail of axis 0 and its boundary crop are shifts
    of the sharded axis (point-to-point, as XLA's collective-permutes).

    fn(x, kernel): x (batch, *shape, 2), kernel (*kshape, 2) ->
    (batch, *out_shape, 2)."""
    from ..plans.fftconv import build_fftconv
    from ..spec import normalize_spec
    from ..utils.mathref import fftconv_out_shape

    shape, kshape = tuple(shape), tuple(kshape)
    rank = len(shape)
    ndev = axis_size(mesh, axis_name)
    n0, k0 = shape[0], kshape[0]
    pad0 = k0 - 1
    _, out_shape, out_off = fftconv_out_shape(list(shape), list(kshape), boundary)
    geom = halo_conv_geometry(n0, k0, ndev, boundary)
    if geom is None:
        raise ValueError(
            f"halo conv infeasible for n0={n0}, k0={k0}, ndev={ndev}, "
            f"{boundary}; use the spectrum route")
    C, n0_ext = geom
    b_loc = batch
    if batch_axis_name is not None:
        if batch % axis_size(mesh, batch_axis_name):
            raise ValueError(f"batch {batch} must divide the "
                             f"{batch_axis_name} axis")
        b_loc = batch // axis_size(mesh, batch_axis_name)
    # non-0 axes: (left, right) pads turning the boundary into a local
    # linear-valid window, plus extra right pad for a smooth local FFT len
    rest_pads, rest_crop, lshape = [], [], [C + pad0]
    for d in range(1, rank):
        m, pd = shape[d], kshape[d] - 1
        if boundary in ("linear-full", "linear-same"):
            left, right_p = pd, pd
            crop0 = out_off[d] if boundary == "linear-same" else 0
        else:                   # linear-valid; circular wraps at exec
            left, right_p, crop0 = 0, 0, 0
        ln = m + left + right_p + (pd if boundary == "circular" else 0)
        smooth = factors.next_smooth_at_least(ln + pd) - pd
        right_p += smooth - ln
        rest_pads.append((left, right_p))
        rest_crop.append((crop0, out_shape[d]))
        lshape.append(smooth)
    fopts = {}
    if rank == 1:
        fopts = {"overlapSave": overlap_save}
        if overlap_block is not None:
            fopts["overlapBlock"] = overlap_block
    lspec = normalize_spec({
        "type": "fftconv", "shape": lshape, "batch": b_loc,
        "tuning": ({"maxSubLength": tuning.max_sub_length,
                    "matmulPrecision": tuning.matmul_precision}
                   if tuning is not None else {}),
        "fftConv": {"boundary": "linear-valid",
                    "kernelShape": list(kshape), "tuning": fopts}})
    lplan = build_fftconv(lspec, mesh_device(mesh))
    group = group_of(mesh, axis_name)
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]
    spec = (batch_axis_name, axis_name) + (None,) * rank
    pads = []
    for left, right in reversed(rest_pads):
        pads += [left, right]
    pads = [0, 0] + pads                       # the component dim stays
    kn = math.prod(kshape)

    def local(x_loc, kernel):                  # x_loc (b_loc, C, *rest, 2)
        halo = ppermute(x_loc[:, C - pad0:C], group, perm)
        if boundary != "circular" and axis_index(mesh, axis_name) == 0:
            halo = torch.zeros_like(halo)      # rank 0 has no left neighbour
        xin = torch.cat([halo, x_loc], dim=1)
        if boundary == "circular":
            # non-0 axes wrap: prepend each axis's own (k_d - 1) tail
            for d in range(1, rank):
                pd = kshape[d] - 1
                if pd:
                    ax = 1 + d
                    m = xin.shape[ax]
                    xin = torch.cat([xin.narrow(ax, m - pd, pd), xin], dim=ax)
        xin = F.pad(xin, pads)
        y = lplan._fn(lplan._consts, xin, lplan._coerce_kernel(kernel))
        for d in range(1, rank):
            c0, clen = rest_crop[d - 1]
            y = y.narrow(1 + d, c0, clen)
        return y

    ar = np.arange(n0_ext)
    grow = _amap(mesh, axis_name, [n0], [(0, np.where(ar < n0, ar, -1))])
    crop = _amap(mesh, axis_name, [n0_ext],
                 [(0, out_off[0] + np.arange(out_shape[0]))])
    out_full = (out_off[0] == 0 and out_shape[0] == n0_ext)

    def fn(x, kernel):
        # every kernel convention the spectrum route takes: (*kshape, 2),
        # (1, *kshape, 2), packed flat (kn, 2) or (2*kn,); the kernel is
        # small and every rank holds it whole
        kernel = as_global(kernel, mesh)
        if isinstance(kernel, DTensor):
            kernel = kernel.full_tensor()
        if tuple(kernel.shape) == (1,) + kshape + (2,):
            kernel = kernel[0]
        elif tuple(kernel.shape) != kshape + (2,):
            if kernel.numel() != kn * 2:
                raise ValueError(
                    f"halo conv kernel shape {tuple(kernel.shape)} not "
                    f"understood; expected {kshape + (2,)} or a packed "
                    f"({kn}, 2) buffer")
            kernel = kernel.reshape(kshape + (2,))
        # every rank convolves its own part of (batch, axis 0) with the
        # whole kernel: its gradient is the sum of the parts'
        kernel = psum_grad(kernel, mesh, [batch_axis_name, axis_name])
        x = as_global(x, mesh)
        b = x.shape[0]
        # the zero tail to n0_ext: a tensor every rank holds pads in place,
        # a sharded one shifts (the jnp.pad at sharded.py:1580)
        x_loc = _enter(x, mesh, spec, (b, *shape, 2), grow)
        y = local(x_loc, kernel)
        if not out_full:
            y = remap(crop, 1, y)               # the boundary crop of axis 0
        return shard_out(y, mesh, spec, (b, *out_shape, 2))

    fn.split = (ndev, C)
    fn.halo = pad0
    return fn


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

def hybrid_rank_array(ici_shape, dcn_shape, ranks) -> np.ndarray:
    """Ranks arranged as ``mesh_utils.create_hybrid_device_mesh`` arranges
    devices: the ranks fall into prod(dcn_shape) granules of consecutive
    ranks (a host's processes, as ``torchrun`` numbers them); each granule
    fills an ``ici_shape`` block in order, and the blocks tile the mesh in
    ``dcn_shape`` order."""
    ranks = list(ranks)
    ng = math.prod(dcn_shape)
    per = len(ranks) // ng
    blocks = [np.asarray(ranks[i * per:(i + 1) * per]).reshape(ici_shape)
              for i in range(ng)]
    order = np.arange(ng).reshape(dcn_shape)
    nested = np.vectorize(lambda i: blocks[i], otypes=[object])(order)
    return np.block(nested.tolist())


def make_mesh(axis_sizes: dict, devices=None, *, ici_optimized: bool = True,
              dcn: Optional[dict] = None, device: str = "cuda"):
    """Build a ``DeviceMesh`` from {axis_name: size} over the ranks of the
    default process group (``devices``: a list of ranks, by default all of
    them), with the same dim names.

    ``ici_optimized`` places TPU devices by their ICI topology in the JAX
    package; it has no effect here (ranks fill the mesh in order).
    ``dcn={axis_name: hosts}`` splits named axes across hosts as
    ``mesh_utils.create_hybrid_device_mesh`` does (``hybrid_rank_array``),
    each listed axis size divisible by its factor, and the mesh must use
    every rank.  Every rank of the default group must call this (the mesh
    creates its sub-groups); a rank outside ``devices`` gets a mesh it holds
    no coordinate in.  The caller has initialised the process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    devices = list(devices) if devices is not None else list(range(dist.get_world_size()))
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[k]) for k in names)
    need = math.prod(sizes)
    if need > len(devices):
        raise ValueError(f"mesh needs {need} devices, have {len(devices)}")
    if dcn:
        unknown = set(dcn) - set(names)
        if unknown:
            raise ValueError(f"dcn axes not in the mesh: {sorted(unknown)}")
        dcn_shape, ici_shape = [], []
        for k, s in zip(names, sizes):
            f = int(dcn.get(k, 1))
            if f < 1 or s % f:
                raise ValueError(
                    f"dcn factor {f} does not divide axis {k!r} size {s}")
            dcn_shape.append(f)
            ici_shape.append(s // f)
        if need != len(devices):
            raise ValueError(
                f"a dcn (multi-host) mesh must use every device: mesh needs "
                f"{need}, fabric has {len(devices)} — size the axes to the "
                f"full fabric or pass an explicit devices= subset")
        arr = hybrid_rank_array(ici_shape, dcn_shape, devices)
    else:
        arr = np.asarray(devices[:need]).reshape(sizes)
    return DeviceMesh(device, torch.as_tensor(arr), mesh_dim_names=names)


# ---------------------------------------------------------------------------
# Sequence-parallel spectral analysis: STFT / ISTFT / Welch / CSD
# ---------------------------------------------------------------------------

def distributed_stft_geometry(n: int, nperseg: int, hop: int, ndev: int):
    """Frame geometry of the facade stft (boundary='zeros', padded=True)
    for a length-n signal: (nb, lpad, total); None when the frame count
    does not split over ndev."""
    W, H = int(nperseg), int(hop)
    lpad = W // 2
    L = n + 2 * lpad
    nb = max(-(-(L - W) // H) + 1, 1)
    if nb % ndev:
        return None
    total = (nb - 1) * H + W
    return nb, lpad, total


def _halo_check(S: int, halo: int, what: str, ndev: int):
    """The window-overlap halo must fit in ONE neighbour slab."""
    if halo > S:
        raise ValueError(
            f"{what}: the window overlap (nperseg - hop = {halo}) "
            f"exceeds the per-device slab ({S} samples over {ndev} "
            f"devices); use fewer devices, a longer signal, or a "
            f"smaller overlap")


def _halo_extend(x_loc, tail, halo: int, ndev: int, mesh, axis_name: str, perm):
    """Append the right neighbour's first ``halo`` samples (the LAST rank
    takes ``tail``, the padded signal's end)."""
    if halo <= 0:
        return x_loc
    h = ppermute(x_loc[:, :halo], group_of(mesh, axis_name), perm)
    if axis_index(mesh, axis_name) == ndev - 1:
        h = tail
    return torch.cat([x_loc, h], dim=-1)


def _signal(x, mesh, n: int):
    """A (batch, n) or (n,) real signal as (batch, n), and whether it was
    1-D (a DTensor keeps its shards)."""
    x = as_global(x, mesh)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None] if not isinstance(x, DTensor) else _lead1(x, mesh)
    if x.shape[-1] != n:
        raise ValueError(f"expected signal length {n}, got {x.shape[-1]}")
    return x, squeeze


def _lead1(x, mesh) -> DTensor:
    """A DTensor with a new unsharded lead dim of size 1, shard by shard."""
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in x.placements]
    shape = (1, *x.shape)
    return DTensor.from_local(x.to_local()[None], mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=_stride(shape))


def _slabber(mesh, axis_name, batch_axis_name, n: int, lpad: int, S: int,
             halo: int):
    """slabs(x) -> this rank's signal slab (b_loc, S) of the padded signal
    ``xp = [0]*lpad + x + zeros`` (samples [r*S, (r+1)*S)) and the tail
    ``xp[ndev*S : ndev*S + halo]`` that the LAST rank reads as its right
    neighbour (zeros elsewhere).  A signal every rank holds is sliced in
    place; a sharded one arrives by one exchange."""
    ndev = axis_size(mesh, axis_name)
    k = np.arange(ndev * S)
    body = k - lpad
    t = np.arange(ndev * halo)
    tail = np.where(t >= (ndev - 1) * halo, ndev * S - lpad + t - (ndev - 1) * halo, -1)
    body = np.where((body >= 0) & (body < n), body, -1)
    tail = np.where((tail >= 0) & (tail < n), tail, -1)
    spec = (batch_axis_name, axis_name)
    both = _amap(mesh, axis_name, [n], [(0, body), (0, tail)])
    whole = [_amap(mesh, None, [n], [(0, body)]), _amap(mesh, None, [n], [(0, tail)])]

    def slabs(x):
        if isinstance(x, DTensor):
            return remap(both, 1, shard_in(x, mesh, spec, (x.shape[0], n)))
        return tuple(shard_in(remap(w, 1, x), mesh, spec) for w in whole)

    return slabs


def _welch_frame_setup(what: str, n: int, ndev: int, window, nperseg,
                       noverlap, nfft, scaling, fs, mesh):
    """Shared geometry / scaling of the sequence-parallel Welch family:
    (W, H, m, nb, nb_loc, S, halo, win, scale_vec)."""
    from ..fftapi import _get_window, _stft_hop
    W, H = _stft_hop(what, nperseg, noverlap)
    m = int(nfft) if nfft is not None else W
    if m < W:
        raise ValueError("nfft must be >= nperseg")
    if scaling not in ("density", "spectrum"):
        raise ValueError("scaling must be 'density' or 'spectrum'")
    if n < W:
        raise ValueError(f"signal shorter than nperseg ({n} < {W})")
    nb = (n - W) // H + 1
    if nb % ndev:
        raise ValueError(
            f"{what} needs the frame count ({nb}) to split over "
            f"{ndev} devices; adjust nperseg/noverlap or crop n")
    nb_loc = nb // ndev
    S = nb_loc * H
    halo = W - H
    _halo_check(S, halo, what, ndev)
    win = _get_window(window, W)
    dbl = np.full(m // 2 + 1, 2.0, np.float64)
    dbl[0] = 1.0
    if m % 2 == 0:
        dbl[-1] = 1.0
    if scaling == "density":
        sc = 1.0 / (fs * float(np.sum(win.astype(np.float64) ** 2)))
    else:
        sc = 1.0 / float(np.sum(win.astype(np.float64))) ** 2
    sv = _table((dbl * sc / nb).astype(np.float32), mesh)
    return W, H, m, nb, nb_loc, S, halo, _table(win, mesh), sv


def build_distributed_stft(n: int, mesh, axis_name: str = "sp",
                           fs: float = 1.0, window="hann",
                           nperseg: int = 256,
                           noverlap: Optional[int] = None,
                           nfft: Optional[int] = None,
                           batch_axis_name: Optional[str] = None):
    """Sequence-parallel STFT: the signal's time axis is sharded over
    ``axis_name``; each rank frames and transforms its own slab (the
    facade ``rfft``: K1 on the card).  Communication is ONE ppermute of the
    (nperseg - hop)-sample window-overlap halo per rank.  Matches
    ``fft.stft(x, fs, window, nperseg, noverlap, nfft)`` (boundary='zeros',
    padded=True).

    Returns (f, t, fn) with fn(x): (batch, n) real -> (batch, nf, nb, 2)
    sharded along the frame axis."""
    from ..fftapi import _frame_segments, _get_window, _stft_hop, rfft

    ndev = axis_size(mesh, axis_name)
    W, H = _stft_hop("distributed stft", nperseg, noverlap)
    m = int(nfft) if nfft is not None else W
    if m < W:
        raise ValueError("nfft must be >= nperseg")
    geom = distributed_stft_geometry(n, W, H, ndev)
    if geom is None:
        raise ValueError(
            f"distributed stft needs the frame count to split over "
            f"{ndev} devices (n={n}, nperseg={W}, hop={H}); pad the "
            f"signal or change the hop")
    nb, lpad, total = geom
    nb_loc = nb // ndev
    S = nb_loc * H                       # per-rank signal slab
    halo = W - H                         # window overlap into the right
    _halo_check(S, halo, "distributed stft", ndev)
    win = _get_window(window, W)
    scale = float(np.float32(1.0 / win.sum()))
    wint = _table(win, mesh)
    perm = [((i + 1) % ndev, i) for i in range(ndev)]
    out_spec = (batch_axis_name, None, axis_name, None)
    slabs = _slabber(mesh, axis_name, batch_axis_name, n, lpad, S, halo)

    def local(x_loc, tail):
        # x_loc (b_loc, S); tail (b_loc, halo): the padded signal's last
        # (W - H) samples, the LAST rank's right neighbour
        xin = _halo_extend(x_loc, tail, halo, ndev, mesh, axis_name, perm)
        fr = _frame_segments(xin, W, H, nb_loc) * wint
        if m > W:
            fr = F.pad(fr, (0, m - W))
        Z = rfft(fr, axis=-1) * scale           # (b_loc, nb_loc, f, 2)
        return Z.transpose(-3, -2)              # (b_loc, f, nb_loc, 2)

    def fn(x):
        x, squeeze = _signal(x, mesh, n)
        b = x.shape[0]
        body, tail = slabs(x)
        Z = shard_out(local(body, tail), mesh, out_spec, (b, m // 2 + 1, nb, 2))
        return _drop_lead(Z, mesh) if squeeze else Z

    f = np.fft.rfftfreq(m, 1.0 / fs)
    t = (np.arange(nb) * H + W // 2 - lpad) / fs
    return f, t, fn


def build_distributed_istft(n: int, mesh, axis_name: str = "sp",
                            fs: float = 1.0, window="hann",
                            nperseg: int = 256,
                            noverlap: Optional[int] = None,
                            nfft: Optional[int] = None,
                            batch_axis_name: Optional[str] = None):
    """Inverse of ``build_distributed_stft``: per-frame synthesis (irfft +
    window) runs sharded along the frame axis; each rank overlap-adds its
    own slab and the (W - H)-sample seam overhangs ride ONE ppermute to the
    right neighbour.  The facade istft's COLA win^2 normalization.
    fn(Z): (batch, nf, nb, 2) -> (batch, n)."""
    from ..fftapi import _get_window, _stft_hop, irfft
    from ..shorttime import _overlap_add

    ndev = axis_size(mesh, axis_name)
    W, H = _stft_hop("distributed istft", nperseg, noverlap)
    m = int(nfft) if nfft is not None else None   # None: infer from Z
    if m is not None and m < W:
        raise ValueError("nfft must be >= nperseg")
    geom = distributed_stft_geometry(n, W, H, ndev)
    if geom is None:
        raise ValueError("frame count does not split over the mesh axis")
    nb, lpad, total = geom
    nb_loc = nb // ndev
    S = nb_loc * H
    halo = W - H
    _halo_check(S, halo, "distributed istft", ndev)
    win = _get_window(window, W).astype(np.float64)
    norm = np.zeros(total)
    for p in range(nb):
        norm[p * H:p * H + W] += win * win
    if np.min(norm[lpad:lpad + n]) <= 1e-10:
        raise ValueError("window/hop fail NOLA; istft not invertible")
    inv_norm = np.zeros_like(norm)
    nz = norm > 1e-10
    inv_norm[nz] = 1.0 / norm[nz]
    wint = _table(win.astype(np.float32), mesh)
    scale = float(np.float32(win.sum()))
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]
    in_spec = (batch_axis_name, None, axis_name, None)
    group = group_of(mesh, axis_name)

    def local(Z_loc, m_eff):
        # Z_loc (b_loc, f, nb_loc, 2) -> slab (b_loc, S) + the overhang
        fr = irfft(Z_loc.transpose(-3, -2), n=m_eff, axis=-1) * scale
        y = _overlap_add(fr[..., :W] * wint, W, H)       # (b_loc, S + halo)
        body = y[..., :S]
        if halo > 0:
            over = ppermute(y[..., S:], group, perm)
            if axis_index(mesh, axis_name) == 0:
                over = torch.zeros_like(over)
            body = torch.cat([body[..., :halo] + over, body[..., halo:]], dim=-1)
        return body, y[..., S:]

    # the output sample j is y[lpad + j] of the flat overlap-add, whose
    # samples [r*S, (r+1)*S) rank r holds and whose last ``halo`` samples
    # are the LAST rank's overhang: one exchange lays them out as (b, n)
    j = lpad + np.arange(n)
    unslab = _amap(mesh, axis_name, [ndev * S, ndev * halo], [
        (0, np.where(j < ndev * S, j, -1)),
        (1, np.where(j >= ndev * S, (ndev - 1) * halo + j - ndev * S, -1))])
    inv_norm_t = _rows(inv_norm[lpad:lpad + n].astype(np.float32)[None], n,
                       mesh, axis_name)

    def fn(Z):
        Z = as_global(Z, mesh)
        squeeze = Z.ndim == 3
        if squeeze:
            Z = Z[None] if not isinstance(Z, DTensor) else _lead1(Z, mesh)
        nf = Z.shape[-3]
        b = Z.shape[0]
        m_eff = m if m is not None else 2 * (nf - 1)
        if m_eff < W or nf != m_eff // 2 + 1:
            raise ValueError(
                f"spectrogram has {nf} frequency rows; expected "
                f"{(m if m is not None else 'nfft')}//2 + 1 (pass nfft= "
                f"matching the stft)")
        body, over = local(shard_in(Z, mesh, in_spec), m_eff)
        lo, hi = remap(unslab, 1, body, over)
        y = shard_out((lo + hi) * inv_norm_t, mesh, (batch_axis_name, axis_name),
                      (b, n))
        return _drop_lead(y, mesh) if squeeze else y

    return fn


def _welch_spectra(x_loc, tail, geo, mesh, axis_name, perm):
    from ..fftapi import _frame_segments, rfft
    W, H, m, nb, nb_loc, S, halo, win, sv = geo
    xin = _halo_extend(x_loc, tail, halo, axis_size(mesh, axis_name), mesh,
                       axis_name, perm)
    fr = _frame_segments(xin, W, H, nb_loc)
    fr = (fr - fr.mean(dim=-1, keepdim=True)) * win      # detrend, window
    if m > W:
        fr = F.pad(fr, (0, m - W))
    return rfft(fr, axis=-1)                             # (b, nb_loc, f, 2)


def build_distributed_welch(n: int, mesh, axis_name: str = "sp",
                            fs: float = 1.0, window="hann",
                            nperseg: int = 256,
                            noverlap: Optional[int] = None,
                            nfft: Optional[int] = None,
                            scaling: str = "density",
                            batch_axis_name: Optional[str] = None):
    """Sequence-parallel Welch PSD: each rank computes the mean-detrended
    windowed periodograms of its own frames and ONE psum of the (nf,)
    per-rank frame sums gives the average (the halo ppermute + one psum,
    independent of n).  Matches ``fft.welch``.  Returns (f, fn); fn(x):
    (batch, n) -> (batch, nf)."""
    ndev = axis_size(mesh, axis_name)
    geo = _welch_frame_setup("distributed welch", n, ndev, window, nperseg,
                             noverlap, nfft, scaling, fs, mesh)
    perm = [((i + 1) % ndev, i) for i in range(ndev)]
    group = group_of(mesh, axis_name)
    slabs = _slabber(mesh, axis_name, batch_axis_name, n, 0, geo[5], geo[6])

    def fn(x):
        x, squeeze = _signal(x, mesh, n)
        body, tail = slabs(x)
        Z = _welch_spectra(body, tail, geo, mesh, axis_name, perm)
        p = psum((Z[..., 0] ** 2 + Z[..., 1] ** 2).sum(dim=-2) * geo[-1], group)
        P = shard_out(p, mesh, (batch_axis_name, None),
                      (x.shape[0], geo[2] // 2 + 1))
        return _drop_lead(P, mesh) if squeeze else P

    return np.fft.rfftfreq(geo[2], 1.0 / fs), fn


def build_distributed_csd(n: int, mesh, axis_name: str = "sp",
                          fs: float = 1.0, window="hann",
                          nperseg: int = 256,
                          noverlap: Optional[int] = None,
                          nfft: Optional[int] = None,
                          scaling: str = "density",
                          batch_axis_name: Optional[str] = None):
    """Sequence-parallel cross spectral density (facade csd semantics:
    segment-averaged conj(X)*Y), the pair extension of
    ``build_distributed_welch``: the same halo + one psum of 2*nf floats.
    Returns (f, fn); fn(x, y): (batch, n) x 2 -> (batch, nf, 2)."""
    ndev = axis_size(mesh, axis_name)
    geo = _welch_frame_setup("distributed csd", n, ndev, window, nperseg,
                             noverlap, nfft, scaling, fs, mesh)
    perm = [((i + 1) % ndev, i) for i in range(ndev)]
    group = group_of(mesh, axis_name)
    slabs = _slabber(mesh, axis_name, batch_axis_name, n, 0, geo[5], geo[6])

    def fn(x, y):
        x, squeeze = _signal(x, mesh, n)
        y, _ = _signal(y, mesh, n)
        Zx = _welch_spectra(*slabs(x), geo, mesh, axis_name, perm)
        Zy = _welch_spectra(*slabs(y), geo, mesh, axis_name, perm)
        xr, xi, yr, yi = Zx[..., 0], Zx[..., 1], Zy[..., 0], Zy[..., 1]
        sv = geo[-1]
        pr = (xr * yr + xi * yi).sum(dim=-2) * sv      # Re(conj(X) Y)
        pi = (xr * yi - xi * yr).sum(dim=-2) * sv
        P = psum(torch.stack([pr, pi], dim=-1), group)
        P = shard_out(P, mesh, (batch_axis_name, None, None),
                      (x.shape[0], geo[2] // 2 + 1, 2))
        return _drop_lead(P, mesh) if squeeze else P

    return np.fft.rfftfreq(geo[2], 1.0 / fs), fn
