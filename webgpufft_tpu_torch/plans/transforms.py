"""c2c, r2c, c2r and DCT/DST plan builders.

Port of ``build_c2c``, ``build_r2c``, ``build_c2r`` and ``build_dct`` from
``webgpufft_tpu/plans/transforms.py``, minus the JAX package's TPU-only
parts (the operand-size and batch chunking, the giant-transform route and
the per-rank VMEM split).  Every builder wraps its core in the staging
pipeline of ``plans/base.build_staged_fn``.

Every complex pass of every plan (the inner FFT of an FFT-routed DCT axis
and the passes of ``plans/fftconv.py`` included) is one ``AxisPass``, chosen
by ``axis_pass`` from the array it runs on:

- last axis → K1 (core/fused.py) when a split exists and there are at least
  8 lines;
- earlier axes → K2 (core/fused_cols.py) when a split exists and the riding
  lanes number at least 128;
- any other axis → the einsum route (core/axis.py: mixed-radix, four-step,
  Rader or Bluestein).

The kernels are allowed under ``impl`` "auto", "pallas" and "pallas-auto" on
f32 plans; "xla" and bf16-storage plans keep every axis on the einsum route.
A c2c plan folds its normalize scale into the last axis's table and runs the
axes last to first.  r2c, c2r and the DCT/DST plans apply the scale in one
pass at the end, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import engine, fused, fused_cols
from ..core.axis import (AxisPlan, apply_along_axis, build_axis_plan, make_smooth_plan,
                         select_axis_kind)
from ..core.cplx import cmul_const, const_pair
from ..core.precision import full_f32
from ..runtime.policy import FUSED_MIN_BATCH, resolve_route
from ..spec import PlanError, PlanSpec
from ..utils.mathref import trig_matrix
from .base import Plan, RouteInfo, build_staged_fn


def _route_for(spec: PlanSpec) -> RouteInfo:
    kinds = tuple(select_axis_kind(n, d, spec.tuning) for d, n in enumerate(spec.shape))
    return resolve_route(spec, kinds)


def _tables(consts, prefix: str, names) -> Dict[str, torch.Tensor]:
    return {name: consts[f"{prefix}/{name}"] for name in names}


class AxisPass:
    """One c2c pass along logical axis ``d`` of an interleaved
    ``(lead, *shape, 2)`` array: K1, K2 or an einsum axis plan.

    ``kind`` is the route name ("fused-lines", "fused-cols", "xla" or
    "xla-four-step"), ``detail`` the same with the einsum axis's algorithm
    named when it is Rader or Bluestein ("xla-bluestein"), and ``scaled``
    whether the pass applies the scale it was chosen for."""

    def __init__(self, kind: str, shape: Tuple[int, ...], lead: int, d: int,
                 obj, scaled: bool):
        self.kind, self.shape, self.lead, self.d = kind, tuple(shape), lead, d
        self.obj, self.scaled = obj, scaled
        named = not kind.startswith("fused") and obj.kind in ("rader", "bluestein")
        self.detail = f"xla-{obj.kind}" if named else kind

    def __call__(self, y, c):
        shape, lead, d = self.shape, self.lead, self.d
        n = shape[d]
        if self.kind == "fused-lines":
            lines = lead * math.prod(shape[:-1])
            y = fused.fused_lines(y.reshape(lines, n, 2).contiguous(),
                                  _tables(c, self.obj, fused.TABLE_NAMES))
        elif self.kind == "fused-cols":
            pre = lead * math.prod(shape[:d])
            lanes = 2 * math.prod(shape[d + 1:])
            y = fused_cols.fused_cols(y.reshape(pre, n, lanes).contiguous(),
                                      _tables(c, self.obj, fused_cols.TABLE_NAMES))
        elif n > 1:
            y = apply_along_axis(y.reshape(lead, *shape, 2), self.obj, 1 + d, c)
        return y.reshape(lead, *shape, 2)


def kernels_allowed(spec: PlanSpec) -> bool:
    """May this plan's passes run K1/K2?  Not under ``impl: "xla"``, and not
    on a bf16-storage plan (``fused-requires-f32``, as in the JAX package)."""
    return spec.tuning.impl != "xla" and spec.precision == "f32"


def axis_pass(shape: Sequence[int], lead: int, d: int, direction: str, scale: float,
              tuning, consts: Dict[str, np.ndarray], axis_plan: AxisPlan,
              kernels: bool, prefix: str = "") -> AxisPass:
    """Choose how the c2c pass along logical axis ``d`` of an interleaved
    ``(lead, *shape, 2)`` array runs, and add its tables to ``consts``
    (a kernel's under ``{prefix}fl{d}`` or ``{prefix}fc{d}``).

    K1 and K2 (chosen only when ``kernels``) fold ``scale`` into their
    tables; on the einsum route ``axis_plan`` is rebuilt with ``scale``
    folded in when it is mixed-radix or four-step, and left unscaled
    otherwise (``AxisPass.scaled``)."""
    shape = tuple(shape)
    n, rank = shape[d], len(shape)
    if kernels and n > 1:
        if d == rank - 1:
            if (fused.choose_split(n) is not None
                    and lead * math.prod(shape[:-1]) >= FUSED_MIN_BATCH):
                name = f"{prefix}fl{d}"
                consts.update(fused.lines_consts(n, direction, scale, name))
                return AxisPass("fused-lines", shape, lead, d, name, True)
        elif (fused_cols.choose_split(n) is not None
                and 2 * math.prod(shape[d + 1:]) >= 128):
            name = f"{prefix}fc{d}"
            consts.update(fused_cols.cols_consts(n, direction, scale, name))
            return AxisPass("fused-cols", shape, lead, d, name, True)
    ap = axis_plan
    if scale != 1.0 and ap.kind in ("mixed", "four-step") and n > 1:
        ap = make_smooth_plan(n, direction, ap.prefix, tuning.max_sub_length,
                              out_scale=scale, tuning=tuning)
    consts.update(ap.consts())
    kind = "xla-four-step" if ap.kind == "four-step" else "xla"
    scaled = scale == 1.0 or getattr(ap, "out_scale", 1.0) == scale
    return AxisPass(kind, shape, lead, d, ap, scaled)


def _set_mode(route: RouteInfo, kinds: Sequence[str], tuning) -> None:
    """Route mode and impl from the passes' kinds, as ``build_c2c`` of the
    JAX package sets them; ``impl: "pallas"`` demands kernels everywhere."""
    if all(k.startswith("fused") for k in kinds):
        route.mode, route.impl = "pallas-fused", "pallas"
    elif any(k.startswith("fused") for k in kinds):
        route.mode, route.impl = "pallas-mixed", "pallas+xla"
    elif "xla-four-step" in kinds:
        route.mode, route.impl = "four-step-hbm", "xla"
    else:
        route.mode, route.impl = "xla", "xla"
    if tuning.impl == "pallas" and route.mode != "pallas-fused":
        raise PlanError(
            "tuning.impl='pallas' but the fused kernels cannot serve every "
            f"axis of this plan (per-axis: {tuple(kinds)})",
            axis_kinds=tuple(kinds), reasons=route.reasons)


def _run(passes: Sequence[AxisPass], y, c):
    """Apply passes last axis first (the passes commute)."""
    for p in reversed(passes):
        y = p(y, c)
    return y


# ---------------------------------------------------------------------------
# c2c
# ---------------------------------------------------------------------------

def build_c2c(spec: PlanSpec, device: torch.device) -> Plan:
    """ND complex FFT plan on ``device``."""
    scale = engine.plan_scale(spec.normalize, spec.direction, spec.n_total)
    route = _route_for(spec)
    rank, shape, batch, tun = spec.rank, spec.shape, spec.batch, spec.tuning

    consts: Dict[str, np.ndarray] = {}
    axis_plans = engine.build_axis_plans(shape, spec.direction, tun)
    passes = [axis_pass(shape, batch, d, spec.direction,
                        scale if d == rank - 1 else 1.0, tun, consts, axis_plans[d],
                        kernels_allowed(spec))
              for d in range(rank)]
    kinds = tuple(p.kind for p in passes)
    route.reasons = route.reasons + tuple(
        f"c2c-axis{d}-{k}" for d, k in enumerate(kinds))
    if tun.large_route == "out-of-core" and "xla-four-step" not in kinds:
        # forced out-of-core but no axis is smooth/splittable/big enough
        route.reasons = route.reasons + ("four-step-impossible",)
    _set_mode(route, kinds, tun)
    scale_in_kernel = passes[-1].scaled

    def core(x, c):
        y = _run(passes, x, c)
        return y if scale_in_kernel else y * scale

    fn, in_shape, out_shape, s_in, s_out = build_staged_fn(
        spec, core, shape, shape, True, True, device)
    plan = Plan(spec, consts, fn, route, device=device, input_shape=in_shape,
                output_shape=out_shape,
                workspace_bytes=2 * batch * spec.n_total * 8)  # ping-pong estimate
    plan.supports_exec_offsets = True
    # inPlace (the JAX package donates the input buffer): the result is
    # written into the caller's tensor when both sides are plain shaped
    plan.in_place = (spec.in_place and not s_in.has_layout and not s_out.has_layout
                     and spec.io_view.input is None and spec.io_view.output is None)
    return plan


# ---------------------------------------------------------------------------
# r2c / c2r (packed half-spectrum along logical axis 0)
# ---------------------------------------------------------------------------

def packed_shape(shape):
    return (shape[0] // 2 + 1,) + tuple(shape[1:])


def _conj_pair(q: np.ndarray):
    """(ca, cb) such that cmul_const(z, ca, cb) == q * conj(z):
    out_re = qr*zr + qi*zi; out_im = qi*zr - qr*zi."""
    ca = np.stack([q.real, -q.real], axis=-1).astype(np.float32)
    cb = np.stack([q.imag, q.imag], axis=-1).astype(np.float32)
    return ca, cb


def _re_pair(q: np.ndarray):
    """(ca, cb) such that cmul_const(z, ca, cb) == q * Re(z)."""
    zero = np.zeros_like(q.real)
    ca = np.stack([q.real, zero], axis=-1).astype(np.float32)
    cb = np.stack([zero, q.imag], axis=-1).astype(np.float32)
    return ca, cb


def _half_trick_consts(n0: int, inverse: bool) -> Dict[str, np.ndarray]:
    """Constants for the even-N0 half-complex real FFT trick.

    Forward untangle (k = 0..n0/2, Z periodic n0/2, w = exp(-2*pi*i/n0),
    c = -i w^k / 2), fused per-bin form:
      X[k] = P[k] Z[k] + Q[k] conj(Z[-k]),   P = 1/2 + c, Q = 1/2 - c
    Inverse re-tangle (k = 0..n0/2-1, unnormalized-inverse convention
    with the factor 2 folded in, d = i w^{-k}):
      Z[k] = R[k] X[k] + S[k] conj(X[n0/2 - k]),   R = 1 + d, S = 1 - d
    The conj folds into the constant pairs (_conj_pair), so each output
    bin is two cmul_consts, one on the straight operand and one on a flip
    of it.  The k=0 inverse bin takes Re-projection pairs (_re_pair), so
    the imaginary parts of the self-conjugate bins 0 and n0/2 never enter.
    ``rc/ca``, ``rc/cb``, ``cr/ca`` and ``cr/cb`` are the unfused pairs the
    JAX package keeps for its distributed builders.
    """
    h = n0 // 2
    if not inverse:
        k = np.arange(h + 1)
        w = np.exp(-2j * np.pi * k / n0)
        c = -0.5j * w
        ca, cb = const_pair(c)
        pa, pb = const_pair(0.5 + c)
        qa, qb = _conj_pair(0.5 - c)
        return {"rc/ca": ca, "rc/cb": cb,
                "rc/pa": pa, "rc/pb": pb, "rc/qa": qa, "rc/qb": qb}
    k = np.arange(h)
    d = 1j * np.exp(2j * np.pi * k / n0)
    ca, cb = const_pair(d)
    ra, rb = const_pair(1.0 + d)
    sa, sb = _conj_pair(1.0 - d)
    r0a, r0b = _re_pair(1.0 + d[:1])
    s0a, s0b = _re_pair(1.0 - d[:1])
    return {"cr/ca": ca, "cr/cb": cb,
            "cr/ra": ra, "cr/rb": rb, "cr/sa": sa, "cr/sb": sb,
            "cr/r0a": r0a, "cr/r0b": r0b, "cr/s0a": s0a, "cr/s0b": s0b}


class _RealPasses:
    """The complex passes of an r2c or c2r plan.

    Even n0 >= 4 (``half``): a length-n0/2 pass on axis 0 (``axis0``) and
    the rest axes twice, on the h-bin body (``body``) and on the lone
    Nyquist bin (``nyq``), each pass chosen for its own array.  Otherwise
    every axis of the widened full-length array (``full``)."""

    def __init__(self, spec: PlanSpec, direction: str, consts: Dict[str, np.ndarray]):
        shape, tun, batch = tuple(spec.shape), spec.tuning, spec.batch
        kernels = kernels_allowed(spec)
        n0, rest = shape[0], shape[1:]
        self.half = n0 % 2 == 0 and n0 >= 4
        if self.half:
            hshape = (n0 // 2,) + rest
            plans = engine.build_axis_plans(hshape, direction, tun)

            def pick(s, d):
                return axis_pass(s, batch, d, direction, 1.0, tun, consts, plans[d], kernels)

            self.axis0 = pick(hshape, 0)
            self.body = [pick(hshape, d) for d in range(1, len(shape))]
            self.nyq = [pick((1,) + rest, d) for d in range(1, len(shape))]
        else:
            plans = engine.build_axis_plans(shape, direction, tun)
            self.full = [axis_pass(shape, batch, d, direction, 1.0, tun, consts, plans[d],
                                   kernels)
                         for d in range(len(shape))]

    def record(self, route: RouteInfo, tag: str, tuning) -> None:
        """Add ``{tag}-axis{d}-<kind>`` reasons (``-nyquist-<kind>`` where
        the Nyquist slab's pass differs from the body's) and set the mode.
        Under ``impl: "xla"`` the route stays as the JAX package reports it."""
        if tuning.impl == "xla":
            return
        if self.half:
            per_axis = [[self.axis0]] + [[b, q] for b, q in zip(self.body, self.nyq)]
        else:
            per_axis = [[p] for p in self.full]
        reasons: List[str] = []
        for d, ps in enumerate(per_axis):
            reasons.append(f"{tag}-axis{d}-{ps[0].kind}")
            if len(ps) > 1 and ps[1].kind != ps[0].kind:
                reasons.append(f"{tag}-axis{d}-nyquist-{ps[1].kind}")
        route.reasons = route.reasons + tuple(reasons)
        _set_mode(route, [p.kind for ps in per_axis for p in ps], tuning)


def build_r2c(spec: PlanSpec, device: torch.device) -> Plan:
    """Real ``(batch, *shape)`` → packed half-spectrum along logical axis 0,
    interleaved ``(batch, shape[0] // 2 + 1, *shape[1:], 2)``."""
    scale = engine.plan_scale(spec.normalize, "forward", spec.n_total)
    route = _route_for(spec)
    shape, rank = tuple(spec.shape), spec.rank
    n0, rest = shape[0], shape[1:]
    h, p0 = n0 // 2, n0 // 2 + 1
    consts: Dict[str, np.ndarray] = {}
    passes = _RealPasses(spec, "forward", consts)
    passes.record(route, "r2c", spec.tuning)
    if passes.half:
        consts.update(_half_trick_consts(n0, inverse=False))

    def core_half(x, c):
        b = x.shape[0]
        # pair adjacent axis-0 reals into interleaved complex:
        # v[m] = x[2m] + i*x[2m+1]
        v = x.reshape(b, h, 2, *rest).movedim(2, -1).contiguous()
        z = passes.axis0(v, c)
        # untangle to the packed half-spectrum, split into the h-bin body
        # and the lone Nyquist bin (k = n0/2 reads Z[0])
        tshape = (1, p0) + (1,) * (rank - 1) + (2,)
        pa, pb, qa, qb = (c[f"rc/{k}"].reshape(tshape) for k in ("pa", "pb", "qa", "qb"))
        zb, z0 = z[:, 1:], z[:, :1]
        y_body = (cmul_const(zb, pa[:, 1:h], pb[:, 1:h])
                  + cmul_const(torch.flip(zb, dims=(1,)), qa[:, 1:h], qb[:, 1:h]))
        y0 = cmul_const(z0, pa[:, :1], pb[:, :1]) + cmul_const(z0, qa[:, :1], qb[:, :1])
        y = torch.cat([y0, y_body], dim=1)
        y_nyq = cmul_const(z0, pa[:, h:], pb[:, h:]) + cmul_const(z0, qa[:, h:], qb[:, h:])
        for bp, qp in zip(passes.body, passes.nyq):
            y = bp(y, c)
            y_nyq = qp(y_nyq, c)
        return torch.cat([y, y_nyq], dim=1)

    def core(x, c):
        if passes.half:
            y = core_half(x, c)
        else:
            y = _run(passes.full, torch.stack([x, torch.zeros_like(x)], dim=-1), c)
            y = y[:, :p0]                                # non-negative bins of axis 0
        return y if scale == 1.0 else y * scale

    fn, in_shape, out_shape, _, _ = build_staged_fn(
        spec, core, shape, packed_shape(shape), False, True, device)
    plan = Plan(spec, consts, fn, route, device=device, input_shape=in_shape,
                output_shape=out_shape, input_interleaved=False,
                workspace_bytes=3 * spec.batch * spec.n_total * 8)
    plan.supports_exec_offsets = True
    return plan


def build_c2r(spec: PlanSpec, device: torch.device) -> Plan:
    """Packed half-spectrum along logical axis 0 → real ``(batch, *shape)``.
    The imaginary parts of the self-conjugate bins are ignored."""
    scale = engine.plan_scale(spec.normalize, "inverse", spec.n_total)
    route = _route_for(spec)
    shape, rank = tuple(spec.shape), spec.rank
    n0, rest = shape[0], shape[1:]
    h = n0 // 2
    k_max_mirror = n0 // 2 - 1 if n0 % 2 == 0 else n0 // 2
    consts: Dict[str, np.ndarray] = {}
    passes = _RealPasses(spec, "inverse", consts)
    passes.record(route, "c2r", spec.tuning)
    if passes.half:
        consts.update(_half_trick_consts(n0, inverse=True))

    def core_half(xp, c):
        b = xp.shape[0]
        # split the packed input into the h-bin body and the Nyquist bin,
        # inverse-FFT the rest axes on each, last axis first
        body, nyq = xp[:, :h], xp[:, h:]
        body = _run(passes.body, body, c)
        nyq = _run(passes.nyq, nyq, c)
        # re-tangle Z[k] = R X[k] + S conj(X[n0/2-k]); z = 2Z, whose
        # unnormalized inverse is n0 * v, the output pairs.  The k = 0 bin
        # takes Re-projection pairs, so imag in X[0] and X[n0/2] never enters.
        cshape = (1, h) + (1,) * (rank - 1) + (2,)
        ra, rb, sa, sb = (c[f"cr/{k}"].reshape(cshape) for k in ("ra", "rb", "sa", "sb"))
        bb = body[:, 1:]
        z_body = (cmul_const(bb, ra[:, 1:], rb[:, 1:])
                  + cmul_const(torch.flip(bb, dims=(1,)), sa[:, 1:], sb[:, 1:]))
        t0 = (1, 1) + (1,) * (rank - 1) + (2,)
        z0 = (cmul_const(body[:, :1], c["cr/r0a"].reshape(t0), c["cr/r0b"].reshape(t0))
              + cmul_const(nyq, c["cr/s0a"].reshape(t0), c["cr/s0b"].reshape(t0)))
        z = passes.axis0(torch.cat([z0, z_body], dim=1), c)
        return z.movedim(-1, 2).reshape(b, n0, *rest)    # (b, h, 2, *rest) pairs

    def core_mirror(xp, c):
        # ND Hermitian mirror X[(N-k) mod N] = conj(X[k]): flip axis 0 over
        # the mirrored bin range, flip+wrap every other logical axis
        full = xp
        if k_max_mirror >= 1:
            mirror = torch.flip(xp[:, 1:k_max_mirror + 1], dims=(1,))
            mirror = mirror * mirror.new_tensor([1.0, -1.0])        # conj
            for d in range(2, mirror.ndim - 1):  # skip batch, axis 0, component
                mirror = torch.roll(torch.flip(mirror, dims=(d,)), 1, dims=d)
            full = torch.cat([xp, mirror], dim=1)
        return _run(passes.full, full, c)[..., 0]        # real part

    def core(xp, c):
        y = core_half(xp, c) if passes.half else core_mirror(xp, c)
        return y.contiguous() if scale == 1.0 else y * scale

    fn, in_shape, out_shape, _, _ = build_staged_fn(
        spec, core, packed_shape(shape), shape, True, False, device)
    plan = Plan(spec, consts, fn, route, device=device, input_shape=in_shape,
                output_shape=out_shape,
                workspace_bytes=3 * spec.batch * spec.n_total * 8)
    plan.supports_exec_offsets = True
    return plan


# ---------------------------------------------------------------------------
# DCT / DST 1-4
# ---------------------------------------------------------------------------
# Two routes per axis:
#
# - "matmul": a dense trig-matrix contraction (``mathref.trig_matrix``), for
#   short axes (8x8 blocks).
# - "fft": from ``tuning.dctFftMinN`` on, every type lowers to a complex-FFT
#   embedding, O(N log N):
#     dct2/dct3/dst2/dst3: length-N FFT with even/odd reorder + half-sample
#       phase twist;
#     dct1: symmetric extension to M=2(N-1), y = Re(FFT(v))[:N];
#     dst1: odd extension to M=2(N+1), y = -Im(FFT(v))[1:N+1] / 2;
#     dct4/dst4: pre-twiddle e^{-i pi n/(2N)}, zero-pad to M=2N,
#       post-twiddle e^{-i pi (2k+1)/(4N)}: y = Re / -Im of the product.
#   The inner complex FFT is an ``AxisPass``: K1 for the last axis, K2 for an
#   earlier one, else the einsum route.  At power-of-two N the dct1/dst1 work
#   lengths 2(N-1) and 2(N+1) are often not smooth (dst1 at N = 4096:
#   8194 = 2 * 17 * 241); their inner axis is then Bluestein at about twice
#   the length, recorded as ``dct-axis{d}-fft-xla-bluestein``.
#
# Matmul trig tables are guarded at DCT_MATMUL_MAX_ELEMS: an axis that would
# build a larger dense table raises at plan build.

DCT_MATMUL_MAX_ELEMS = 1 << 24


def _dct_reorder_perms(n: int):
    """Even/odd reorder: v[m] = x[2m], v[n-1-m] = x[2m+1]."""
    perm = np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)[::-1]])
    inv = np.argsort(perm)
    return perm.astype(np.int32), inv.astype(np.int32)


def _dct_work_length(n: int, eff_kind: str) -> int:
    """Length of the complex FFT inside one FFT-routed axis."""
    return {"dct1": 2 * n - 2, "dst1": 2 * n + 2, "dct4": 2 * n, "dst4": 2 * n}.get(eff_kind, n)


def _dct_axis_fft_consts(n: int, eff_kind: str, prefix: str, tuning):
    """(inner axis plan, the axis's own constants) for one FFT-routed axis;
    the inner plan's tables are added by the ``axis_pass`` that takes it.

    eff_kind is "dct2"-like (forward trig) or "dct3"-like (inverse trig);
    dst variants add sign/reverse wrappers at apply time.
    """
    m = _dct_work_length(n, eff_kind)
    if eff_kind in ("dct1", "dst1"):
        return build_axis_plan(m, 0, "forward", tuning, f"{prefix}/f"), {}
    if eff_kind in ("dct4", "dst4"):
        # pre/post half-sample twiddles around a length-2N FFT
        nn = np.arange(n, dtype=np.float64)
        pre = np.exp(-1j * np.pi * nn / (2 * n))
        post = np.exp(-1j * np.pi * (2 * nn + 1) / (4 * n))
        consts = {f"{prefix}/p_re": pre.real.astype(np.float32),
                  f"{prefix}/p_im": pre.imag.astype(np.float32),
                  f"{prefix}/t_re": post.real.astype(np.float32),
                  f"{prefix}/t_im": post.imag.astype(np.float32)}
        return build_axis_plan(m, 0, "forward", tuning, f"{prefix}/f"), consts
    perm, inv = _dct_reorder_perms(n)
    w = np.exp(-1j * np.pi * np.arange(n) / (2 * n))
    consts: Dict[str, np.ndarray] = {f"{prefix}/perm": perm, f"{prefix}/inv": inv}
    if eff_kind in ("dct2", "dst2"):
        ap = build_axis_plan(n, 0, "forward", tuning, f"{prefix}/f")
        consts[f"{prefix}/wa"], consts[f"{prefix}/wb"] = const_pair(w)
    else:
        ap = build_axis_plan(n, 0, "inverse", tuning, f"{prefix}/i")
        # U[k] = 0.5 * conj(w_k) * (X[k] - i*X[n-k]);  X[n-0] := 0
        consts[f"{prefix}/ua"], consts[f"{prefix}/ub"] = const_pair(0.5 * np.conj(w))
        consts[f"{prefix}/xm"] = np.concatenate([[0], np.arange(n - 1, 0, -1)]).astype(np.int32)
        consts[f"{prefix}/xm0"] = np.concatenate(
            [[0.0], np.ones(n - 1)]).astype(np.float32)  # masks X[n-0] to 0
    return ap, consts


def _apply_dct_fft_axis(x, c, fft, prefix: str, eff_kind: str, n: int, mid: bool = False):
    """Apply one FFT-routed DCT/DST axis.  ``fft(v, c)`` is the inner complex
    FFT along the transform axis of interleaved ``v``.

    mid=False: along the LAST axis of real x.
    mid=True: the axis sits at axis -2 of real x (..., n, L) with trailing
    dims riding in L; gathers and flips address axis -2 (-3 of interleaved
    data) and constants broadcast over L.  No movedim passes either way.
    """
    ax = -2 if mid else -1
    cax = -3 if mid else -2          # the same axis on interleaved (.., 2)

    def bc(t):       # per-n real constant: ride the lane dim in mid form
        return t[:, None] if mid else t

    def bc2(t):      # per-n complex const pair (n, 2): (n, 1, 2) rides L
        return t[:, None, :] if mid else t

    def rsl(t, a, b):  # slice [a:b) along the transform axis of a REAL array
        return t[..., a:b, :] if mid else t[..., a:b]

    def csl(t, a, b):  # same slice on an interleaved complex array
        return t[..., a:b, :, :] if mid else t[..., a:b, :]

    def take(t, idx):  # gather along the transform axis of a REAL array
        return t.index_select(t.ndim + ax, idx)

    def sign():        # (+1, -1, +1, ...) along the transform axis
        s = torch.ones(n, dtype=x.dtype, device=x.device)
        s[1::2] = -1.0
        return bc(s)

    if eff_kind == "dct1":
        # v = [x_0..x_{N-1}, x_{N-2}..x_1], M=2(N-1): Re(FFT(v))[k] ==
        # x_0 + (-1)^k x_{N-1} + 2 sum cos == trig_matrix("dct1") row k
        v = torch.cat([x, torch.flip(rsl(x, 1, n - 1), dims=(ax,))], dim=ax)
        vi = torch.stack([v, torch.zeros_like(v)], dim=-1)
        return csl(fft(vi, c), 0, n)[..., 0]
    if eff_kind == "dst1":
        # v = [0, x, 0, -rev(x)], M=2(N+1): FFT(v)[k+1] = -2i sum sin, and
        # trig_matrix("dst1") has no factor 2 -> y = -Im(FFT(v))[1:N+1]/2
        z1 = torch.zeros_like(rsl(x, 0, 1))
        v = torch.cat([z1, x, z1, -torch.flip(x, dims=(ax,))], dim=ax)
        vi = torch.stack([v, torch.zeros_like(v)], dim=-1)
        return csl(fft(vi, c), 1, n + 1)[..., 1] * (-0.5)
    if eff_kind in ("dct4", "dst4"):
        # u[m] = x[m] e^{-i pi m / 2N} zero-padded to 2N;
        # y = Re / -Im of e^{-i pi (2k+1)/(4N)} FFT(u)[k], k < N
        u = torch.stack([x * bc(c[f"{prefix}/p_re"]), x * bc(c[f"{prefix}/p_im"])], dim=-1)
        ui = torch.cat([u, torch.zeros_like(u)], dim=cax)
        U = csl(fft(ui, c), 0, n)
        ur, ui_ = U[..., 0], U[..., 1]
        tr, ti = bc(c[f"{prefix}/t_re"]), bc(c[f"{prefix}/t_im"])
        if eff_kind == "dct4":
            return ur * tr - ui_ * ti
        return -(ui_ * tr + ur * ti)

    if eff_kind == "dst2":
        x = x * sign()                   # dst2(x)[k] = reverse(dct2(altsign(x)))[k]
    if eff_kind == "dst3":
        x = torch.flip(x, dims=(ax,))
    if eff_kind in ("dct2", "dst2"):
        v = take(x, c[f"{prefix}/perm"])
        vi = torch.stack([v, torch.zeros_like(v)], dim=-1)
        y = cmul_const(fft(vi, c), bc2(c[f"{prefix}/wa"]), bc2(c[f"{prefix}/wb"]))[..., 0]
        return torch.flip(y, dims=(ax,)) if eff_kind == "dst2" else y
    # dct3 / dst3
    xm = take(x, c[f"{prefix}/xm"]) * bc(c[f"{prefix}/xm0"])
    u = torch.stack([x, -xm], dim=-1)                   # X[k] - i*X[n-k]
    u = cmul_const(u, bc2(c[f"{prefix}/ua"]), bc2(c[f"{prefix}/ub"]))
    y = take(fft(u, c)[..., 0], c[f"{prefix}/inv"])     # Re(IFFT_unnorm(U))
    return y * sign() if eff_kind == "dst3" else y


def build_dct(spec: PlanSpec, device: torch.device) -> Plan:
    """ND DCT/DST (types 1-4) of real ``(batch, *shape)``."""
    kind = spec.plan_type
    route = _route_for(spec)
    shape, rank, batch, tun = tuple(spec.shape), spec.rank, spec.batch, spec.tuning
    kernels = kernels_allowed(spec)
    consts: Dict[str, np.ndarray] = {}
    self_inverse = kind in ("dct1", "dst1", "dct4", "dst4")
    mdir = "forward" if self_inverse else spec.direction
    # effective per-direction kind: dct2 inverse == dct3 forward etc.
    alias = {"dct2": "dct3", "dct3": "dct2", "dst2": "dst3", "dst3": "dst2"}
    eff_kind = kind if (self_inverse or spec.direction == "forward") else alias[kind]

    passes: List[Optional[AxisPass]] = []      # the inner FFT of each fft axis
    for d, n in enumerate(shape):
        if n >= tun.dct_fft_min_n:
            ap, cc = _dct_axis_fft_consts(n, eff_kind, f"dct{d}", tun)
            consts.update(cc)
            # the inner FFT's own array: (lines, m, 2) for the last axis,
            # (pre, m, L, 2) for an earlier one
            lead = batch * math.prod(shape[:d])
            inner = (ap.n,) if d == rank - 1 else (ap.n, math.prod(shape[d + 1:]))
            passes.append(axis_pass(inner, lead, 0, ap.direction, 1.0, tun, consts, ap,
                                    kernels, prefix=f"dct{d}/"))
        else:
            if n * n > DCT_MATMUL_MAX_ELEMS:
                raise PlanError(
                    f"{kind} axis {d} of length {n} would build a dense "
                    f"{n}x{n} trig table ({n * n * 4 / 2**30:.1f} GiB) on "
                    f"the matmul route; the FFT route engages at "
                    f"tuning.dctFftMinN={tun.dct_fft_min_n} — "
                    "lower it below this axis length instead of "
                    "materializing a multi-GB constant")
            consts[f"trig{d}"] = trig_matrix(kind, n, mdir).T.astype(np.float32)  # x @ T
            passes.append(None)
    route.reasons = route.reasons + tuple(
        f"dct-axis{d}-{'matmul' if p is None else 'fft'}" for d, p in enumerate(passes))
    if tun.impl != "xla":
        route.reasons = route.reasons + tuple(
            f"dct-axis{d}-fft-{p.detail}" for d, p in enumerate(passes) if p is not None)
        _set_mode(route, ["xla" if p is None else p.kind for p in passes], tun)
    scale = engine.plan_scale(spec.normalize, spec.direction, spec.n_total)

    def core(x, c):
        y = x
        # last axis first; the trig axes are separable, so order is free
        for d in range(rank - 1, -1, -1):
            n, p = shape[d], passes[d]
            last = d == rank - 1
            v = y if last else y.reshape(batch, *shape[:d], n, -1)
            if p is not None:
                def fft(vi, c_, p=p):
                    return p(vi, c_).reshape(vi.shape)
                v = _apply_dct_fft_axis(v, c, fft, f"dct{d}", eff_kind, n, mid=not last)
            else:
                # full float32 whatever the caller's TF32 flag (the JAX
                # package's Precision.HIGHEST); mid-axis: trailing dims ride
                # as a lane dim
                with full_f32():
                    v = (torch.matmul(v, c[f"trig{d}"]) if last
                         else torch.einsum("...aL,ak->...kL", v, c[f"trig{d}"]))
            y = v.reshape(batch, *shape)
        return y if scale == 1.0 else y * scale

    fn, in_shape, out_shape, _, _ = build_staged_fn(
        spec, core, shape, shape, False, False, device)
    plan = Plan(spec, consts, fn, route, device=device, input_shape=in_shape,
                output_shape=out_shape, input_interleaved=False,
                workspace_bytes=2 * batch * spec.n_total * 4)
    plan.supports_exec_offsets = True
    return plan
