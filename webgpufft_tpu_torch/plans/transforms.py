"""c2c, r2c and c2r plan builders.

Port of ``build_c2c``, ``build_r2c`` and ``build_c2r`` from
``webgpufft_tpu/plans/transforms.py``, minus the JAX package's TPU-only
parts (the operand-size and batch chunking, the giant-transform route and
the per-rank VMEM split).

Every complex pass of every plan is one ``AxisPass``, chosen by
``axis_pass`` from the array it runs on:

- last axis → K1 (core/fused.py) when a split exists and there are at least
  8 lines, with both digits >= 16 when rank > 1;
- earlier axes → K2 (core/fused_cols.py) when the riding lanes number at
  least 128 and both digits are >= 16;
- any other axis → the einsum route (core/axis.py: mixed-radix, four-step,
  Rader or Bluestein).

The kernels are allowed under ``impl`` "auto", "pallas" and "pallas-auto";
"xla" keeps every axis on the einsum route.  A c2c plan folds its normalize
scale into the last axis's table and runs the axes last to first.  r2c and
c2r apply the scale in one pass at the end, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import engine, fused, fused_cols
from ..core.axis import AxisPlan, apply_along_axis, make_smooth_plan, select_axis_kind
from ..core.cplx import cmul_const, const_pair
from ..runtime.policy import FUSED_MIN_BATCH, resolve_route
from ..spec import PlanError, PlanSpec
from .base import Plan, RouteInfo, build_staged_fn

# the digit floor for K1/K2 in a rank > 1 plan (a Mosaic VMEM fact of the
# JAX package, kept so both packages route alike; ROADMAP P-X)
MIN_DIGIT_RANK_GT1 = 16


def _route_for(spec: PlanSpec) -> RouteInfo:
    kinds = tuple(select_axis_kind(n, d, spec.tuning) for d, n in enumerate(spec.shape))
    return resolve_route(spec, kinds)


def _tables(consts, prefix: str, names) -> Dict[str, torch.Tensor]:
    return {name: consts[f"{prefix}/{name}"] for name in names}


class AxisPass:
    """One c2c pass along logical axis ``d`` of an interleaved
    ``(lead, *shape, 2)`` array: K1, K2 or an einsum axis plan.

    ``kind`` is the route name ("fused-lines", "fused-cols", "xla" or
    "xla-four-step"), ``scaled`` whether the pass applies the scale it was
    chosen for, and ``note`` why a split length stayed off the kernels."""

    def __init__(self, kind: str, shape: Tuple[int, ...], lead: int, d: int,
                 obj, scaled: bool, note: Optional[str] = None):
        self.kind, self.shape, self.lead, self.d = kind, tuple(shape), lead, d
        self.obj, self.scaled, self.note = obj, scaled, note

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


def axis_pass(shape: Sequence[int], lead: int, d: int, direction: str, scale: float,
              tuning, consts: Dict[str, np.ndarray], axis_plan: AxisPlan) -> AxisPass:
    """Choose how the c2c pass along logical axis ``d`` of an interleaved
    ``(lead, *shape, 2)`` array runs, and add its tables to ``consts``.

    K1 and K2 fold ``scale`` into their tables; on the einsum route
    ``axis_plan`` is rebuilt with ``scale`` folded in when it is mixed-radix
    or four-step, and left unscaled otherwise (``AxisPass.scaled``)."""
    shape = tuple(shape)
    n, rank = shape[d], len(shape)
    note = None
    if tuning.impl != "xla" and n > 1:
        last = d == rank - 1
        split = fused.choose_split(n) if last else fused_cols.choose_split(n)
        if split is not None and rank > 1 and min(split) < MIN_DIGIT_RANK_GT1:
            split, note = None, f"min-digit-below-{MIN_DIGIT_RANK_GT1}"
        if split is not None and last:
            if lead * math.prod(shape[:-1]) >= FUSED_MIN_BATCH:
                consts.update(fused.lines_consts(n, direction, scale, f"fl{d}"))
                return AxisPass("fused-lines", shape, lead, d, f"fl{d}", True)
        elif split is not None and 2 * math.prod(shape[d + 1:]) >= 128:
            consts.update(fused_cols.cols_consts(n, direction, scale, f"fc{d}"))
            return AxisPass("fused-cols", shape, lead, d, f"fc{d}", True)
    ap = axis_plan
    if scale != 1.0 and ap.kind in ("mixed", "four-step") and n > 1:
        ap = make_smooth_plan(n, direction, ap.prefix, tuning.max_sub_length,
                              out_scale=scale, tuning=tuning)
    consts.update(ap.consts())
    kind = "xla-four-step" if ap.kind == "four-step" else "xla"
    scaled = scale == 1.0 or getattr(ap, "out_scale", 1.0) == scale
    return AxisPass(kind, shape, lead, d, ap, scaled, note)


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
                        scale if d == rank - 1 else 1.0, tun, consts, axis_plans[d])
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

    fn, in_shape, out_shape = build_staged_fn(spec, core, shape, shape, True, True)
    return Plan(spec, consts, fn, route, device=device,
                input_shape=in_shape, output_shape=out_shape)


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
        n0, rest = shape[0], shape[1:]
        self.half = n0 % 2 == 0 and n0 >= 4
        if self.half:
            hshape = (n0 // 2,) + rest
            plans = engine.build_axis_plans(hshape, direction, tun)

            def pick(s, d):
                return axis_pass(s, batch, d, direction, 1.0, tun, consts, plans[d])

            self.axis0 = pick(hshape, 0)
            self.body = [pick(hshape, d) for d in range(1, len(shape))]
            self.nyq = [pick((1,) + rest, d) for d in range(1, len(shape))]
        else:
            plans = engine.build_axis_plans(shape, direction, tun)
            self.full = [axis_pass(shape, batch, d, direction, 1.0, tun, consts, plans[d])
                         for d in range(len(shape))]

    def record(self, route: RouteInfo, tag: str, tuning) -> None:
        """Add ``{tag}-axis{d}-<kind>`` reasons (``-nyquist-<kind>`` where
        the Nyquist slab's pass differs from the body's, and the reason a
        split axis stayed off the kernels) and set the mode.  Under
        ``impl: "xla"`` the route stays as the JAX package reports it."""
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
            for note in dict.fromkeys(p.note for p in ps if p.note):
                reasons.append(f"{tag}-axis{d}-{note}")
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

    fn, in_shape, out_shape = build_staged_fn(spec, core, shape, packed_shape(shape),
                                              False, True)
    return Plan(spec, consts, fn, route, device=device, input_shape=in_shape,
                output_shape=out_shape, input_interleaved=False)


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

    fn, in_shape, out_shape = build_staged_fn(spec, core, packed_shape(shape), shape,
                                              True, False)
    return Plan(spec, consts, fn, route, device=device,
                input_shape=in_shape, output_shape=out_shape)
