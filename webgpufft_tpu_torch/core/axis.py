"""Per-axis FFT plans as torch einsums: the port's ``impl: "xla"`` route.

Port of the mixed-radix part of ``webgpufft_tpu/core/axis.py``.  Each axis
transform is a short chain of batched real einsum contractions against
host-precomputed DFT/twiddle tables, on interleaved float32 ``(..., n, 2)``
data, with the same index strings as the JAX package.  It serves every axis
the Hopper kernels cannot split.

Rader, Bluestein and four-step axes are not ported yet: building one raises
``PlanError`` (ROADMAP P3).

Every plan exposes:
  - ``consts()``  -> {name: np.ndarray} constant tables
  - ``apply(x, consts)`` -> transform along the last *complex* axis of x
                            (array axis -2; component dim stays last)
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import dft
from .cplx import to_w4, const_pair, cmul_const
from ..spec import PlanError
from ..utils import factors


class AxisPlan:
    kind: str = "?"

    def __init__(self, n: int, prefix: str):
        self.n = n
        self.prefix = prefix

    def consts(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def apply(self, x, consts):
        raise NotImplementedError


class MixedAxisPlan(AxisPlan):
    """Smooth-length FFT as a chain of sub-DFT matmuls + twiddles.

    The axis length is grouped into sub-lengths (factors.split_sublengths);
    cost ~ 4*N*sum(subs) real MACs per line.
    """
    kind = "mixed"

    def __init__(self, n: int, direction: str, prefix: str, max_sub: int = 32,
                 out_scale: float = 1.0):
        super().__init__(n, prefix)
        self.direction = direction
        subs = factors.split_sublengths(n, max_sub) if n > 1 else [1]
        if len(subs) > 2 and max_sub >= 32:
            # Prefer an exactly-two-level balanced split when its folded
            # stage-B tables stay small: two contractions, zero twiddle
            # passes.  dftB table floats = 4*n*n2; bound n*n2 <= 2^20.  A
            # maxSubLength ABOVE the default caps the split factors too;
            # below the default the preference is skipped entirely; at the
            # default (32) factors may reach 128.
            cap = 128 if max_sub == 32 else max_sub
            two = factors.split_two_balanced(n, cap)
            if two is not None and n * min(two) <= (1 << 20):
                subs = [max(two), min(two)]
        self.subs = subs
        if math.prod(self.subs) != n:
            raise ValueError(f"sub-lengths {self.subs} do not multiply to {n}")
        # plan normalize scale folded into the last sub-DFT table: saves a
        # whole elementwise pass over the output
        self.out_scale = out_scale

    def consts(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        rem = self.n
        for lvl, n1 in enumerate(self.subs):
            last = lvl == len(self.subs) - 1
            if last and len(self.subs) >= 2:
                break  # final level lives inside the previous level's dftB
            w = dft.dft_matrix(n1, self.direction)
            if last and self.out_scale != 1.0:
                w = w * np.complex64(self.out_scale)
            out[f"{self.prefix}/dft{lvl}"] = to_w4(w)
            if not last:
                n2 = rem // n1
                if len(self.subs) - lvl == 2:
                    # final pair of levels: fold the inter-stage twiddle into
                    # per-k1 stage-B matrices (T[k1, n2] * W2)[n2, k2] so the
                    # whole 2-level FFT is exactly two contractions
                    tw = dft.ct_twiddle(n1, n2, self.direction).astype(np.complex64)
                    w2 = dft.dft_matrix(n2, self.direction)
                    if self.out_scale != 1.0:
                        w2 = w2 * np.complex64(self.out_scale)
                    out[f"{self.prefix}/dftB{lvl}"] = np.stack(
                        [to_w4(tw[a][:, None] * w2) for a in range(n1)])
                else:
                    ta, tb = const_pair(dft.ct_twiddle(n1, n2, self.direction))
                    out[f"{self.prefix}/twa{lvl}"] = ta  # (n1, n2, 2)
                    out[f"{self.prefix}/twb{lvl}"] = tb
                rem = n2
        return out

    def apply_mid(self, x, consts):
        """Transform along axis -3 of (..., n, L, 2): the same W4-form
        contraction chain as ``apply`` with a riding lane dim L carried
        through every einsum untouched (no transposes of the data)."""
        return self._rec_mid(x, consts, 0)

    def _rec_mid(self, x, consts, lvl: int):
        subs = self.subs[lvl:]
        n = math.prod(subs)
        lead = x.shape[:-3]
        L = x.shape[-2]
        if len(subs) == 1:
            return torch.einsum("...aLi,aicj->...cLj", x,
                                consts[f"{self.prefix}/dft{lvl}"])
        n1 = subs[0]
        n2 = n // n1
        xm = x.reshape(*lead, n1, n2, L, 2)
        y = torch.einsum("...abLi,aicj->...cbLj", xm,
                         consts[f"{self.prefix}/dft{lvl}"])
        if len(subs) == 2:
            z = torch.einsum("...abLi,abicj->...caLj", y,
                             consts[f"{self.prefix}/dftB{lvl}"])
        else:
            twa = consts[f"{self.prefix}/twa{lvl}"][:, :, None, :]  # ride L
            twb = consts[f"{self.prefix}/twb{lvl}"][:, :, None, :]
            y = cmul_const(y, twa, twb)
            z = self._rec_mid(y, consts, lvl + 1)  # n2 digit sits at axis -3
            z = z.reshape(*lead, n1, n2, L, 2)
            z = torch.swapaxes(z, -4, -3)          # out[k] at k = k1 + n1*k2
        return z.reshape(*lead, n, L, 2)

    def apply(self, x, consts):
        return self._rec(x, consts, 0)

    def _rec(self, x, consts, lvl: int):
        subs = self.subs[lvl:]
        n = math.prod(subs)
        if len(subs) == 1:
            # out[..., c, j] = sum_{a,i} x[..., a, i] W4[a, i, c, j]
            return torch.einsum("...ai,aicj->...cj", x,
                                consts[f"{self.prefix}/dft{lvl}"])
        n1 = subs[0]
        n2 = n // n1
        lead = x.shape[:-2]
        xm = x.reshape(*lead, n1, n2, 2)
        # y[..., k1, m2, j] = sum_{a,i} xm[..., a, m2, i] W4[a, i, k1, j]
        y = torch.einsum("...abi,aicj->...cbj", xm,
                         consts[f"{self.prefix}/dft{lvl}"])
        if len(subs) == 2:
            # final level: twiddle is folded into per-k1 stage-B matrices
            # (consts dftB) and the contraction emits the digit-reversed
            # order directly — two contractions total, zero twiddle pass
            z = torch.einsum("...abi,abicj->...caj", y,
                             consts[f"{self.prefix}/dftB{lvl}"])
        else:
            y = cmul_const(y, consts[f"{self.prefix}/twa{lvl}"],
                           consts[f"{self.prefix}/twb{lvl}"])
            z = self._rec(y, consts, lvl + 1)      # length-n2 FFT along axis -2
            z = torch.swapaxes(z, -3, -2)          # out[k] at k = k1 + n1*k2
        return z.reshape(*lead, n, 2)


# tuning.largeRoute == "out-of-core" forces four-step on axes >= this
FOUR_STEP_FORCE_MIN_N = 4096


def four_step_eligible(n: int, tuning) -> bool:
    """Would the JAX package route a smooth axis of length n to four-step?
    (Its operand-size necessity clause is a TPU bound the port drops.)"""
    if (tuning is None or tuning.large_route == "chunk"
            or tuning.disable_four_step):
        return False
    if not factors.is_smooth(n) or factors.split_two_balanced(n, n) is None:
        return False
    minn = (min(FOUR_STEP_FORCE_MIN_N, tuning.four_step_min_n)
            if tuning.large_route == "out-of-core"
            else tuning.four_step_min_n)
    return n >= minn


def make_smooth_plan(n: int, direction: str, prefix: str, max_sub: int = 32,
                     out_scale: float = 1.0, tuning=None) -> AxisPlan:
    """MixedAxisPlan.  An axis the JAX package would send to four-step
    raises until that axis kind is ported."""
    if n > 1 and four_step_eligible(n, tuning):
        raise PlanError(
            f"axis length {n} takes the four-step route, which the PyTorch "
            "port does not have yet (ROADMAP P3)", n=n)
    return MixedAxisPlan(n, direction, prefix, max_sub, out_scale)


def select_axis_kind(n: int, axis: int, tuning) -> str:
    """Axis algorithm policy: forced overrides win; then smooth -> mixed;
    prime <= raderMaxPrime -> rader; else bluestein."""
    if axis in tuning.force_bluestein_axes:
        return "bluestein"
    if axis in tuning.force_rader_axes:
        if not factors.is_prime(n):
            raise ValueError(f"forceRaderAxes: axis {axis} length {n} is not prime")
        if n > tuning.rader_max_prime:
            raise PlanError(
                f"forceRaderAxes: axis {axis} length {n} exceeds "
                f"tuning.raderMaxPrime ({tuning.rader_max_prime})",
                axis=axis, length=n, rader_max_prime=tuning.rader_max_prime)
        return "rader"
    if n == 1 or factors.is_smooth(n):
        return "mixed"
    if factors.is_prime(n) and n <= tuning.rader_max_prime:
        return "rader"
    return "bluestein"


def build_axis_plan(n: int, axis: int, direction: str, tuning, prefix: str) -> AxisPlan:
    kind = select_axis_kind(n, axis, tuning)
    if kind != "mixed":
        raise PlanError(
            f"axis {axis} (n={n}) needs a {kind} axis plan, which the "
            "PyTorch port does not have yet (ROADMAP P3)",
            axis=axis, n=n, kind=kind)
    return make_smooth_plan(n, direction, prefix, tuning.max_sub_length,
                            tuning=tuning)


def apply_along_axis(x, axis_plan: AxisPlan, array_axis: int, consts):
    """Apply an axis plan along complex array axis ``array_axis`` of
    interleaved x (..., 2).  Non-last axes use the W4 mid-axis form: the
    trailing complex dims merge into a riding lane dim (a free reshape)."""
    last = x.ndim - 2
    if array_axis == last:
        return axis_plan.apply(x, consts)
    lead = x.shape[:array_axis]
    n = x.shape[array_axis]
    v = x.reshape(*lead, n, -1, 2)           # L = trailing complex elems
    y = axis_plan.apply_mid(v, consts)
    return y.reshape(x.shape)
