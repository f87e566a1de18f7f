"""Per-axis FFT plans as torch einsums: the port's ``impl: "xla"`` route.

Port of ``webgpufft_tpu/core/axis.py``: mixed-radix, four-step, Bluestein
and Rader axes.  Each axis transform is a short chain of batched real einsum
contractions against host-precomputed DFT/twiddle tables, on interleaved
float32 ``(..., n, 2)`` data, with the same index strings as the JAX
package.  It serves every axis the Hopper kernels cannot split.

The JAX package bounds einsum operand sizes (``OPERAND_CHUNK_ELEMS``, digit
slabs, ``slabbed_axis_apply``) because of an XLA-TPU miscompile; the port
runs every axis whole through ``apply_along_axis``.

The contractions run through ``core.precision.einsum``: full float32 in
the forward, the backward and the JVP whatever the caller's TF32 flag, as
the JAX package's ``Precision.HIGHEST``.

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
import torch.nn.functional as F

from . import dft
from .cplx import to_w4, const_pair, cmul_const
from .precision import einsum
from ..spec import PlanError
from ..utils import factors


class AxisPlan:
    kind: str = "?"
    supports_mid = False    # has apply_mid (axis -3 of (..., n, L, 2))
    prefer_mid = False

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
    supports_mid = True
    prefer_mid = True

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
            return einsum("...aLi,aicj->...cLj", x,
                          consts[f"{self.prefix}/dft{lvl}"])
        n1 = subs[0]
        n2 = n // n1
        xm = x.reshape(*lead, n1, n2, L, 2)
        y = einsum("...abLi,aicj->...cbLj", xm,
                   consts[f"{self.prefix}/dft{lvl}"])
        if len(subs) == 2:
            z = einsum("...abLi,abicj->...caLj", y,
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
            return einsum("...ai,aicj->...cj", x,
                          consts[f"{self.prefix}/dft{lvl}"])
        n1 = subs[0]
        n2 = n // n1
        lead = x.shape[:-2]
        xm = x.reshape(*lead, n1, n2, 2)
        # y[..., k1, m2, j] = sum_{a,i} xm[..., a, m2, i] W4[a, i, k1, j]
        y = einsum("...abi,aicj->...cbj", xm,
                   consts[f"{self.prefix}/dft{lvl}"])
        if len(subs) == 2:
            # final level: twiddle is folded into per-k1 stage-B matrices
            # (consts dftB) and the contraction emits the digit-reversed
            # order directly — two contractions total, zero twiddle pass
            z = einsum("...abi,abicj->...caj", y,
                       consts[f"{self.prefix}/dftB{lvl}"])
        else:
            y = cmul_const(y, consts[f"{self.prefix}/twa{lvl}"],
                           consts[f"{self.prefix}/twb{lvl}"])
            z = self._rec(y, consts, lvl + 1)      # length-n2 FFT along axis -2
            z = torch.swapaxes(z, -3, -2)          # out[k] at k = k1 + n1*k2
        return z.reshape(*lead, n, 2)


class FourStepAxisPlan(AxisPlan):
    """Four-step FFT for one giant smooth axis.

    Split n = n1 * n2 balanced and run, on the (n1, n2) digit grid

      x[a1, a2] -> FFT_n1 over a1 (mid form: a2 rides in lanes)
                -> * W_N^(k1 * a2)
                -> FFT_n2 over a2 (contiguous rows, scale folded in)
                -> transpose (k1, k2) -> (k2, k1)   (flat k = k1 + n1 * k2)

    Each stage is a MixedAxisPlan; the port runs both stages whole (the
    JAX package streams digit slabs to bound TPU einsum operands).
    """
    kind = "four-step"
    supports_mid = True
    # the JAX package routes non-last four-step axes through the movedim
    # fallback (measured on TPU); the port keeps the same route
    prefer_mid = False

    def __init__(self, n: int, direction: str, prefix: str, max_sub: int = 32,
                 out_scale: float = 1.0):
        super().__init__(n, prefix)
        self.direction = direction
        self.out_scale = out_scale
        split = factors.split_two_balanced(n, n)
        if split is None:
            raise ValueError(f"four-step axis needs a two-factor smooth split, n={n}")
        # n1 = the a1 (stride-n2) digit, n2 = the contiguous digit
        self.n1, self.n2 = split
        self.stage1 = MixedAxisPlan(self.n1, direction, f"{prefix}/s1", max_sub)
        self.stage2 = MixedAxisPlan(self.n2, direction, f"{prefix}/s2", max_sub,
                                    out_scale=out_scale)

    def consts(self) -> Dict[str, np.ndarray]:
        sign = -1.0 if self.direction == "forward" else 1.0
        tw = np.exp(sign * 2j * np.pi *
                    (np.outer(np.arange(self.n1), np.arange(self.n2)) % self.n)
                    / self.n)                                  # W_N^(k1*a2)
        ta, tb = const_pair(tw)                                # (n1, n2, 2)
        out = {f"{self.prefix}/twa": ta, f"{self.prefix}/twb": tb}
        out.update(self.stage1.consts())
        out.update(self.stage2.consts())
        return out

    def apply(self, x, consts):
        p = self.prefix
        lead = x.shape[:-2]
        y = x.reshape(*lead, self.n1, self.n2, 2)      # a = a1*n2 + a2
        y = apply_along_axis(y, self.stage1, y.ndim - 3, consts)
        y = cmul_const(y, consts[f"{p}/twa"], consts[f"{p}/twb"])
        y = self.stage2.apply(y, consts)
        y = torch.swapaxes(y, -3, -2)                  # (k2, k1): flat k = k1 + n1*k2
        return y.reshape(*lead, self.n, 2)

    def apply_mid(self, x, consts):
        """Transform along axis -3 of (..., n, L, 2), the riding lane dim L
        carried through both stages."""
        p = self.prefix
        lead = x.shape[:-3]
        L = x.shape[-2]
        y = x.reshape(*lead, self.n1, self.n2, L, 2)
        y = apply_along_axis(y, self.stage1, y.ndim - 4, consts)
        y = cmul_const(y, consts[f"{p}/twa"][:, :, None, :],
                       consts[f"{p}/twb"][:, :, None, :])
        y = apply_along_axis(y, self.stage2, y.ndim - 3, consts)
        y = torch.swapaxes(y, -4, -3)                  # (k2, k1) digit order
        return y.reshape(*lead, self.n, L, 2)


class _ConvAxisPlan(AxisPlan):
    """Shared shape of Bluestein and Rader: a smooth length-m forward FFT
    (``fwd``) and inverse FFT (``inv``) around a pointwise product.  The
    mid form needs both inner plans to have one, and is preferred only
    when both prefer it (four-step inners take the movedim fallback)."""

    def _inner(self, m: int, max_sub: int, tuning):
        self.fwd = make_smooth_plan(m, "forward", f"{self.prefix}/mf", max_sub,
                                    tuning=tuning)
        self.inv = make_smooth_plan(m, "inverse", f"{self.prefix}/mi", max_sub,
                                    tuning=tuning)

    @property
    def supports_mid(self) -> bool:
        return self.fwd.supports_mid and self.inv.supports_mid

    @property
    def prefer_mid(self) -> bool:
        return self.fwd.prefer_mid and self.inv.prefer_mid


class BluesteinAxisPlan(_ConvAxisPlan):
    """Arbitrary-length FFT via chirp-Z embedding into a smooth length M.

    M = next smooth >= 2N-1.  The 1/M of the inverse M-FFT is folded into
    the precomputed kernel spectrum: chirp mul -> M-FFT -> pointwise ->
    inverse M-FFT -> chirp mul.
    """
    kind = "bluestein"

    def __init__(self, n: int, direction: str, prefix: str, max_sub: int = 32,
                 tuning=None):
        super().__init__(n, prefix)
        self.direction = direction
        self.m = factors.next_smooth_at_least(max(2 * n - 1, 1))
        self._inner(self.m, max_sub, tuning)

    def consts(self) -> Dict[str, np.ndarray]:
        ca, cb = const_pair(dft.bluestein_chirp(self.n, self.direction))
        ha, hb = const_pair(dft.bluestein_kernel_fft(self.n, self.m, self.direction))
        out = {
            f"{self.prefix}/chirpa": ca, f"{self.prefix}/chirpb": cb,
            f"{self.prefix}/hffta": ha, f"{self.prefix}/hfftb": hb,
        }
        out.update(self.fwd.consts())
        out.update(self.inv.consts())
        return out

    def apply(self, x, consts):
        n, m, p = self.n, self.m, self.prefix
        a = cmul_const(x, consts[f"{p}/chirpa"], consts[f"{p}/chirpb"])
        a = F.pad(a, (0, 0, 0, m - n))                 # zero-pad axis -2 to m
        s = self.fwd.apply(a, consts)
        s = cmul_const(s, consts[f"{p}/hffta"], consts[f"{p}/hfftb"])
        y = self.inv.apply(s, consts)
        return cmul_const(y[..., :n, :], consts[f"{p}/chirpa"], consts[f"{p}/chirpb"])

    def apply_mid(self, x, consts):
        """Transform along axis -3 of (..., n, L, 2): the chirp and kernel
        tables broadcast over the riding lane dim L."""
        n, m, p = self.n, self.m, self.prefix

        def bc(name):
            return consts[name][:, None, :]            # (len, 1, 2) rides L

        a = cmul_const(x, bc(f"{p}/chirpa"), bc(f"{p}/chirpb"))
        a = F.pad(a, (0, 0, 0, 0, 0, m - n))           # zero-pad axis -3 to m
        s = self.fwd.apply_mid(a, consts)
        s = cmul_const(s, bc(f"{p}/hffta"), bc(f"{p}/hfftb"))
        y = self.inv.apply_mid(s, consts)
        return cmul_const(y[..., :n, :, :], bc(f"{p}/chirpa"), bc(f"{p}/chirpb"))


class RaderAxisPlan(_ConvAxisPlan):
    """Prime-length DFT as a length-(p-1) cyclic convolution.

    The convolution runs at smooth length m (= p-1 when smooth, else a
    wrapped-kernel embedding at the next smooth >= 2(p-1)-1), with 1/m
    folded into the precomputed kernel spectrum.  ``perm_in`` and
    ``scatter`` are int32 index tables.
    """
    kind = "rader"

    def __init__(self, n: int, direction: str, prefix: str, max_sub: int = 32,
                 tuning=None):
        if not factors.is_prime(n):
            raise ValueError(f"Rader axis requires prime length, got {n}")
        super().__init__(n, prefix)
        self.direction = direction
        perm_in, perm_out, bfft, m = dft.rader_tables(n, direction)
        self.m = m
        self._perm_in = perm_in.astype(np.int32)
        # inverse of perm_out: inv[k-1] = j with perm_out[j] == k
        inv = np.zeros(n - 1, dtype=np.int32)
        for j, k in enumerate(perm_out):
            inv[int(k) - 1] = j
        self._scatter_idx = inv
        self._bfft = bfft
        self._inner(m, max_sub, tuning)

    def consts(self) -> Dict[str, np.ndarray]:
        ba, bb = const_pair(self._bfft)
        out = {
            f"{self.prefix}/perm_in": self._perm_in,
            f"{self.prefix}/scatter": self._scatter_idx,
            f"{self.prefix}/bffta": ba, f"{self.prefix}/bfftb": bb,
        }
        out.update(self.fwd.consts())
        out.update(self.inv.consts())
        return out

    def _apply_at(self, x, consts, dim: int, bc):
        """The transform along array dim ``dim`` (-2 rows form, -3 mid
        form); ``bc`` shapes a (len, 2) table to broadcast there."""
        p_, m, L = self.prefix, self.m, self.n - 1
        dim = x.ndim + dim
        x0 = x.narrow(dim, 0, 1)
        bin0 = x.sum(dim=dim, keepdim=True)                  # X[0] = sum x[n]
        a = x.index_select(dim, consts[f"{p_}/perm_in"])     # a[i] = x[g^i]
        if m > L:
            a = F.pad(a, (0, 0) * (x.ndim - 1 - dim) + (0, m - L))
        mid = dim == x.ndim - 3
        s = self.fwd.apply_mid(a, consts) if mid else self.fwd.apply(a, consts)
        s = cmul_const(s, bc(consts[f"{p_}/bffta"]), bc(consts[f"{p_}/bfftb"]))
        conv = self.inv.apply_mid(s, consts) if mid else self.inv.apply(s, consts)
        xk = x0 + conv.narrow(dim, 0, L)                     # X[g^{-j}] = x[0] + conv[j]
        tail = xk.index_select(dim, consts[f"{p_}/scatter"])
        return torch.cat([bin0, tail], dim=dim)

    def apply(self, x, consts):
        return self._apply_at(x, consts, -2, lambda t: t)

    def apply_mid(self, x, consts):
        """Transform along axis -3 of (..., p, L, 2): gathers address the
        prime axis and the kernel spectrum broadcasts over the lane dim."""
        return self._apply_at(x, consts, -3, lambda t: t[:, None, :])


# tuning.largeRoute == "out-of-core" forces four-step on axes >= this
FOUR_STEP_FORCE_MIN_N = 4096


def four_step_eligible(n: int, tuning) -> bool:
    """Should a smooth axis of length n take the four-step route?  (The JAX
    package also forces it past its TPU operand bound; the port drops that
    necessity clause.)"""
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
    """MixedAxisPlan, or FourStepAxisPlan when the axis is four-step
    eligible under ``tuning``."""
    if n > 1 and four_step_eligible(n, tuning):
        return FourStepAxisPlan(n, direction, prefix, max_sub, out_scale)
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
    max_sub = tuning.max_sub_length
    if kind == "mixed":
        return make_smooth_plan(n, direction, prefix, max_sub, tuning=tuning)
    if kind == "rader":
        return RaderAxisPlan(n, direction, prefix, max_sub, tuning=tuning)
    return BluesteinAxisPlan(n, direction, prefix, max_sub, tuning=tuning)


def apply_along_axis(x, axis_plan: AxisPlan, array_axis: int, consts):
    """Apply an axis plan along complex array axis ``array_axis`` of
    interleaved x (..., 2).

    Non-last axes use the W4 mid-axis form when the plan prefers it (the
    trailing complex dims merge into a riding lane dim: a free reshape).
    Four-step plans, and Rader/Bluestein plans with four-step inners, move
    the axis last, transform, and move it back.
    """
    last = x.ndim - 2
    if array_axis == last:
        return axis_plan.apply(x, consts)
    if axis_plan.supports_mid and axis_plan.prefer_mid:
        lead = x.shape[:array_axis]
        n = x.shape[array_axis]
        v = x.reshape(*lead, n, -1, 2)           # L = trailing complex elems
        y = axis_plan.apply_mid(v, consts)
        return y.reshape(x.shape)
    y = axis_plan.apply(torch.movedim(x, array_axis, last), consts)
    return torch.movedim(y, last, array_axis)
