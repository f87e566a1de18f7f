"""Direct small spatial convolution plan (k in {1,2,3}, stride 1, zero pad).

Port of ``webgpufft_tpu/plans/conv2d.py``.  The JAX package lowers this to
``lax.conv_general_dilated`` outside any of its kernels; the counterpart
here is ``torch.nn.functional.conv2d``.  Complex inputs and kernels become
channel-mixing real convolutions (two channels in and out with the
[[re, im], [-im, re]] mixing weights), so no complex arithmetic is needed.

Both compute cross-correlation (no kernel flip).  The JAX plan runs at
``Precision.HIGHEST``; cuDNN would run a float32 convolution in TF32 by
default, so the convolution runs with TF32 switched off for its own call
only (no global flag is touched).  Autograd runs the backward convolutions
later, outside that scope, so the convolution is a ``torch.autograd.Function``
(``_ConvF32``) whose backward and JVP open the same scope again: gradients
with respect to data and kernel are full f32 whatever the caller's flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime.policy import knob_reasons
from ..spec import PlanError, PlanSpec
from .base import Plan, RouteInfo


def _no_tf32():
    """cuDNN flags scope with TF32 off; ``flags()`` resets what it is not
    given, so the caller's other cuDNN settings are passed through."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _ConvF32(torch.autograd.Function):
    """``F.conv2d(x, w, groups=groups)`` (stride 1, no padding) in full f32,
    forward, backward and forward-mode.  The map is bilinear in (x, w): the
    JVP is the convolution of each tangent with the other operand, and the
    backward runs torch's own convolution-gradient ops under the same scope."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, groups):
        with _no_tf32():
            return F.conv2d(x, w, groups=groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, ctx.groups = inputs
        ctx.save_for_backward(x, w)
        ctx.save_for_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _no_tf32():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, g, groups=ctx.groups)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, g, groups=ctx.groups)
        return gx, gw, None

    @staticmethod
    def jvp(ctx, tx, tw, _groups):
        x, w = ctx.saved_tensors
        out = None
        if tx is not None:
            out = _ConvF32.apply(tx, w, ctx.groups)
        if tw is not None:
            part = _ConvF32.apply(x, tw, ctx.groups)
            out = part if out is None else out + part
        return out


def conv2d_geometry(spec: PlanSpec):
    """Derive pads and input shape from the output shape."""
    c = spec.conv
    k = c.kernel_size
    hout, wout = spec.shape
    if c.padding == "same":
        p = k // 2
        pt, pb = p, k - 1 - p
        pl, pr = p, k - 1 - p
    elif c.padding == "valid":
        pt = pb = pl = pr = 0
    else:
        pt, pb, pl, pr = c.pad
    hin = hout + (k - 1) - pt - pb
    win = wout + (k - 1) - pl - pr
    if hin <= 0 or win <= 0:
        raise PlanError(f"derived conv2d input shape invalid: Hin={hin} Win={win}")
    if c.padding == "valid" and (hin - k + 1 != hout or win - k + 1 != wout):
        raise PlanError('padding="valid" requires output [Hin-k+1, Win-k+1]')
    return (pt, pb, pl, pr), (hin, win)


def build_conv2d(spec: PlanSpec, device: torch.device) -> Plan:
    """Real ``(batch, Hin, Win)`` or interleaved ``(batch, Hin, Win, 2)`` data
    with a real ``(k, k)`` or complex ``(k, k, 2)`` kernel given at exec."""
    c = spec.conv
    k, ktype, batch = c.kernel_size, c.kernel_type, spec.batch
    pads, (hin, win) = conv2d_geometry(spec)
    pt, pb, pl, pr = pads

    route = RouteInfo(mode="xla", impl="xla", axis_kinds=(),
                      reasons=("conv2d-xla-conv",) + knob_reasons(spec),
                      attempts=("xla",))

    def conv(x_nchw, w_oihw, groups=1):
        return _ConvF32.apply(F.pad(x_nchw, (pl, pr, pt, pb)), w_oihw.contiguous(), groups)

    def fn(consts_, x, kernel, out=None):
        if x.ndim == 3:  # real data (batch, Hin, Win)
            if ktype == "complex":
                raise PlanError("real input does not support complex kernel")
            return conv(x[:, None], kernel.reshape(1, 1, k, k))[:, 0]
        # complex interleaved (batch, Hin, Win, 2) -> channels (re, im)
        xc = x.permute(0, 3, 1, 2)
        if ktype == "real":
            # depthwise: each component convolved with the same real kernel
            y = conv(xc, kernel.reshape(1, 1, k, k).expand(2, 1, k, k), groups=2)
        else:
            # complex kernel (k, k, 2): out_re = wr*re - wi*im, out_im = wi*re + wr*im
            wr, wi = kernel[..., 0], kernel[..., 1]
            w = torch.stack([torch.stack([wr, -wi]), torch.stack([wi, wr])])   # (O, I, k, k)
            y = conv(xc, w)
        return y.permute(0, 2, 3, 1).contiguous()

    plan = Plan(spec, {}, fn, route, device=device, input_shape=None,
                output_shape=None, needs_kernel=True,
                workspace_bytes=batch * hin * win * 8)
    plan.in_shape = (hin, win)
    plan.pad = pads

    def coerce_kernel(kernel):
        kernel = plan._kernel_tensor(kernel)
        if ktype == "real":
            if kernel.numel() != k * k:
                raise PlanError(f"conv2d real kernel must have {k * k} taps")
            return kernel.reshape(k, k)
        if kernel.numel() != k * k * 2:
            raise PlanError(f"conv2d complex kernel must have {k * k} complex taps")
        return kernel.reshape(k, k, 2)

    plan._coerce_kernel = coerce_kernel
    return plan
