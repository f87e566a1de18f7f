"""Full float32 matmuls on the card inside a block.

The JAX package runs its recurrences' products at ``Precision.HIGHEST``
(``webgpufft_tpu/filtering.py:346-350``): the cumulative K x K products of
the associative IIR route run log2(n) rounds and a state-space step feeds
its own output back, so rounding of the operands compounds.  On the card a
float32 ``matmul`` / ``einsum`` runs in TF32 when the caller allows it
(``torch.backends.cuda.matmul.allow_tf32``, or ``fp32_precision = "tf32"``);
``full_f32()`` switches that off for its block only and gives the caller's
setting back afterwards, as ``plans/conv2d._no_tf32`` does for cuDNN.  (A
CPU float32 matmul has no TF32 mode.)

torch has two interfaces to the flag, and in torch 2.9+ reading the old one
after the new one set TF32 raises: the block saves the new one's value,
which is always readable, and restores ``"tf32"`` / ``"ieee"`` through the
old one, which leaves both readable as the caller left them.

Autograd runs a backward after the forward's block has closed, under
whatever flag the caller has then.  ``einsum`` is therefore a
``torch.autograd.Function`` whose forward, backward and JVP each open the
block (the pattern of ``plans/conv2d._ConvF32``): the plan layer's einsum
route, the DCT trig matmuls and the distributed layer's digit stages use it,
so gradients are full float32 too.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """float32 matmuls on CUDA tensors in full float32 (no TF32) inside the
    block; the caller's setting after it."""
    m = torch.backends.cuda.matmul
    if not hasattr(m, "fp32_precision"):      # a torch before the new interface
        saved = m.allow_tf32
        m.allow_tf32 = False
        try:
            yield
        finally:
            m.allow_tf32 = saved
        return
    saved = m.fp32_precision
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        if saved == "none":
            m.fp32_precision = "none"
        else:
            m.allow_tf32 = saved == "tf32"


def _operands(eq: str):
    lhs, out = eq.replace(" ", "").split("->")
    a, b = lhs.split(",")
    return a, b, out


class _EinsumF32(torch.autograd.Function):
    """``torch.einsum(eq, a, b)`` in full float32, forward, backward and
    forward-mode.  Autograd runs a backward later, outside any ``full_f32``
    block the forward ran in, so the products of the backward are this
    Function's own: each gradient is the einsum of the output's gradient
    with the other operand, through this Function again (so a second
    derivative stays in full float32 too).  Every index of an operand
    appears in the other operand or in the output, as in all of the
    package's contractions."""

    generate_vmap_rule = True

    @staticmethod
    def forward(eq, a, b):
        with full_f32():
            return torch.einsum(eq, a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.eq, a, b = inputs
        ctx.save_for_backward(a, b)
        ctx.save_for_forward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb, so = _operands(ctx.eq)
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = _EinsumF32.apply(f"{so},{sb}->{sa}", g, b)
        if ctx.needs_input_grad[2]:
            gb = _EinsumF32.apply(f"{sa},{so}->{sb}", a, g)
        return None, ga, gb

    @staticmethod
    def jvp(ctx, _eq, ta, tb):
        a, b = ctx.saved_tensors
        out = None
        if ta is not None:
            out = _EinsumF32.apply(ctx.eq, ta, b)
        if tb is not None:
            part = _EinsumF32.apply(ctx.eq, a, tb)
            out = part if out is None else out + part
        return out


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand ``torch.einsum`` whose forward, backward and JVP all run
    in full float32 (no TF32) whatever the caller's flag: the JAX package's
    ``Precision.HIGHEST`` for values and gradients alike.  A call that
    nothing differentiates skips ``Function.apply``."""
    from .radix import tracked
    if tracked(a) or tracked(b):
        return _EinsumF32.apply(eq, a, b)
    with full_f32():
        return torch.einsum(eq, a, b)
