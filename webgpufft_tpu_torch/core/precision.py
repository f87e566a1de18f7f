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
