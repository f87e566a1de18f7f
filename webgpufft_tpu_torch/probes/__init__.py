"""Measurement kernels: what the card does with K1's building blocks.

Hand-written CUDA kernels that no plan launches.  Each answers a question
about the fused line kernel K1 (``core/fused.py``) that a profiler with
hardware counters would answer elsewhere, and each stands for one of the
JAX package's Pallas probe scripts under ``benches/`` (named in each
module's docstring):

- ``stream``: a copy through registers, through a ``cp.async`` pipeline in
  shared memory, and by the bulk-copy engine: the ceiling of a kernel that
  stages its data on chip;
- ``stages``: K1's radix chain stopped after each pass, same bytes in and
  out: what one pass costs;
- ``planes``: K1 on re/im-split planes, and K1 (and K2) in place: what the
  layout and a separate output cost;
- ``variants``: K2 in a design named by the caller, the direct one or the
  ring of stages: the one-run comparison of the two; K1's power-of-two,
  warp or mixed-radix design in a variant named by the caller
  (``lines_variant``), and its general design on any chain, class and
  lines a CTA the caller names (``general_variant``).

Every wrapper follows K1's: a CUDA tensor launches the kernel or raises, a
CPU tensor runs the plain PyTorch version, a ``launches`` counter counts
kernel launches only.  The kernels live in ``csrc/probes/`` and are built at
the first launch into a library of their own (``_build.library("probes")``).
The scripts under ``chip_probes/`` print their times.
"""

from .planes import cols_inplace, lines_inplace, lines_planes, lines_planes_reference
from .stages import lines_stages, lines_stages_reference
from .stream import stream_copy, stream_copy_reference
from .variants import cols_variant, lines_variant

__all__ = ["stream_copy", "stream_copy_reference", "lines_stages", "lines_stages_reference",
           "lines_planes", "lines_planes_reference", "lines_inplace", "cols_inplace",
           "cols_variant", "lines_variant"]
