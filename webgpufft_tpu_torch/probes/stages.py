"""P2, K1's radix chain stopped after ``stop`` passes.

Counterpart of the JAX package's Pallas probe ``benches/r2_pallas_probe.py:56``
(``main.make(stage)``, call ``:80``): the fused line kernel cut short at
successive points with identical input and output bytes, so that the
difference between neighbouring cuts is what one step costs inside the
kernel.  On this card the steps are the passes of K1's radix chain
(``core/radix.py``).  ``csrc/probes/lines_stages.cu`` runs the first ``stop``
passes in K1's CTA shape and writes the shared-memory lines out in position
order: ``stop = 0`` is the copy every other stop contains, ``stop = count``
is K1's output (scale included).

The probe runs K1's direct design on ``radix.radix_chain(N)`` at every
length, also where K1 itself runs its power-of-two or mixed-radix design on
another chain (``radix.POW2_LINES``, ``radix.MIXED_LINES``): it takes K1's
tables and reads ``cw`` in the direct design's order
(``radix.direct_tables``).

The plain version is ``radix.radix_chain_reference`` cut at ``stop``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import _build
from ..core import radix


def lines_stages_reference(x: torch.Tensor, tables: Dict[str, torch.Tensor],
                           stop: int) -> torch.Tensor:
    """Plain torch version: the pass schedule of the kernels on interleaved
    ``x`` (lines, N, 2) cut after ``stop`` passes; the scale only when every
    pass ran."""
    n = x.shape[1]
    return radix.radix_chain_reference(x, radix.radix_chain(n), radix.direct_tables(tables, n),
                                       stop=stop)


def lines_stages(x: torch.Tensor, tables: Dict[str, torch.Tensor], stop: int) -> torch.Tensor:
    """The first ``stop`` passes (0 .. ``len(radix.radix_chain(N))``) of K1's
    chain on interleaved float32 ``x`` (lines, N, 2), with the ``cw`` and
    ``cp`` tables of ``fused.lines_consts``.  A CUDA tensor launches the
    probe kernel (and counts one launch); a CPU tensor runs
    ``lines_stages_reference``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lines_stages: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 2 or x.shape[0] < 1
            or not x.is_contiguous()):
        raise ValueError(
            f"lines_stages: x must be a contiguous float32 (lines, N, 2) tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    n = x.shape[1]
    chain = radix.radix_chain(n)
    if not 0 <= stop <= len(chain):
        raise ValueError(f"lines_stages: stop {stop} outside [0, {len(chain)}] for chain {chain}")
    if x.device.type == "cpu":
        return lines_stages_reference(x, tables, stop)
    ptrs = _build.table_ptrs(x, radix.direct_tables(tables, n), {"cw": (n, 2), "cp": (2,)},
                             "lines_stages")
    lib = _build.library("probes")
    y = torch.empty_like(x)
    with _build.on_device(x.device):
        rc = lib.wgfft_lines_stages(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0], n,
                                    *_build.chain_arg(chain), stop,
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "lines_stages", "probes")
    lines_stages.launches += 1
    return y


lines_stages.launches = 0
