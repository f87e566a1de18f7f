"""K2 in a design the caller names: the direct one, or the ring.

No Pallas probe stands behind this module: it launches the counterpart of
K2 (``webgpufft_tpu/core/fused_cols.py:161``) in one of its designs by name,
for the one-run comparison of ``chip_probes/k1_k2_ring.py``.  The plans'
entry point picks the design by tile (``csrc/cols.cuh``, ``cols_design``;
``fused_cols.launch_shape`` says which it takes); here the caller does:
``cols_variant(x, tables, design)`` (``csrc/probes/cols_variants.cu``) with
``"direct"``, the direct design (a CTA loads its tile from global memory
straight into registers, runs the passes, stores; the only place it is still
launched where the ring serves a view); ``"ring"``, persistent CTAs with a
ring of two stages, a tile landing by a 3-D tensor map where its rows are
16-byte aligned and whole (``cp.async`` otherwise), as the plans run it;
``"ring-async"``, every tile landing row by row by ``cp.async``.

The ring designs take any chain of two or more passes whose tile fits two
stages, smaller tiles too.  The wrapper runs the kernel's plain version on a
CPU tensor and launches or raises on a CUDA tensor; ``launches`` counts
kernel launches only.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import _build
from ..core import fused_cols, radix

COLS_DESIGNS = {"direct": 0, "ring": 1, "ring-async": 2}


def cols_variant(x: torch.Tensor, tables: Dict[str, torch.Tensor], design: str,
                 adjoint: bool = False) -> torch.Tensor:
    """K2's transform (its adjoint with ``adjoint``) along axis 1 of
    interleaved float32 ``x`` (pre, H, L) in ``design``.  A CUDA tensor
    launches the probe kernel (and counts one launch); a CPU tensor runs
    ``fused_cols.fused_cols_reference``."""
    if design not in COLS_DESIGNS:
        raise ValueError(f"cols_variant: design must be one of {sorted(COLS_DESIGNS)}, "
                         f"got {design!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cols_variant: unsupported device {x.device}")
    fused_cols._check_cuda(x)
    if x.device.type == "cpu":
        return fused_cols.fused_cols_reference(x, tables, adjoint)
    h = x.shape[1]
    ptrs = _build.table_ptrs(x, tables, {"cw": (h, 2), "cp": (2,)}, "cols_variant")
    lib = _build.library("probes")
    y = torch.empty_like(x)
    with _build.on_device(x.device):
        rc = lib.wgfft_cols_variant(x.data_ptr(), y.data_ptr(), *ptrs, x.shape[0], h,
                                    x.shape[2] // 2, *_build.chain_arg(radix.radix_chain(h)),
                                    int(adjoint), COLS_DESIGNS[design],
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"cols_variant {design}", "probes")
    cols_variant.launches += 1
    return y


cols_variant.launches = 0
