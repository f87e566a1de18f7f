"""Pre/post staging stages: the f32 subset of ``webgpufft_tpu/plans/stages.py``.

Storage load/store are identities for f32 plans.  Every other stage of the
JAX package (strided layout, ioView, zeroPad, bf16 storage, inPlace) is not
ported yet: ``require_unstaged`` rejects a spec that asks for one
(ROADMAP P7), so no plan runs without a stage it was asked for.
"""

from __future__ import annotations

import torch

from ..spec import PlanError, PlanSpec


def require_unstaged(spec: PlanSpec) -> None:
    """Raise PlanError when ``spec`` needs a staging stage the port lacks."""
    asked = [name for name, on in (
        ("layout", not spec.layout.is_trivial),
        ("ioView", spec.io_view.input is not None or spec.io_view.output is not None),
        ("zeroPad", spec.zero_pad.read is not None or spec.zero_pad.write is not None),
        (f"precision {spec.precision!r}", spec.precision != "f32"),
        ("inPlace", spec.in_place),
    ) if on]
    if asked:
        raise PlanError(
            f"{', '.join(asked)}: staging is not ported to the PyTorch port "
            "yet (ROADMAP P7)", plan_type=spec.plan_type)


def load_storage(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision != "f32":
        raise PlanError(f"precision {precision!r} is not ported yet (ROADMAP P7)")
    return x


def store_storage(y: torch.Tensor, precision: str) -> torch.Tensor:
    if precision != "f32":
        raise PlanError(f"precision {precision!r} is not ported yet (ROADMAP P7)")
    return y


def expect_dtype(precision: str) -> torch.dtype:
    if precision != "f32":
        raise PlanError(f"precision {precision!r} is not ported yet (ROADMAP P7)")
    return torch.float32
