"""Plan cache: in-process memoization of built plans.

Minimal port of ``webgpufft_tpu/runtime/cache.py``, keyed on
``(spec, device)`` because a port plan holds its tables on one device.
Snapshot export/import is not ported yet (ROADMAP P8).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..spec import PlanSpec


class PlanCache:
    def __init__(self):
        self._plans: Dict[Tuple[PlanSpec, torch.device], object] = {}

    def get_or_create(self, spec: PlanSpec, device: torch.device):
        key = (spec, device)
        plan = self._plans.get(key)
        if plan is None:
            from .. import _build_plan
            plan = _build_plan(spec, device)
            self._plans[key] = plan
        return plan

    def get(self, spec: PlanSpec, device: torch.device) -> Optional[object]:
        return self._plans.get((spec, device))

    def __len__(self):
        return len(self._plans)

    def clear(self):
        self._plans.clear()


_default_cache = PlanCache()


def default_cache() -> PlanCache:
    return _default_cache
