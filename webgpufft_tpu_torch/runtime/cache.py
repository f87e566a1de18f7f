"""Plan cache + snapshot persistence.

Port of ``webgpufft_tpu/runtime/cache.py``.  Two layers:

1. ``PlanCache``: in-process memoization of built plans, keyed by
   ``(spec, device)`` because a port plan holds its tables on one device.
2. Snapshot: a JSON-serializable descriptor of every cached spec and of the
   measured-rigor decisions (``runtime/measure.py``).  Importing a snapshot
   rebuilds those plans on a device (their host tables are computed and
   uploaded once, before the first request) and restores the measured
   winners, so a serving process reuses them without re-timing.

The schema name, version and entry layout are the JAX package's, so a
snapshot exported by either package imports into the other; only
``metadata.framework`` tells them apart.  Measured decisions are keyed by
device identity, so one package's never apply to the other's devices.

What is compiled in the port is the nvcc-built kernel library, which already
persists in its build directory; ``enable_persistent_compilation_cache``
moves that directory.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..spec import PlanSpec, spec_to_dict

SNAPSHOT_SCHEMA = "webgpufft-tpu.plan-cache"
# v1: bare spec list.  v2: adds framework metadata, reported in the
# diagnostic when a spec entry fails to rebuild.  v3 (current): adds the
# measured-rigor decisions ("measured").  Legacy snapshots are upgraded on
# import.
SNAPSHOT_VERSION = 3


# A scope in which new tensors are plain tensors.  A plan's first use may
# happen inside a caller's ``torch.func.grad`` / ``vmap`` / ``jvp`` (the facade
# builds plans lazily), or inside ``torch.export`` tracing, where every new
# tensor is a fake tensor under the trace's fake and proxy modes; tensors made
# there would be wrappers of that transform's level or fakes of that trace,
# and the cache outlives both.  ``_DisableFuncTorch`` leaves the transforms,
# ``_disable_current_modes`` every dispatch mode (the tables then enter a
# trace as constants).  The names are private in torch: without them the
# cache would keep such tensors silently, so the import fails instead.
try:
    from torch.utils._python_dispatch import _disable_current_modes
    _DisableFuncTorch = torch._C._DisableFuncTorch
except (AttributeError, ImportError) as e:  # pragma: no cover - depends on the torch build
    raise ImportError(
        f"webgpufft_tpu_torch: torch {torch.__version__} lacks "
        "torch._C._DisableFuncTorch or torch.utils._python_dispatch."
        "_disable_current_modes; plans built lazily inside torch.func "
        "transforms or torch.export could not be kept out of them") from e


@contextlib.contextmanager
def _outside_transforms():
    """Build what outlives the call here: no ``torch.func`` transform and no
    dispatch mode (fake, proxy) sees the tensors made inside."""
    with _DisableFuncTorch(), _disable_current_modes():
        yield


class PlanCache:
    def __init__(self):
        self._plans: Dict[Tuple[PlanSpec, torch.device], Any] = {}
        # measured-rigor decisions: measure_key -> {winner, overrides,
        # trials_ms} (runtime/measure.py); exported in snapshots (v3)
        self.measured: Dict[str, Dict[str, Any]] = {}

    def get_or_create(self, spec: PlanSpec, device: torch.device):
        key = (spec, device)
        plan = self._plans.get(key)
        if plan is None:
            from .. import _build_plan
            with _outside_transforms():
                plan = _build_plan(spec, device)
            self._plans[key] = plan
        plan._plan_cache = self  # for plan.get_pipeline_cache_snapshot()
        return plan

    def get(self, spec: PlanSpec, device: torch.device) -> Optional[object]:
        return self._plans.get((spec, device))

    def adopt(self, spec: PlanSpec, plan) -> None:
        """Seed an externally built plan (e.g. the measured-rigor winner,
        built during timing) without rebuilding it."""
        self._plans.setdefault((spec, plan.device), plan)
        plan._plan_cache = self

    def __len__(self):
        return len(self._plans)

    def clear(self):
        self._plans.clear()
        self.measured.clear()

    def specs(self) -> List[PlanSpec]:
        """The cached specs, each once whatever devices hold a plan of it."""
        return list(dict.fromkeys(spec for spec, _ in self._plans))


_default_cache = PlanCache()


def default_cache() -> PlanCache:
    return _default_cache


def export_plan_cache_snapshot(cache: Optional[PlanCache] = None) -> Dict[str, Any]:
    from .. import __version__
    cache = cache if cache is not None else _default_cache
    specs = cache.specs()
    return {
        "schema": SNAPSHOT_SCHEMA,
        "version": SNAPSHOT_VERSION,
        "createdAtMs": int(time.time() * 1000),
        "metadata": {"plans": len(specs),
                     "framework": f"webgpufft-tpu-torch/{__version__}"},
        "specs": [spec_to_dict(s) for s in specs],
        "measured": dict(cache.measured),
    }


def upgrade_snapshot(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Upgrade a legacy snapshot to the current version (a new dict)."""
    version = snapshot.get("version")
    if version == SNAPSHOT_VERSION:
        return snapshot
    if version == 1:
        up = dict(snapshot)
        up["version"] = 2
        meta = dict(up.get("metadata") or {})
        meta.setdefault("framework", "webgpufft-tpu/legacy-v1")
        up["metadata"] = meta
        return upgrade_snapshot(up)
    if version == 2:
        up = dict(snapshot)
        up["version"] = 3
        up.setdefault("measured", {})
        return up
    raise ValueError(f"unsupported snapshot version {version}")


def import_plan_cache_snapshot(snapshot: Dict[str, Any],
                               cache: Optional[PlanCache] = None,
                               build: bool = True, device="cuda") -> int:
    """Validate a snapshot (upgrading legacy versions) and, with ``build``,
    rebuild its plans on ``device``.  Returns the number of specs accepted."""
    cache = cache if cache is not None else _default_cache
    if not isinstance(snapshot, dict) or snapshot.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(f"unrecognized plan-cache snapshot schema: "
                         f"{snapshot.get('schema') if isinstance(snapshot, dict) else type(snapshot)}")
    snapshot = upgrade_snapshot(snapshot)
    framework = (snapshot.get("metadata") or {}).get("framework", "")
    specs = []
    for d in snapshot.get("specs", []):
        try:
            specs.append(_rebuild_spec(d))
        except Exception as e:
            raise ValueError(
                f"snapshot spec entry could not be rebuilt ({e!r}); the "
                f"snapshot may come from an incompatible framework version "
                f"(recorded: {framework or 'unknown'})")
    if build and specs:
        from .. import _resolve_device
        dev = _resolve_device(device)
        for spec in specs:
            cache.get_or_create(spec, dev)
    measured = snapshot.get("measured")
    if isinstance(measured, dict):
        for k, v in measured.items():
            if isinstance(k, str) and isinstance(v, dict):
                cache.measured.setdefault(k, v)
    return len(specs)


def _rebuild_spec(d: Dict[str, Any]) -> PlanSpec:
    """Round-trip a dataclasses.asdict(PlanSpec) back into a PlanSpec."""
    from .. import spec as S

    lay = dict(d.get("layout") or {})
    for k in ("input_strides", "output_strides"):
        if lay.get(k) is not None:
            lay[k] = tuple(lay[k])
    for k in ("whdcn_input", "whdcn_output"):
        if lay.get(k) is not None:
            lay[k] = S.ChannelLane(**lay[k])
    io = d.get("io_view") or {}
    io_sides = {}
    for side in ("input", "output"):
        v = io.get(side)
        if v is not None:
            v = dict(v)
            v["shape"] = tuple(v["shape"])
            v["offset"] = tuple(v["offset"])
            io_sides[side] = S.IoViewSide(**v)
        else:
            io_sides[side] = None
    zp = d.get("zero_pad") or {}
    zp_sides = {}
    for side in ("read", "write"):
        v = zp.get(side)
        zp_sides[side] = (S.ZeroPadStage(start=tuple(v["start"]), end=tuple(v["end"]))
                          if v is not None else None)
    fc = d.get("fft_conv")
    if fc is not None:
        # drop fields a newer schema removed so old snapshots still load
        fc = {k: v for k, v in fc.items()
              if k in S.FftConvSpec.__dataclass_fields__}
        if fc.get("kernel_shape") is not None:
            fc["kernel_shape"] = tuple(fc["kernel_shape"])
        for k in ("channel_input", "channel_output"):
            if fc.get(k) is not None:
                fc[k] = S.ChannelLane(**fc[k])
        fc = S.FftConvSpec(**fc)
    conv = d.get("conv")
    if conv is not None:
        conv = dict(conv)
        if conv.get("pad") is not None:
            conv["pad"] = tuple(conv["pad"])
        conv = S.Conv2dSpec(**conv)
    tun = dict(d.get("tuning") or {})
    for k in ("force_bluestein_axes", "force_rader_axes", "ignored_webgpu_knobs"):
        tun[k] = tuple(tun.get(k, ()))
    # Snapshots from before matmulPrecision rebuild with the "auto" default:
    # resolve it as normalize_spec does, or the rebuilt spec never hits the
    # cache key a live create_plan produces.  validate_tuning guards against
    # snapshots recorded under looser rules: such entries fail the import
    # with the version diagnostic instead of rebuilding a now-forbidden
    # configuration.
    tuning = S.validate_tuning(
        S.resolve_auto_tuning(S.TuningSpec(**tun), d.get("precision", "f32")))
    return S.PlanSpec(
        plan_type=d["plan_type"], shape=tuple(d["shape"]),
        direction=d.get("direction", "forward"), batch=d.get("batch", 1),
        normalize=d.get("normalize", "none"), precision=d.get("precision", "f32"),
        in_place=d.get("in_place", False),
        layout=S.LayoutSpec(**lay) if lay else S.LayoutSpec(),
        io_view=S.IoViewSpec(**io_sides), zero_pad=S.ZeroPadSpec(**zp_sides),
        fft_conv=fc, conv=conv, tuning=tuning,
    )


def enable_persistent_compilation_cache(directory: str):
    """Keep the compiled kernel library in ``directory`` (created at the
    first build) instead of the package's own ``_build/``: a later process
    pointed at the same directory loads the library without running nvcc.
    Call it before the first CUDA launch."""
    from .. import _build
    _build.set_build_dir(Path(directory))
