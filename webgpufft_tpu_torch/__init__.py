"""webgpufft_tpu_torch — the PyTorch / CUDA port of webgpufft_tpu.

Same options dict, same ``spec.py`` validation, same interleaved float32
``(batch, *shape, 2)`` layout and the same route metadata as the JAX
package, on torch tensors, with the JAX package's Pallas kernels rewritten
as hand-written CUDA kernels for Hopper (``csrc/*.cu``, built with nvcc on
first use):

    plan = create_plan({"type": "c2c", "shape": [1024], "batch": 4096,
                        "direction": "forward", "normalize": "unitary"},
                       device="cuda")
    y = plan(x)              # x: float32 (4096, 1024, 2) on the plan's device

Every plan type of ``spec.py`` is ported: c2c over any axis length
(mixed-radix, four-step, Rader, Bluestein), r2c/c2r (packed half-spectrum
along logical axis 0), dct1-4/dst1-4, fftconv (with its overlap-save route
and channel-lane presets) and conv2d, each with the staging options (layout
strides, ``whdcn`` lanes, ioView, zeroPad, bf16-storage, inPlace, exec-time
offsets, ``out=``, ``BufferView``).  Plans are differentiable
(``torch.autograd.grad``, ``torch.func.grad/vjp/jvp/vmap``): the backward of
a kernel pass is the adjoint launch of the same kernel.  The runtime
services are ported too: the plan cache with snapshots, the measured planner
(``tuning.rigor: "measure"``), golden-artifact replay, profiling and tracing
helpers, the selftest and single-plan export.

The functional facade sits on top: ``from webgpufft_tpu_torch import fft as
wfft`` gives the numpy.fft / scipy.fft / scipy.signal surface on torch
tensors (``fftapi.py``; a tensor runs on the device it lives on, anything
else on the facade's default device, ``"cuda"``), with ``windows``,
``ShortTimeFFT``, the scipy.fft uarray backend, the ``fftpack`` and
``pyfftw`` namespaces and a native ``torch_fft`` namespace beside it.
Above the facade: ``nufft`` (types 1-3 in 1-3 dimensions), ``linalg``
(circulant and Toeplitz solves and products), the host DSP modules
``iirdesign``, ``peaks`` and ``waveforms``, and the DSP toolboxes
``filtering`` (FIR filters on the plan layer's convolution, the IIR and
second-order-section recurrences, Savitzky-Golay, Wiener, order
statistics; the whole scipy.signal call set in one namespace), ``ltisys``
(LTI conversions and the state-space simulations), ``splines`` and
``ndimage`` (Fourier-domain filters).  ``export_pipeline`` /
``load_exported_pipeline`` carry any chain of facade calls as one
``torch.export`` program, in which K1 and K2 are the dispatcher ops
``wgfft::fused_lines`` / ``wgfft::fused_cols`` that importing this package
registers.

The multi-GPU layer is ``parallel`` (``make_mesh``, the distributed
builders, ``create_distributed_plan``, also exported here) on
``torch.distributed``: ``DeviceMesh``, ``DTensor`` and differentiable
collectives; the caller initialises the process group.
``export_distributed_plan`` raises ``PlanError`` naming the ROADMAP item
that ports it.  The package imports torch and numpy (and scipy lazily,
where the JAX package does), never JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .spec import PlanError, PlanSpec, normalize_spec
from .plans.base import Plan, RouteInfo
from .runtime.cache import (PlanCache, default_cache,
                            enable_persistent_compilation_cache,
                            export_plan_cache_snapshot,
                            import_plan_cache_snapshot)
from .runtime.aot import (ExportedPipeline, ExportedPlan, export_distributed_plan,
                          export_pipeline, export_plan, load_exported_pipeline,
                          load_exported_plan)
from .core.cplx import interleave, uninterleave
from .utils.bufferview import BufferView
from . import fftapi
from . import fftapi as fft
from . import fftpack, pyfftw, torch_fft, windows
from . import iirdesign, linalg, nufft, peaks, waveforms
from . import filtering, ltisys, ndimage, splines
from .scipy_backend import (ScipyFftBackend, install_scipy_fft_backend,
                            scipy_fft_backend, uninstall_scipy_fft_backend)
from .shorttime import ShortTimeFFT

__version__ = "0.1.0"

__all__ = [
    "create_plan", "create_fft_plan", "tables_from_reference", "Plan",
    "PlanSpec", "PlanError", "RouteInfo", "PlanCache", "default_cache",
    "export_plan_cache_snapshot", "import_plan_cache_snapshot",
    "enable_persistent_compilation_cache",
    "export_plan", "load_exported_plan", "ExportedPlan",
    "export_pipeline", "load_exported_pipeline", "ExportedPipeline",
    "export_distributed_plan", "create_distributed_plan",
    "interleave", "uninterleave", "BufferView",
    "upload_complex", "download_complex",
    "create_fftconv_channel_lane_preset",
    "create_fftconv_kernel_major_channel_lane_preset",
    "create_fftconv_batch_major_channel_lane_preset",
    "fft", "fftapi", "windows", "ShortTimeFFT", "ScipyFftBackend",
    "scipy_fft_backend", "install_scipy_fft_backend",
    "uninstall_scipy_fft_backend", "torch_fft", "fftpack", "pyfftw",
    "nufft", "linalg", "iirdesign", "peaks", "waveforms",
    "filtering", "ltisys", "splines", "ndimage",
]


def create_distributed_plan(opts=None, *, mesh, batch_axis=None,
                            seq_axis=None, **kwargs):
    """Multi-GPU plan from reference-style options (``parallel/plans.py``).
    ``mesh`` is a ``DeviceMesh`` (``parallel.make_mesh``); ``batch_axis``
    shards the batch (data parallel), ``seq_axis`` distributes single
    transforms over ranks (all_to_all digit exchange)."""
    from .parallel.plans import create_distributed_plan as _impl
    return _impl(opts, mesh=mesh, batch_axis=batch_axis, seq_axis=seq_axis,
                 **kwargs)


def upload_complex(z, device="cuda") -> torch.Tensor:
    """numpy complex array -> interleaved float32 tensor on ``device``."""
    return torch.as_tensor(interleave(np.asarray(z)), device=_resolve_device(device))


def download_complex(x) -> np.ndarray:
    """Interleaved tensor (or array) -> numpy complex128."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return uninterleave(np.asarray(x))


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"webgpufft_tpu_torch: plan device {dev} requested but "
                "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise PlanError(f"unsupported plan device {dev}")
    return dev


def _build_plan(spec: PlanSpec, device: torch.device) -> Plan:
    """Dispatch a normalized spec to its plan builder."""
    t = spec.plan_type
    if t == "c2c":
        from .plans.transforms import build_c2c
        return build_c2c(spec, device)
    if t == "r2c":
        from .plans.transforms import build_r2c
        return build_r2c(spec, device)
    if t == "c2r":
        from .plans.transforms import build_c2r
        return build_c2r(spec, device)
    if t.startswith("dct") or t.startswith("dst"):
        from .plans.transforms import build_dct
        return build_dct(spec, device)
    if t == "fftconv":
        from .plans.fftconv import build_fftconv
        return build_fftconv(spec, device)
    if t == "conv2d":
        from .plans.conv2d import build_conv2d
        return build_conv2d(spec, device)
    raise PlanError(f"unknown plan type {t!r}")


def create_plan(opts: Optional[Dict[str, Any]] = None, *, device="cuda",
                cache: Optional[PlanCache] = None, **kwargs) -> Plan:
    """Create (or fetch from cache) an executable transform plan on
    ``device`` (default ``"cuda"``, which fails loudly without a GPU).

    Accepts a reference-style options dict and/or keyword arguments, as
    ``webgpufft_tpu.create_plan`` does.

    A reference-style ``cache`` option may carry a snapshot to prewarm from:
    ``create_plan({..., "cache": {"snapshot": snap}})`` imports the snapshot
    into the active plan cache (its plans built on ``device``) before
    building.  ``tuning.rigor: "measure"`` times route candidates on
    ``device`` and returns the winner (``runtime/measure.py``).
    """
    merged = dict(opts or {})
    merged.update(kwargs)
    if isinstance(cache, dict):
        if "cache" in merged:
            raise PlanError(
                "cache option given both in the options dict and as a "
                "keyword; pass it once")
        merged["cache"] = cache
        cache = None
    target = cache if cache is not None else default_cache()
    copt = merged.pop("cache", None)
    if copt is not None:
        if not isinstance(copt, dict):
            raise PlanError("cache option must be a dict (e.g. {'snapshot': snap})")
    dev = _resolve_device(device)
    if copt is not None and copt.get("snapshot") is not None:
        import_plan_cache_snapshot(copt["snapshot"], cache=target, device=dev)
    spec = normalize_spec(merged)
    if spec.tuning.rigor == "measure":
        # FFTW_MEASURE-style planner: time route candidates on the device
        # and build the winner; the decision caches on the PlanCache and
        # persists through snapshots
        from .runtime.measure import run_measure
        spec, notes, built = run_measure(spec, target, dev)
        fresh = target.get(spec, dev) is None
        if built is not None:
            target.adopt(spec, built)    # reuse the plan built for timing
        plan = target.get_or_create(spec, dev)
        if fresh and notes:
            # annotate only a plan this call created: a cache-shared plan
            # may already be held by estimate-rigor callers whose route
            # metadata must not change under them
            plan.route = dataclasses.replace(
                plan.route, reasons=plan.route.reasons + tuple(
                    n for n in notes if n not in plan.route.reasons))
        return plan
    return target.get_or_create(spec, dev)


def create_fft_plan(opts: Optional[Dict[str, Any]] = None, *, device="cuda",
                    **kwargs) -> Plan:
    """Low-level alias constrained to c2c."""
    merged = dict(opts or {})
    merged.update(kwargs)
    merged.setdefault("type", "c2c")
    if merged["type"] != "c2c":
        raise PlanError("create_fft_plan builds c2c plans only")
    return create_plan(merged, device=device)


# ---------------------------------------------------------------------------
# FFTConv channel-lane preset helpers
# ---------------------------------------------------------------------------

def _lane_fragment(d: Dict[str, Any], output_side: bool) -> Dict[str, Any]:
    if not isinstance(d, dict) or "channels" not in d:
        raise PlanError("channel-lane descriptor requires 'channels'")
    out = {"channels": int(d["channels"])}
    for k in ("channelIndex", "channelStrideElements", "batchStrideElements",
              "offsetElements"):
        if k in d:
            out[k] = int(d[k])
    if output_side and "kernelStepChannels" in d:
        out["kernelStepChannels"] = int(d["kernelStepChannels"])
    return out


def create_fftconv_channel_lane_preset(opts: Dict[str, Any]) -> Dict[str, Any]:
    """Build a validated fftconv channelPolicy plan fragment.

    Returns a dict merging into create_plan options:
    ``create_plan({"type": "fftconv", **preset})``.
    """
    shape = list(opts["shape"])
    batch = int(opts.get("batch", 1))
    layout = opts.get("layout")
    if layout is not None:
        extra = set(layout) - {"interleavedComplex"}
        if extra:
            raise PlanError(f"preset layout must not include stride/whdcn fields: {extra}")
    frag: Dict[str, Any] = {
        "shape": shape,
        "batch": batch,
        "fftConv": {
            "mode": opts.get("mode", "convolution"),
            "boundary": opts.get("boundary", "circular"),
            "kernelCount": int(opts.get("kernelCount", 1)),
            "channelPolicy": {
                "input": _lane_fragment(opts["input"], False),
                "output": _lane_fragment(opts["output"], True),
            },
        },
    }
    if "kernelShape" in opts:
        frag["fftConv"]["kernelShape"] = list(opts["kernelShape"])
    if "outputLayout" in opts:
        frag["fftConv"]["outputLayout"] = opts["outputLayout"]
    return frag


def create_fftconv_kernel_major_channel_lane_preset(opts: Dict[str, Any]) -> Dict[str, Any]:
    return create_fftconv_channel_lane_preset({**opts, "outputLayout": "kernel-major"})


def create_fftconv_batch_major_channel_lane_preset(opts: Dict[str, Any]) -> Dict[str, Any]:
    return create_fftconv_channel_lane_preset({**opts, "outputLayout": "batch-major"})


def tables_from_reference(np_consts: Dict[str, np.ndarray],
                          device) -> Dict[str, torch.Tensor]:
    """Turn a JAX plan's numpy tables into this port's tables on ``device``.

    Every table passes through with its dtype (Rader's ``perm_in`` and
    ``scatter`` stay int32): the einsum route's ``ax*/…`` tables with their
    four-step (``tw*``, ``s1``, ``s2``), Bluestein (``chirp*``, ``hfft*``)
    and Rader (``bfft*``, ``perm_in``, ``scatter``) parts and inner
    ``mf``/``mi`` plans, the r2c/c2r ``rc/*`` and ``cr/*`` tables, and the
    K2 ``fc*/…`` tables.  The K1 tables under each ``fl*`` prefix are
    recovered from the JAX package's Mosaic layout by reshaping and slicing
    (``core.fused.tables_from_reference``); its Mosaic-only tables (``pil``
    and the v2 ``ta``/``tb``) are dropped.  Only the CUDA kernels' own
    tables (``cw``, ``cp`` under each ``fl*`` and ``fc*`` prefix), which the
    JAX package has no counterpart of, are built anew, from the length,
    direction and scale that the prefix's other tables give.

    The DCT/DST tables (``trig{d}``; ``dct{d}/perm``, ``/inv``, ``/xm`` as
    int32; ``/wa``, ``/wb``, ``/ua``, ``/ub``, ``/xm0``, ``/p_re``, ``/p_im``,
    ``/t_re``, ``/t_im``; the inner ``dct{d}/f/…`` or ``/i/…`` axis tables),
    fftconv's ``f/ax*`` and ``i/ax*`` and overlap-save's ``os/f``, ``os/i``
    pass through under their own names.  The JAX package runs these plan
    types on its einsum route only, so their tables match a port plan built
    with ``impl: "xla"``; a port plan whose inner passes run K1/K2 holds
    kernel tables the JAX plan has none for.
    Load the result with ``Plan.load_consts``.
    """
    from .core import fused, fused_cols
    line_prefixes = {k.rsplit("/", 1)[0] for k in np_consts if k.endswith("/g1")}
    out = {k: v for k, v in np_consts.items()
           if k.rsplit("/", 1)[0] not in line_prefixes}
    for prefix in sorted(line_prefixes):
        out.update(fused.tables_from_reference(np_consts, prefix))
    for prefix in sorted(k.rsplit("/", 1)[0] for k in np_consts if k.endswith("/w1re")):
        out.update(fused_cols.tables_from_reference(np_consts, prefix))
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in out.items()}
