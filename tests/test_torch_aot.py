"""Single-plan export of the PyTorch port (``runtime/aot.py``): spec, route
and tables in one blob; the loaded plan runs the exported tables and is
bit-equal to the exporting one."""

import numpy as np
import pytest
import torch

import webgpufft_tpu_torch as T
from webgpufft_tpu_torch.runtime import aot

CASES = [
    ({"type": "c2c", "shape": [64], "batch": 8, "normalize": "unitary"}, None),
    ({"type": "c2c", "shape": [8, 256], "batch": 2, "direction": "inverse"}, None),
    ({"type": "c2c", "shape": [17], "batch": 2}, None),                 # Rader: int tables
    ({"type": "r2c", "shape": [16, 6], "batch": 2}, None),
    ({"type": "dct3", "shape": [64], "batch": 8, "tuning": {"dctFftMinN": 16}}, None),
    ({"type": "c2c", "shape": [16], "batch": 2, "precision": "bf16-storage"}, None),
    ({"type": "fftconv", "shape": [16], "batch": 2,
      "fftConv": {"boundary": "linear-same", "kernelShape": [5]}}, (5, 2)),
    ({"type": "conv2d", "shape": [8, 8], "batch": 1, "conv": {"kernelSize": 3}}, (3, 3)),
]


def _io(plan, kshape, rng):
    shape = plan.input_shape or (1, *plan.in_shape)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if plan.spec.precision == "bf16-storage":
        x = x.to(torch.bfloat16)
    kw = {}
    if kshape is not None:
        kw["kernel"] = torch.from_numpy(rng.standard_normal(kshape).astype(np.float32))
    return x, kw


@pytest.mark.parametrize("opts,kshape", CASES, ids=[c[0]["type"] + str(i)
                                                    for i, c in enumerate(CASES)])
def test_export_load_is_bit_equal(opts, kshape, rng, tmp_path):
    plan = T.create_plan(opts, device="cpu", cache=T.PlanCache())
    blob = T.export_plan(plan, path=str(tmp_path / "p.bin"))
    x, kw = _io(plan, kshape, rng)
    for src in (blob, str(tmp_path / "p.bin")):
        ep = T.load_exported_plan(src, device="cpu")
        assert isinstance(ep, T.ExportedPlan) and ep.route_mode == plan.route.mode
        assert ep.spec_dict["plan_type"] == opts["type"] and ep.plan.spec == plan.spec
        assert torch.equal(ep(x, **kw), plan(x, **kw))
        for name, table in plan.consts.items():
            assert torch.equal(ep.plan.consts[name], table) and \
                ep.plan.consts[name].dtype == table.dtype


def test_loaded_plan_runs_the_exported_tables_not_rebuilt_ones(rng):
    """Scale a table in the plan before exporting: the loaded plan shows it."""
    plan = T.create_plan({"type": "c2c", "shape": [64], "batch": 8}, device="cpu",
                         cache=T.PlanCache())
    x = torch.from_numpy(rng.standard_normal((8, 64, 2)).astype(np.float32))
    ref = plan(x)
    plan.load_consts({k: (v * 2 if k.endswith("/f1re") or k.endswith("/f1im") else v)
                      for k, v in plan.consts.items()})
    ep = T.load_exported_plan(T.export_plan(plan), device="cpu")
    assert torch.allclose(ep(x), 2 * ref, rtol=1e-6, atol=1e-6)


def test_route_mismatch_raises(rng, monkeypatch):
    plan = T.create_plan({"type": "c2c", "shape": [64], "batch": 8}, device="cpu",
                         cache=T.PlanCache())
    blob = T.export_plan(plan)
    from webgpufft_tpu_torch.plans import transforms
    monkeypatch.setattr(transforms, "kernels_allowed", lambda spec: False)
    with pytest.raises(T.PlanError, match="routes the plan differently"):
        T.load_exported_plan(blob, device="cpu")


def test_bad_artifacts_raise():
    plan = T.create_plan({"type": "c2c", "shape": [8]}, device="cpu", cache=T.PlanCache())
    blob = T.export_plan(plan)
    with pytest.raises(T.PlanError, match="bytes or a path"):
        T.load_exported_plan(12)
    with pytest.raises(T.PlanError, match="corrupt"):
        T.load_exported_plan((10 ** 6).to_bytes(8, "big") + b"xx")
    with pytest.raises(T.PlanError, match="header JSON"):
        T.load_exported_plan((4).to_bytes(8, "big") + b"{{{{" + b"rest")
    head = b'{"schema": "other"}'
    with pytest.raises(T.PlanError, match="schema"):
        T.load_exported_plan(len(head).to_bytes(8, "big") + head + b"x")
    head = ('{"schema": "%s", "version": 9}' % aot.AOT_SCHEMA).encode()
    with pytest.raises(T.PlanError, match="version"):
        T.load_exported_plan(len(head).to_bytes(8, "big") + head + b"x")
    assert T.load_exported_plan(bytearray(blob), device="cpu").plan.spec == plan.spec


@pytest.mark.parametrize("fn,item", [("export_pipeline", "P10"),
                                     ("load_exported_pipeline", "P10"),
                                     ("export_distributed_plan", "P12")])
def test_pipeline_and_distributed_exports_name_their_roadmap_item(fn, item):
    with pytest.raises(T.PlanError, match=f"ROADMAP {item}"):
        getattr(T, fn)(object())
