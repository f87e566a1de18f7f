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
    """The distributed export still waits for ROADMAP P12; the pipeline
    export (P10) is ported, so its entry points raise only on what they
    cannot take (here an object that is neither a function nor bytes)."""
    with pytest.raises(T.PlanError) as err:
        getattr(T, fn)(object())
    assert ("ROADMAP" in str(err.value)) == (item == "P12")
    if item == "P12":
        assert f"ROADMAP {item}" in str(err.value)


# ---------------------------------------------------------------------------
# pipeline export, as tests/test_aot.py::TestExportPipeline
# ---------------------------------------------------------------------------

def _denoise(pkg, n):
    """The JAX test's stft -> mask -> istft pipeline on ``pkg``'s facade."""
    def denoise(sig):
        _, _, z = pkg.fft.stft(sig, nperseg=128, noverlap=64)
        mag = z[..., 0] ** 2 + z[..., 1] ** 2
        z = z * (mag > 1e-4)[..., None]
        _, back = pkg.fft.istft(z, nperseg=128, noverlap=64)
        return back[..., :n]
    return denoise


def test_stft_mask_istft_pipeline(rng, tmp_path):
    """Both packages export, load and replay the same pipeline on the same
    input; each replay equals its eager call at 1e-6 (the JAX test's bar)
    and the port's equals the JAX package's at 1e-5 of max|expected|."""
    import jax
    import webgpufft_tpu as W

    n = 2048
    x = rng.standard_normal(n).astype(np.float32)
    jdenoise = _denoise(W, n)
    jpipe = W.load_exported_pipeline(
        W.export_pipeline(jdenoise, jax.ShapeDtypeStruct((n,), np.float32)))
    jgot = np.asarray(jpipe(x))
    assert np.max(np.abs(jgot - np.asarray(jdenoise(x)))) < 1e-6

    tdenoise = _denoise(T, n)
    xt = torch.from_numpy(x)
    blob = T.export_pipeline(tdenoise, xt, path=str(tmp_path / "pipe.bin"))
    for src in (blob, str(tmp_path / "pipe.bin")):
        pipe = T.load_exported_pipeline(src)
        assert isinstance(pipe, T.ExportedPipeline)
        assert pipe.shapes == [(n,)] == jpipe.shapes and pipe.platforms == ("cpu",)
        got = pipe(xt)
        want = tdenoise(xt)
        assert got.shape == want.shape == jgot.shape
        assert float((got - want).abs().max()) < 1e-6
        np.testing.assert_array_equal(pipe(x).numpy(), got.numpy())   # numpy in
    assert float(np.max(np.abs(got.numpy() - jgot))) <= 1e-5 * np.max(np.abs(jgot))


def test_pipeline_program_calls_the_kernel_ops(rng):
    """The program records K1/K2 as the dispatcher ops and carries the
    plan tables as constants; a replay on the CPU runs the ops' plain
    versions."""
    x = torch.from_numpy(rng.standard_normal((4, 64, 64, 2)).astype(np.float32))
    pipe = T.load_exported_pipeline(T.export_pipeline(
        lambda v: T.fft.ifft2(T.fft.fft2(v, interleaved=True) * 2.0, interleaved=True), x))
    code = pipe.program.graph_module.code
    assert "torch.ops.wgfft.fused_lines" in code and "torch.ops.wgfft.fused_cols" in code
    assert torch.allclose(pipe(x), 2.0 * x, atol=1e-5)


def test_pipeline_validation():
    """``ValueError`` on another schema (an ``export_plan`` blob), as the
    JAX package; ``PlanError`` on a truncated or corrupt header.  The JAX
    case's ``sosfilt`` pipeline waits for the port's filtering (ROADMAP
    P11.3)."""
    plan_blob = T.export_plan(T.create_plan({"type": "c2c", "shape": [16]}, device="cpu",
                                            cache=T.PlanCache()))
    with pytest.raises(ValueError, match="not a pipeline"):
        T.load_exported_pipeline(plan_blob)
    with pytest.raises(T.PlanError, match="truncated"):
        T.load_exported_pipeline(b"1234")
    with pytest.raises(T.PlanError, match="bad header length"):
        T.load_exported_pipeline((10 ** 6).to_bytes(8, "big") + b"xx")
    with pytest.raises(T.PlanError, match="corrupt"):
        T.load_exported_pipeline((4).to_bytes(8, "big") + b"\xff{{{" + b"rest")
    head = ('{"schema": "%s", "version": 9}' % aot.PIPELINE_SCHEMA).encode()
    with pytest.raises(T.PlanError, match="version"):
        T.load_exported_pipeline(len(head).to_bytes(8, "big") + head + b"x")


def test_plan_first_built_inside_export_is_cached_with_real_tables(rng):
    """A plan first built while ``torch.export`` traces (fake and proxy
    modes on) enters the long-lived PlanCache with plain tensors, and a
    later eager call through the cache runs it."""
    T.default_cache().clear()
    x = torch.from_numpy(rng.standard_normal((3, 40, 2)).astype(np.float32))
    T.export_pipeline(lambda v: T.fft.fft(v, interleaved=True), x)
    plans = list(T.default_cache()._plans.values())
    assert plans, "no plan was built during the export"
    for plan in plans:
        for name, table in plan.consts.items():
            assert type(table) is torch.Tensor, (name, type(table))
    assert torch.allclose(T.fft.fft(x, interleaved=True),
                          torch.view_as_real(torch.fft.fft(torch.view_as_complex(x))),
                          atol=1e-4)


def _op_case(kernel, rng):
    """One kernel op's module, a float32 CPU input and its named tables."""
    from webgpufft_tpu_torch.core import fused, fused_cols
    if kernel == "fused_lines":
        mod, x = fused, rng.standard_normal((3, 24, 2))
        consts = fused.lines_consts(24, "forward", 1.0, "p")
    else:
        mod, x = fused_cols, rng.standard_normal((2, 20, 6))
        consts = fused_cols.cols_consts(20, "inverse", 0.5, "p")
    named = {k.split("/")[1]: torch.from_numpy(v) for k, v in consts.items()}
    return mod, torch.from_numpy(x.astype(np.float32)), named


@pytest.mark.parametrize("kernel", ["fused_lines", "fused_cols"])
@pytest.mark.parametrize("adjoint", [False, True])
def test_kernel_ops_opcheck(kernel, adjoint, rng):
    """``torch.library.opcheck`` of both ops on CPU tensors: schema, fake
    implementation, autograd registration and the AOT dispatch tests."""
    mod, x, named = _op_case(kernel, rng)
    plain = getattr(mod, f"{kernel}_reference")
    op = getattr(mod, f"{kernel}_op")
    x = x.requires_grad_()
    torch.library.opcheck(op, (x, mod.table_list(named), adjoint))
    got = getattr(torch.ops.wgfft, kernel)(x.detach(), mod.table_list(named), adjoint)
    assert torch.equal(got, plain(x.detach(), named, adjoint))


@pytest.mark.parametrize("kernel", ["fused_lines", "fused_cols"])
@pytest.mark.parametrize("adjoint", [False, True])
def test_kernel_ops_backward_matches_autograd_of_the_plain_version(kernel, adjoint, rng):
    """The ops' registered backward (the adjoint launch) against autograd
    through the plain version, for a random cotangent, at 1e-5 of
    max|expected|."""
    mod, x, named = _op_case(kernel, rng)
    plain = getattr(mod, f"{kernel}_reference")
    g = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32))
    xo, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = getattr(torch.ops.wgfft, kernel)(xo, mod.table_list(named), adjoint)
    got, = torch.autograd.grad(y, xo, g)
    want, = torch.autograd.grad(plain(xp, named, adjoint), xp, g)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
