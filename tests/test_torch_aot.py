"""Single-plan export of the PyTorch port (``runtime/aot.py``): spec, route
and tables in one blob; the loaded plan runs the exported tables and is
bit-equal to the exporting one."""

import json
import re

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


def _without_chains(blob, key, edit=None):
    """``blob`` with its header's ``key`` (``k1_chains`` or ``k2_chains``)
    dropped (an artifact written before the kernel recorded its chains), or
    replaced by ``edit(chains)``."""
    hlen = int.from_bytes(blob[:8], "big")
    meta = json.loads(blob[8:8 + hlen])
    chains = meta.pop(key)
    if edit is not None:
        meta[key] = edit(chains)
    head = json.dumps(meta).encode()
    return len(head).to_bytes(8, "big") + head + blob[8 + hlen:]


def _without_k1_chains(blob, edit=None):
    """``blob`` with its header's ``k1_chains`` dropped, or replaced by
    ``edit(chains)``."""
    return _without_chains(blob, "k1_chains", edit)


@pytest.mark.parametrize("n", [8192, 16384, 256, 2079, 6144, 1920])
def test_artifact_laid_out_for_another_k1_chain_is_refused(n, rng):
    """K1 reads ``cw`` in the order of ``radix.lines_chain(N)`` (the
    power-of-two design's at 256, 8192 and 16384, the mixed-radix design's
    at 2079 and 6144, the general design's at 1920): an export records that chain
    for every K1 table and loads; an artifact without the record (written
    when every length ran ``radix.radix_chain``) or with another chain is
    refused with a PlanError that names the table and both chains, for a
    plan and for a pipeline."""
    from webgpufft_tpu_torch.core import radix
    assert radix.lines_chain(n) != radix.radix_chain(n)
    plan = T.create_plan({"type": "c2c", "shape": [n], "batch": 8}, device="cpu",
                         cache=T.PlanCache())
    blob = T.export_plan(plan)
    hlen = int.from_bytes(blob[:8], "big")
    assert json.loads(blob[8:8 + hlen])["k1_chains"] == {"fl0/cw": list(radix.lines_chain(n))}
    x = torch.from_numpy(rng.standard_normal((8, n, 2)).astype(np.float32))
    assert torch.equal(T.load_exported_plan(blob, device="cpu")(x), plan(x))
    old = "laid out for the chain %s" % (radix.radix_chain(n),)
    with pytest.raises(T.PlanError, match=re.escape(old)):
        T.load_exported_plan(_without_k1_chains(blob), device="cpu")
    with pytest.raises(T.PlanError, match="'fl0/cw'"):
        T.load_exported_plan(_without_k1_chains(blob, lambda c: {"fl0/cw": [2] * 13}),
                             device="cpu")
    with pytest.raises(T.PlanError, match="chain None"):
        T.load_exported_plan(_without_k1_chains(blob, lambda c: {}), device="cpu")

    with T.fft.default_device("cpu"):
        pipe = T.export_pipeline(lambda v: T.fft.fft(v), x[..., 0].contiguous())
    hlen = int.from_bytes(pipe[:8], "big")
    assert json.loads(pipe[8:8 + hlen])["k1_chains"] == {f"N={n}": list(radix.lines_chain(n))}
    T.load_exported_pipeline(pipe)
    with pytest.raises(T.PlanError, match=re.escape(old)):
        T.load_exported_pipeline(_without_k1_chains(pipe))


def test_artifact_of_an_unmoved_k1_length_loads_without_the_record(rng):
    """Where K1's chain is the one it always had (every length but the
    power-of-two design's 256, 8192 and 16384), an artifact without
    ``k1_chains`` loads and runs its tables bit for bit."""
    plan = T.create_plan({"type": "c2c", "shape": [1024], "batch": 8}, device="cpu",
                         cache=T.PlanCache())
    old = _without_k1_chains(T.export_plan(plan))
    x = torch.from_numpy(rng.standard_normal((8, 1024, 2)).astype(np.float32))
    assert torch.equal(T.load_exported_plan(old, device="cpu")(x), plan(x))


def _k2_moved():
    """Heights where K2's chain (``fused_cols.cols_chain``, the general
    design's) is not ``radix_chain``'s, a few of the paths' first."""
    from webgpufft_tpu_torch.core import fused_cols, radix
    moved = [h for h in sorted({g.h for g in fused_cols.GENERAL_COLS})
             if fused_cols.cols_chain(h) != radix.radix_chain(h)]
    return [h for h in (1080, 1920, 32) if h in moved] or moved[:2]


@pytest.mark.parametrize("h", _k2_moved())
def test_artifact_laid_out_for_another_k2_chain_is_refused(h, rng):
    """K2 reads ``cw`` in the order of ``fused_cols.cols_chain(H)`` (the
    general design's at the heights of its table): an export records that
    chain for every K2 table (``k2_chains``) and loads; an artifact without
    the record (written when every height ran ``radix.radix_chain``) or with
    another chain is refused with a PlanError that names the table and both
    chains, for a plan and for a pipeline."""
    from webgpufft_tpu_torch.core import fused_cols, radix
    assert fused_cols.cols_chain(h) != radix.radix_chain(h)
    plan = T.create_plan({"type": "c2c", "shape": [h, 64], "batch": 2}, device="cpu",
                         cache=T.PlanCache())
    blob = T.export_plan(plan)
    hlen = int.from_bytes(blob[:8], "big")
    meta = json.loads(blob[8:8 + hlen])
    assert meta["k2_chains"] == {"fc0/cw": list(fused_cols.cols_chain(h))}
    assert meta["k1_chains"] == {"fl1/cw": list(radix.lines_chain(64))}
    x = torch.from_numpy(rng.standard_normal((2, h, 64, 2)).astype(np.float32))
    assert torch.equal(T.load_exported_plan(blob, device="cpu")(x), plan(x))
    old = "laid out for the chain %s" % (radix.radix_chain(h),)
    with pytest.raises(T.PlanError, match=re.escape(old)):
        T.load_exported_plan(_without_chains(blob, "k2_chains"), device="cpu")
    with pytest.raises(T.PlanError, match="K2 twiddle table 'fc0/cw'"):
        T.load_exported_plan(_without_chains(blob, "k2_chains", lambda c: {"fc0/cw": [h]}),
                             device="cpu")
    with pytest.raises(T.PlanError, match="chain None"):
        T.load_exported_plan(_without_chains(blob, "k2_chains", lambda c: {}), device="cpu")

    with T.fft.default_device("cpu"):
        pipe = T.export_pipeline(lambda v: T.fft.fft2(v), torch.view_as_complex(x))
    hlen = int.from_bytes(pipe[:8], "big")
    assert json.loads(pipe[8:8 + hlen])["k2_chains"] == {
        f"H={h}": list(fused_cols.cols_chain(h))}
    T.load_exported_pipeline(pipe)
    with pytest.raises(T.PlanError, match=re.escape(old)):
        T.load_exported_pipeline(_without_chains(pipe, "k2_chains"))


def test_artifact_of_an_unmoved_k2_height_loads_without_the_record(rng):
    """Where K2's chain is the one it always had (every height outside the
    general design's table, the fixed design's among them), an artifact
    without ``k2_chains`` loads and runs its tables bit for bit."""
    from webgpufft_tpu_torch.core import fused_cols, radix
    assert fused_cols.cols_chain(256) == radix.radix_chain(256)
    plan = T.create_plan({"type": "c2c", "shape": [256, 64], "batch": 2}, device="cpu",
                         cache=T.PlanCache())
    old = _without_chains(T.export_plan(plan), "k2_chains")
    x = torch.from_numpy(rng.standard_normal((2, 256, 64, 2)).astype(np.float32))
    assert torch.equal(T.load_exported_plan(old, device="cpu")(x), plan(x))


@pytest.mark.parametrize("fn,item", [("export_pipeline", "P10"),
                                     ("load_exported_pipeline", "P10"),
                                     ("export_distributed_plan", "P12")])
def test_pipeline_and_distributed_exports_name_their_roadmap_item(fn, item):
    """``item`` is the ROADMAP item that ported each entry point; all three
    are ported, so each raises only on what it cannot take (here an object
    that is neither a function, nor bytes, nor a distributed plan), and no
    message points at the ROADMAP any more."""
    with pytest.raises(T.PlanError) as err:
        getattr(T, fn)(object())
    assert "ROADMAP" not in str(err.value)


# ---------------------------------------------------------------------------
# distributed export in a one-rank gloo world (the 8-rank cases, against the
# JAX artifact, are in test_torch_distributed_plans.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    import datetime
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_distributed_export_header_record(one_rank, rng):
    """The header carries the JAX artefact's ``distributed`` record; the
    loaded artifact serves on ``mesh=`` or on a DTensor's own mesh, equal to
    the live plan, and refuses a call with neither."""
    from torch.distributed.tensor import DTensor, Replicate
    from webgpufft_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"dp": 1, "sp": 1}, device="cpu")
    plan = T.create_distributed_plan({"type": "fftconv", "shape": [64], "batch": 2,
                                      "fftConv": {"boundary": "linear-same",
                                                  "kernelShape": [9]}},
                                     mesh=mesh, batch_axis="dp", seq_axis="sp")
    blob = T.export_distributed_plan(plan)
    meta = json.loads(blob[8:8 + int.from_bytes(blob[:8], "big")])
    assert meta["distributed"] == {"mesh": {"dp": 1, "sp": 1}, "batch_axis": "dp",
                                   "seq_axis": "sp", "nr_devices": 1}
    assert meta["shapes"] == {"input": [2, 64, 2], "kernel": [1, 9, 2]}
    ep = T.load_exported_plan(blob)
    assert ep.plan is None and ep.distributed == meta["distributed"]
    assert ep.route_mode == plan.route.mode == meta["route"]["mode"]
    x = torch.from_numpy(rng.standard_normal((2, 64, 2)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((9, 2)).astype(np.float32))
    live = plan(x, kernel=k).full_tensor()
    y = ep(x, k, mesh=mesh)
    assert torch.equal(y.full_tensor(), live)
    xd = DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
    assert torch.equal(ep(xd, k).full_tensor(), live)
    with pytest.raises(T.PlanError, match="mesh="):
        ep(x, k)


def test_distributed_export_rejects_dp_only_and_other_meshes(one_rank):
    from webgpufft_tpu_torch.parallel import make_mesh
    dp = T.create_distributed_plan({"type": "c2c", "shape": [32], "batch": 8},
                                   mesh=make_mesh({"dp": 1}, device="cpu"), batch_axis="dp")
    with pytest.raises(T.PlanError, match="export_plan"):
        T.export_distributed_plan(dp)
    sp = make_mesh({"sp": 1}, device="cpu")
    blob = T.export_distributed_plan(T.create_distributed_plan(
        {"type": "c2c", "shape": [32], "batch": 2}, mesh=sp, seq_axis="sp"))
    ep = T.load_exported_plan(blob)
    with pytest.raises(T.PlanError, match="mesh axes"):
        ep(torch.zeros(2, 32, 2), mesh=make_mesh({"sq": 1}, device="cpu"))
    # a rebuilt route that differs from the recorded one is refused
    hlen = int.from_bytes(blob[:8], "big")
    meta = json.loads(blob[8:8 + hlen])
    meta["route"]["reasons"].append("digit-split:(4, 8)")
    head = json.dumps(meta).encode()
    other = T.load_exported_plan(len(head).to_bytes(8, "big") + head + blob[8 + hlen:])
    with pytest.raises(T.PlanError, match="routes the plan differently"):
        other(torch.zeros(2, 32, 2), mesh=sp)


def test_distributed_rebuild_under_a_dispatch_mode_caches_real_tables(one_rank, rng):
    """The plan of a distributed artifact is rebuilt at its first call on a
    mesh; a first call under a dispatch mode (here a fake-tensor mode, as in
    an export trace) must still cache real tables and exchange maps."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from webgpufft_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"sp": 1}, device="cpu")
    plan = T.create_distributed_plan({"type": "r2c", "shape": [24, 16], "batch": 2},
                                     mesh=mesh, seq_axis="sp")
    ep = T.load_exported_plan(T.export_distributed_plan(plan))
    with FakeTensorMode():
        ep._plan_on(mesh)
    x = torch.from_numpy(rng.standard_normal((2, 24, 16)).astype(np.float32))
    assert torch.equal(ep(x, mesh=mesh).full_tensor(), plan(x).full_tensor())


def test_mesh_on_single_device_artifact_raises():
    plan = T.create_plan({"type": "c2c", "shape": [8]}, device="cpu", cache=T.PlanCache())
    ep = T.load_exported_plan(T.export_plan(plan), device="cpu")
    assert ep.distributed is None
    with pytest.raises(T.PlanError, match="only meaningful for distributed"):
        ep(torch.zeros(1, 8, 2), mesh=object())


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
    case's ``sosfilt`` pipeline is ``test_sosfilt_pipeline``."""
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


def test_sosfilt_pipeline(rng, monkeypatch):
    """The ``sosfilt`` pipeline of tests/test_aot.py's
    ``test_filter_pipeline_and_validation``, exported and loaded, against the
    eager call and the JAX package's.  ``torch.export`` unrolls a Python
    loop: the sequential recurrence at 500 samples becomes some 5000 ops
    (export and load took a minute on a CPU), so the case exports the
    parallel-prefix route, log2(500) rounds of products, by setting the CPU
    gate as the card's is set."""
    import scipy.signal as ss
    from webgpufft_tpu import filtering as JF
    from webgpufft_tpu_torch import filtering as FL
    monkeypatch.setattr(FL, "IIR_ASSOC_MIN_N", 64)
    sos = ss.butter(4, 0.2, output="sos")

    def f(sig):
        return FL.sosfilt(sos, sig)

    x = torch.from_numpy(rng.standard_normal((3, 500)).astype(np.float32))
    pipe = T.load_exported_pipeline(T.export_pipeline(f, x))
    got = pipe(x)
    assert pipe.shapes == [(3, 500)]
    assert torch.allclose(got, f(x), atol=1e-6)
    assert np.allclose(got.numpy(), np.asarray(JF.sosfilt(sos, x.numpy())), atol=1e-5)


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
