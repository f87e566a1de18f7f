"""Golden-vector record/replay through the PyTorch port
(``runtime/golden.py``), case by case as ``tests/test_golden.py``, and the
committed corpus ``tests/golden_corpus.json`` (recorded by the JAX package)
replayed through the port on the CPU at the corpus's 1e-4 bar."""

import os

import numpy as np
import pytest

from webgpufft_tpu.runtime import golden as jgolden
from webgpufft_tpu_torch.core.cplx import interleave
from webgpufft_tpu_torch.runtime import golden

CORPUS = os.path.join(os.path.dirname(__file__), "golden_corpus.json")
ARTIFACTS = golden.load_artifacts(CORPUS)


def test_record_and_replay_c2c(rng, tmp_path):
    z = rng.standard_normal((2, 16)) + 1j * rng.standard_normal((2, 16))
    art = golden.record_artifact(
        {"type": "c2c", "shape": [16], "batch": 2, "direction": "forward"},
        interleave(z), name="c2c16", device="cpu")
    res = golden.compare_golden(art, device="cpu")
    assert res["ok"] and res["max_rel_err"] < 1e-6 and res["name"] == "c2c16"
    p = tmp_path / "golden.json"
    golden.save_artifacts(str(p), [art])
    arts = golden.load_artifacts(str(p))
    assert golden.compare_golden(arts[0], device="cpu")["ok"]
    # one schema: the JAX package reads and replays what the port recorded
    assert jgolden.compare_golden(jgolden.load_artifacts(str(p))[0])["ok"]


def test_replay_with_kernel(rng):
    x = rng.standard_normal((1, 8)) + 1j * rng.standard_normal((1, 8))
    k = rng.standard_normal((3,)) + 1j * rng.standard_normal((3,))
    art = golden.record_artifact(
        {"type": "fftconv", "shape": [8],
         "fftConv": {"boundary": "linear-same", "kernelShape": [3]}},
        interleave(x), kernel=interleave(k), name="conv", device="cpu")
    assert golden.compare_golden(art, device="cpu")["ok"]
    assert jgolden.compare_golden(art)["ok"]


def test_replay_detects_mismatch(rng):
    z = rng.standard_normal((1, 8)) + 1j * rng.standard_normal((1, 8))
    art = golden.record_artifact({"type": "c2c", "shape": [8], "batch": 1}, interleave(z),
                                 device="cpu")
    art["expected"]["data_b64"] = golden._enc(np.zeros((1, 8, 2), np.float32))["data_b64"]
    assert not golden.compare_golden(art, device="cpu")["ok"]


def test_schema_validation(tmp_path):
    with pytest.raises(ValueError, match="schema"):
        golden.compare_golden({"schema": "bogus"}, device="cpu")
    with pytest.raises(ValueError, match="version"):
        golden.compare_golden({"schema": golden.GOLDEN_SCHEMA, "version": 7}, device="cpu")
    p = tmp_path / "x.json"
    p.write_text('{"schema": "other", "artifacts": []}')
    with pytest.raises(ValueError, match="golden"):
        golden.load_artifacts(str(p))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "complex64"])
def test_enc_dec_roundtrip(dtype, rng):
    a = (rng.standard_normal((3, 4, 2)) * 10).astype(dtype)
    d = golden._enc(a[:, ::2])                  # a non-contiguous view
    assert d == jgolden._enc(a[:, ::2])
    b = golden._dec(d)
    assert b.dtype == a.dtype and np.array_equal(b, a[:, ::2]) and b.flags.writeable


def test_corpus_is_whole():
    assert len(ARTIFACTS) == 15
    assert sum("kernel" in a for a in ARTIFACTS) == 2


@pytest.mark.parametrize("art", ARTIFACTS, ids=[a.get("name") or str(i)
                                                for i, a in enumerate(ARTIFACTS)])
def test_committed_corpus_replays_through_the_port(art):
    res = golden.compare_golden(art, atol_scale=1e-4, device="cpu")
    assert res["ok"], res
