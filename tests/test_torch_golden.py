"""Golden-vector record/replay through the PyTorch port
(``runtime/golden.py``), case by case as ``tests/test_golden.py``, and the
committed corpus ``tests/golden_corpus.json`` (recorded by the JAX package)
replayed through the port on the CPU at the corpus's 1e-4 bar."""

import json
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


DSP_CORPUS = os.path.join(os.path.dirname(__file__), "golden_dsp.json")


def _dsp_current():
    """tests/test_golden.py's ``test_dsp_golden_corpus_replays`` computed
    through the port (numpy inputs on the CPU device), the same draws in the
    same order."""
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import fftapi as TF
    from webgpufft_tpu_torch.fftpack import convolve as CV
    FL, D, L, WIN, SP, LA = T.filtering, T.iirdesign, T.ltisys, T.windows, T.splines, T.linalg
    blob = json.load(open(DSP_CORPUS))
    rng = np.random.default_rng(blob["seed"])
    x64 = rng.standard_normal(64)
    c16 = rng.standard_normal(16)
    c16[0] += 8.0
    r16 = rng.standard_normal(16)
    b16 = rng.standard_normal(16)
    with TF.default_device("cpu"):
        om24 = CV.init_convolution_kernel(24, lambda k: 1.0 / (1.0 + k), d=1)
        A = T.ShortTimeFFT(WIN.gaussian(8, 2), hop=3, fs=10)
        num, den, _ = L.cont2discrete(D.butter(3, 5, analog=True), 0.01, method="bilinear")
        r, p, k = L.residue([1.0, 0.5], [1.0, -1.5, 0.75, -0.125])
        o2 = D.cheb2ord([0.1, 0.6], [0.2, 0.5], 1, 40)
        current = {
            "remez_51_lowpass": FL.remez(51, [0, 0.2, 0.3, 1.0], [1, 0], fs=2.0),
            "firwin_31": FL.firwin(31, 0.3),
            "butter6_sos": D.butter(6, 0.2, output="sos"),
            "ellip5_sos": D.ellip(5, 1, 40, 0.3, output="sos"),
            "cheb2ord_bandstop": np.concatenate([[o2[0]], o2[1]]),
            "gammatone_iir": np.concatenate(D.gammatone(440, "iir", fs=16000)),
            "kaiser_16_86": WIN.kaiser(16, 8.6),
            "chebwin_17_80": WIN.chebwin(17, 80),
            "dpss_32_3_2": WIN.dpss(32, 3, 2),
            "taylor_24": WIN.taylor(24, 5, 40),
            "c2d_bilinear_num": np.atleast_1d(np.squeeze(num)),
            "c2d_bilinear_den": den,
            "residue_triple_r": np.stack([r.real, r.imag]),
            "sosfiltfilt_butter": FL.sosfiltfilt(D.butter(4, 0.25, output="sos"),
                                                 x64.astype(np.float32)),
            "cspline1d": SP.cspline1d(x64.astype(np.float32)),
            "symiirorder2": SP.symiirorder2(x64, 0.5, 0.3),
            "envelope": TF.envelope(x64.astype(np.float32)),
            "shorttime_stft": A.stft(x64.astype(np.float32)),
            "dual_win_gauss8_hop3": A.dual_win,
            "solve_toeplitz_16": LA.solve_toeplitz((c16, r16), b16),
            "fftpack_convolve_24": CV.convolve(x64[:24], om24, swap_real_imag=True),
        }
    return {name: TF._to_numpy(v) for name, v in current.items()}


DSP_ARTIFACTS = json.load(open(DSP_CORPUS))["artifacts"]


@pytest.fixture(scope="module")
def dsp_current():
    return _dsp_current()


@pytest.mark.parametrize("art", DSP_ARTIFACTS, ids=[a["name"] for a in DSP_ARTIFACTS])
def test_dsp_golden_corpus_replays_through_the_port(art, dsp_current):
    """tests/golden_dsp.json (the JAX package's recorded design tables and
    device outputs) through the port, each at the artifact's own bar."""
    import base64
    want = np.frombuffer(base64.b64decode(art["expected"]["data_b64"]),
                         dtype=art["expected"]["dtype"]).reshape(art["expected"]["shape"])
    got = np.asarray(dsp_current[art["name"]], np.float64)
    assert got.shape == tuple(want.shape), art["name"]
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-12)
    assert err < art["tol"], (art["name"], err)


def test_dsp_corpus_is_whole():
    assert json.load(open(DSP_CORPUS))["schema"] == "webgpufft-tpu-golden-dsp"
    assert set(_dsp_current()) == {a["name"] for a in DSP_ARTIFACTS}
