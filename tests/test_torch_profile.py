"""The PyTorch port's roofline accounting and timing helpers
(``runtime/profile.py``) on the CPU: the models against the JAX package's,
the timers' contracts with ``perf_counter``.  Device times are measured on a
GPU only (``tests/test_torch_cuda.py``)."""

import math
import time

import pytest
import torch

from webgpufft_tpu.runtime import profile as jprofile
from webgpufft_tpu_torch.runtime import profile


@pytest.mark.parametrize("n_total,batch", [(1024, 4096), (256 ** 3, 1), (1, 1), (360, 7)])
def test_models_match_the_jax_package(n_total, batch):
    assert profile.fft_flops(n_total, batch) == jprofile.fft_flops(n_total, batch)
    assert profile.fft_min_bytes(n_total, batch) == jprofile.fft_min_bytes(n_total, batch)
    assert profile.fft_min_bytes(n_total, batch, 4) == jprofile.fft_min_bytes(n_total, batch, 4)


def test_tables_hold_the_h100_and_no_tpu():
    assert profile.HBM_GBPS == {"NVIDIA H100 80GB HBM3": 3350.0}
    assert profile.FP32_GFLOPS == {"NVIDIA H100 80GB HBM3": 67000.0}
    assert not any("tpu" in k.lower() or k == "cpu" for k in profile.HBM_GBPS)


@pytest.mark.parametrize("fn", [profile.device_hbm_gbps, profile.device_fp32_gflops])
def test_unknown_device_raises(fn, monkeypatch):
    with pytest.raises(ValueError, match="no data-sheet"):
        fn("cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other Card")
    with pytest.raises(ValueError, match="Some Other Card"):
        fn("cuda:0")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert fn("cuda:0") > 0


def test_bound_ms(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    ms, by = profile.bound_ms(16 * 1024 * 4096, 5 * 1024 * 10 * 4096, "cuda:0")
    assert by == "bytes" and ms == pytest.approx(16 * 1024 * 4096 / 3.35e12 * 1e3)
    ms, by = profile.bound_ms(8, 67e9, "cuda:0")
    assert by == "operations" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("xs,want", [([3.0], 3.0), ([1, 9, 2], 2), ([4, 1, 3, 2], 2.5)])
def test_median(xs, want):
    assert profile.median(xs) == want


def _sleeper(ms):
    def fn(*_):
        time.sleep(ms * 1e-3)
    return fn


def test_time_calls_on_the_cpu():
    calls = []
    ts = profile.time_calls(lambda a: calls.append(a) or time.sleep(2e-3), 7, runs=4,
                            warmup=2, device="cpu")
    assert len(ts) == 4 and len(calls) == 6 and all(1.5 < t < 50 for t in ts)


def test_time_queued_on_the_cpu_is_per_call():
    ts = profile.time_queued(_sleeper(2), runs=3, queued=4, warmup=1, device="cpu")
    assert len(ts) == 3 and all(1.5 < t < 50 for t in ts)


def test_time_chained_feeds_the_output_back():
    seen = []

    def fn(v):
        seen.append(float(v[0]))
        return v + 1

    dt = profile.time_chained(fn, torch.zeros(2), 3, warmup=2)
    assert seen == [0.0, 1.0, 0.0, 1.0, 2.0] and 0 < dt < 1


def test_tunnel_protocols_are_not_carried():
    for name in ("unrolled_chain_time", "slope_chain_time", "hbm_stream_time"):
        assert hasattr(jprofile, name) and not hasattr(profile, name)


def test_result_records_keep_their_fields():
    r = profile.BenchResult(1.0, 2.0, 3.0, 4.0, 5)
    assert (r.avg_ms, r.gflops, r.eff_gbps, r.pct_roofline, r.iters) == (1.0, 2.0, 3.0, 4.0, 5)
    assert set(jprofile.BenchResult.__dataclass_fields__) == set(
        profile.BenchResult.__dataclass_fields__)
    assert math.isclose(profile.RobustBenchResult(1, 2, 3, 4, 0.5, 3).vs_copy_ceiling, 0.5)
