"""Multi-GPU layer on ``torch.distributed``: batch sharding, the distributed
single-transform FFT, the plan-level ``create_distributed_plan`` surface and
the distributed NUFFT (port of ``webgpufft_tpu/parallel/``).  The caller
initialises the process group; ``make_mesh`` builds the ``DeviceMesh``."""

from .plans import DistributedPlan, create_distributed_plan
from .nufft import (
    build_distributed_nufft_type1,
    build_distributed_nufft_type2,
    build_distributed_nufft_type3,
)
from .sharded import (
    build_distributed_c2r_1d,
    build_distributed_fft_1d,
    build_distributed_fft_axis0,
    build_distributed_fftconv_1d,
    build_distributed_fftconv_nd,
    build_distributed_r2c_1d,
    build_distributed_stft,
    build_distributed_istft,
    build_distributed_welch,
    build_distributed_csd,
    choose_distributed_split,
    make_mesh,
    shard_batch,
)

__all__ = [
    "DistributedPlan", "create_distributed_plan",
    "build_distributed_nufft_type1", "build_distributed_nufft_type2",
    "build_distributed_nufft_type3",
    "build_distributed_c2r_1d", "build_distributed_fft_1d",
    "build_distributed_fft_axis0", "build_distributed_fftconv_1d",
    "build_distributed_fftconv_nd", "build_distributed_r2c_1d",
    "build_distributed_stft", "build_distributed_istft",
    "build_distributed_welch", "build_distributed_csd",
    "choose_distributed_split", "make_mesh", "shard_batch",
]
