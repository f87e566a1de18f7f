"""Build the package's CUDA kernels on first use and bind them with ctypes.

Two shared libraries with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes), each built at its own first use:

- ``core``: every ``csrc/*.cu``, the kernels the plans launch (K1, K2);
- ``probes``: every ``csrc/probes/*.cu``, the measurement kernels of
  ``webgpufft_tpu_torch.probes``.  No plan path loads it, so importing or
  running a plan never pays for it.

Both include ``csrc/*.cuh``.  One ``nvcc -c`` per source, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -I csrc -c -o _build/<name>.o csrc/<name>.cu
    nvcc -shared -o _build/libwgfft_<hash>.so _build/*.o

A library lands in ``_build/`` beside this file, named by a hash of its
sources, the headers and the flags, so a later process in the same checkout
reuses it and an edited source builds anew.  Nothing is prebuilt or
downloaded.  Only the first CUDA launch calls :func:`library`; importing
this module touches neither ``nvcc`` nor the GPU.  :func:`build_all` builds
both libraries at once, every compile in parallel.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_INTS = ctypes.POINTER(ctypes.c_int)
# library -> entry point -> argument types (every entry point returns an int:
# the cudaError_t of its launch, or for ``wgfft_fused_cols_ring`` the grid)
_SIGNATURES = {
    "core": {
        # x, y, cw, cp, lines, n, radices, count, adjoint, stream
        "wgfft_fused_lines": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                              _INTS, ctypes.c_int, ctypes.c_int, _P),
        # x, y, cw, cp, pre, h, cols, radices, count, adjoint, stream
        "wgfft_fused_cols": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong, _INTS, ctypes.c_int, ctypes.c_int, _P),
        # h, cols, radices, count, tile -> the ring's grid, 0 for the direct
        # design, -1 (no launch); the tile's columns into tile
        "wgfft_fused_cols_ring": (ctypes.c_int, ctypes.c_longlong, _INTS, ctypes.c_int, _INTS),
    },
    "probes": {
        # x, y, count, scale, use_scale, mode, stages, stage_bytes, ctas, stream
        "wgfft_stream_copy": (_P, _P, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
        # x, y, cw, cp, lines, n, radices, count, stop, stream
        "wgfft_lines_stages": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                               _INTS, ctypes.c_int, ctypes.c_int, _P),
        # x, y, cw, cp, lines, n, radices, count, stream
        "wgfft_lines_planes": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                               _INTS, ctypes.c_int, _P),
        # x, y, pre, h, lanes, tile_floats, width, threads, stream
        "probe_tile_copy": (_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
        # x, y, cw, cp, pre, h, cols, radices, count, adjoint, design, stream
        "wgfft_cols_variant": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_longlong, _INTS, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, _P),
    },
}
_SOURCE_DIRS = {"core": CSRC, "probes": CSRC / "probes"}

_libs: Dict[str, ctypes.CDLL] = {}


def set_build_dir(directory: Path) -> None:
    """Build into, and load from, ``directory`` from now on (it is created
    at the first build).  A library already loaded stays loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(directory)


def find_nvcc() -> str:
    """Path of nvcc: PATH first, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    for cand in (shutil.which("nvcc"),
                 os.path.join(home, "bin", "nvcc") if home else None,
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: webgpufft_tpu_torch compiles its CUDA kernels "
        "(csrc/*.cu) with nvcc on first use; put nvcc on PATH or set CUDA_HOME")


def sources(which: str = "core"):
    return sorted(_SOURCE_DIRS[which].glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def library_path(which: str = "core") -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(which) + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    tag = "" if which == "core" else f"{which}_"
    return BUILD_DIR / f"libwgfft_{tag}{h.hexdigest()[:16]}.so"


def build(which: str = "core") -> Path:
    """Compile the sources unless the library for them already exists."""
    out = library_path(which)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sources(which):
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
    tmp = BUILD_DIR / f"{stem}.tmp.so"
    try:
        for cmd, log, rc in logs:
            _require_ok(cmd, log, rc)
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _require_ok(cmd, proc.stdout, proc.returncode)
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    return out


def build_all() -> Dict[str, Path]:
    """Build both libraries side by side (a thread each, so every ``nvcc``
    of both runs at once) and return their paths."""
    with ThreadPoolExecutor(max_workers=len(_SOURCE_DIRS)) as pool:
        return dict(zip(_SOURCE_DIRS, pool.map(build, _SOURCE_DIRS)))


def _require_ok(cmd, log: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed with exit code {rc}: {' '.join(cmd)}\n{log}")


def library(which: str = "core") -> ctypes.CDLL:
    """The loaded kernel library ``which``, built on the first call."""
    if which not in _libs:
        lib = ctypes.CDLL(str(build(which)))
        for name, argtypes in _SIGNATURES[which].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.wgfft_error_string.argtypes = (ctypes.c_int,)
        lib.wgfft_error_string.restype = ctypes.c_char_p
        _libs[which] = lib
    return _libs[which]


@lru_cache(maxsize=None)
def chain_arg(radices: Tuple[int, ...]):
    """The radix chain as the (int*, count) pair the entry points take."""
    return (ctypes.c_int * len(radices))(*radices), len(radices)


def on_device(device):
    """Context in which ``device`` is the current CUDA device: a launch goes
    to the current device's stream.  Nothing to switch, and nothing to pay,
    when it already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def table_ptrs(x, tables, shapes, kernel: str):
    """``data_ptr()`` of each table named in ``shapes`` (name -> shape),
    after checking that it is a contiguous float32 tensor of that shape on
    ``x``'s device: the kernels read the raw pointers."""
    ptrs = []
    for name, shape in shapes.items():
        t = tables.get(name)
        if t is None:
            raise ValueError(f"{kernel}: missing table {name!r}")
        if (t.device != x.device or t.dtype != x.dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"{kernel}: table {name!r} must be a contiguous {x.dtype} "
                f"tensor of shape {tuple(shape)} on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def check(rc: int, kernel: str, which: str = "core") -> None:
    """Raise when a C entry point of library ``which`` reports a CUDA error."""
    if rc != 0:
        msg = library(which).wgfft_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} ({msg})")
