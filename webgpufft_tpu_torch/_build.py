"""Build the package's CUDA kernels on first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface (no PyTorch headers, so the build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/libwgfft_<hash>.so csrc/*.cu

The library lands in ``_build/`` beside this file, named by a hash of the
sources and the flags, so a later process in the same checkout reuses it and
an edited source builds anew.  Nothing is prebuilt or downloaded.  Only the
first CUDA launch calls :func:`library`; importing this module touches
neither ``nvcc`` nor the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, y, f2re, f2im, twre, twim, f1re, f1im, lines, n1, n2, stream
    "wgfft_fused_lines": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, _P),
    # x, y, w1re, w1im, tre, tim, w2re, w2im, pre, h1, h2, cols, stream
    "wgfft_fused_cols": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P),
}

_lib: Optional[ctypes.CDLL] = None


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


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwgfft_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.wgfft_error_string.argtypes = (ctypes.c_int,)
        lib.wgfft_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        msg = library().wgfft_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} ({msg})")
