"""Build and load the port's CUDA kernels.

``vqa_tpu_torch/csrc/*.cu`` are compiled by nvcc for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, loaded with ctypes. The
library is built at the first kernel call, under a file lock, into
``vqa_tpu_torch/_build/`` (git-ignored), written to a temporary file and
renamed into place so a concurrent process never loads a half-written
library, and rebuilt whenever a source is newer than it.

Nothing CUDA-specific is imported at module level: the CPU tests import
every module of the port on machines with no nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libvqa_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
]

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_int64
# every entry point returns a cudaError_t as int; pointers and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int and cut)
_SIGNATURES = {
    "vqa_gather_rows": [_PTR, _PTR, _PTR, _I64, _I64, _PTR],
    "vqa_lstm_seq": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    "vqa_glimpse_head": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR],
}

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    built = os.path.getmtime(_SO)
    return any(os.path.getmtime(src) > built for src in _sources())


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return found


def build() -> str:
    """Compile the kernels if the library is missing or stale; return the
    compiler's output (empty when nothing was rebuilt)."""
    if not _stale():
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _stale():
                return ""
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, _SO)
                return proc.stdout + proc.stderr
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(_SO)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vqa_error_string.argtypes = [ctypes.c_int]
        lib.vqa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().vqa_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")


def require(name: str, t, device, dtype, shape: tuple) -> None:
    """Validate a kernel operand before its pointer crosses into C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
