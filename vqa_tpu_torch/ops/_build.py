"""Build and load the port's CUDA kernels.

``vqa_tpu_torch/csrc/*.cu`` are compiled by nvcc for Hopper (``sm_90a``),
one nvcc process per source, all started together, and linked into ONE
shared library with a plain C interface, loaded with ctypes. The library
is built at the first kernel call, under a file lock, into
``vqa_tpu_torch/_build/`` (git-ignored), written to a temporary file and
renamed into place so a concurrent process never loads a half-written
library, and rebuilt whenever a source is newer than it.

Nothing CUDA-specific is imported at module level: the CPU tests import
every module of the port on machines with no nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
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
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
]

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_int64
# every entry point returns a cudaError_t as int; pointers and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int and cut)
_SIGNATURES = {
    "vqa_gather_rows": [_PTR, _PTR, _PTR, _I64, _I64, _PTR],
    "vqa_gather_rows_dequant": [_PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _INT, _PTR],
    "vqa_lstm_seq": [*[_PTR] * 9, _I64, *[_INT] * 5, _PTR],
    "vqa_lstm_seq_geometry": [_INT, _INT, _INT, _PTR],
    "vqa_lstm_seq_f32": [*[_PTR] * 8, *[_INT] * 4, _PTR],
    "vqa_lstm_seq_f32_geometry": [_INT, _INT, _PTR],
    "vqa_glimpse_head": [*[_PTR] * 6, *[_INT] * 10, _PTR],
    "vqa_glimpse_attend": [*[_PTR] * 3, *[_INT] * 8, _PTR],
    "vqa_glimpse_head_f32": [*[_PTR] * 6, *[_INT] * 6, _PTR],
    "vqa_glimpse_attend_f32": [*[_PTR] * 3, *[_INT] * 4, _PTR],
    "vqa_glimpse_split": [*[_PTR] * 9, *[_INT] * 8, _PTR],
    "vqa_glimpse_tc": [*[_PTR] * 10, *[_INT] * 12, _PTR],
    "vqa_glimpse_tc_geometry": [*[_INT] * 12, _PTR],
    "vqa_smem_optin": [_PTR],
    "vqa_mfb_pool": [_PTR, _PTR, _I64, _INT, _INT, _PTR],
    "vqa_mfb_pool_f32": [_PTR, _PTR, _I64, _INT, _INT, _PTR],
    "vqa_mfb_pool_global": [_PTR, _PTR, _I64, _INT, _INT, _INT, _PTR],
    "vqa_relation_attend": [_PTR, _PTR, _PTR, *[_INT] * 6, _PTR],
    "vqa_relation_attend_f32": [_PTR, _PTR, _PTR, *[_INT] * 5, _PTR],
    "vqa_relation_attend_split": [*[_PTR] * 5, *[_INT] * 5, _PTR],
    "vqa_relation_geometry": [*[_INT] * 8, _PTR],
    "vqa_relation_attend_tc": [*[_PTR] * 5, *[_INT] * 5, _PTR],
    "vqa_relation_tc_geometry": [*[_INT] * 5, _PTR],
}

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    built = os.path.getmtime(_SO)
    headers = glob.glob(os.path.join(_CSRC, "*.cuh"))
    return any(os.path.getmtime(src) > built for src in _sources() + headers)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return found


def _compile_and_link(tmp: str) -> str:
    """One nvcc per source, all running at once, then one link into
    ``tmp/lib.so``; returns the compilers' output."""
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", os.path.join(tmp, "lib.so"),
                           *(obj for _, obj, _ in jobs)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return "".join(log) + proc.stdout + proc.stderr


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
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                log = _compile_and_link(tmp)
                os.replace(os.path.join(tmp, "lib.so"), _SO)
            return log
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


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """The shared memory a block may opt into on this card (bytes), the
    limit the kernels' plans size themselves to."""
    import torch

    out = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        check(library().vqa_smem_optin(ctypes.byref(out)), "smem_optin")
    return out.value


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, the stream
    every kernel launches on (without building a ``torch.cuda.Stream``,
    which costs microseconds a call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().vqa_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")


def require(name: str, t, device, dtypes, shape: tuple) -> None:
    """Validate a kernel operand before its pointer crosses into C:
    ``dtypes`` is the dtype it must have, or the collection of those the
    kernel has an entry for."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    allowed = tuple(dtypes) if isinstance(dtypes, (tuple, list, set, frozenset)) else (dtypes,)
    if t.dtype not in allowed:
        names = " or ".join(str(d) for d in allowed)
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {names}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
