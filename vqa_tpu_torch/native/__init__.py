"""The port's native question encoder (SURVEY.md C4; 'native where it pays'),
a copy of ``vqa_tpu/native/`` (the port imports nothing of the JAX package).

A C++ tokenizer and encoder (``tokenizer.cc``) behind a C ABI, loaded with
ctypes. It is built with g++ at first use, under a file lock, into
``vqa_tpu_torch/_build/`` (git-ignored), written to a temporary file and
renamed into place so a concurrent process never loads a half-written
library, and rebuilt when ``tokenizer.cc`` is newer than the library, as
``ops/_build.py`` builds the CUDA kernels. The Python tokenizer is the
semantics oracle either way (tests/test_torch_native.py).

Where the build fails, the original quietly encodes in Python; here the
compiler's message is kept (``build_error()``), a ``RuntimeWarning`` says so
once, and ``available()`` is false. ``datasets/processed.py::encode_split``
then encodes in Python, with the same bytes, and counts which encoder
encoded each split (``processed.ENCODERS``), so a run meant to go native
can be caught when it did not.

Usage:
    enc = NativeEncoder(wid_to_word)           # full table, <pad>/<unk> first
    ids, lengths = enc.encode_batch(questions, maxlength=26, pad="right")
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "tokenizer.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libvqa_tokenizer.so")
COMPILER = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _stale() -> bool:
    return not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC)


def _compile() -> None:
    """Build the library into place unless another process just did."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _stale():
                return
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
            os.close(fd)
            try:
                proc = subprocess.run([COMPILER, *CXX_FLAGS, _SRC, "-o", tmp],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{COMPILER} failed ({proc.returncode}):\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, _SO)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        if _stale():
            _compile()
        lib = ctypes.CDLL(_SO)
    except (OSError, RuntimeError) as e:  # no compiler, a failed build, an unloadable library
        _build_error = str(e)
        warnings.warn("the native question encoder did not build; questions are encoded in "
                      f"Python (the same bytes, slower): {_build_error}", RuntimeWarning,
                      stacklevel=3)
        return None
    lib.vt_build.restype = ctypes.c_void_p
    lib.vt_build.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.vt_free.argtypes = [ctypes.c_void_p]
    lib.vt_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library built and loaded (built on first call)."""
    return _build() is not None


def build_error() -> Optional[str]:
    """Why the library did not build or load (the compiler's message), or
    None."""
    return _build_error


class NativeEncoder:
    """Vocab-bound tokenizer+encoder over the C++ core."""

    def __init__(self, wid_to_word: Sequence[str]):
        lib = _build()
        if lib is None:
            raise RuntimeError(f"native tokenizer unavailable: {_build_error}")
        self._lib = lib
        blob = "\n".join(wid_to_word).encode("utf-8")
        self._handle = ctypes.c_void_p(lib.vt_build(blob, len(blob)))

    def encode_batch(
        self, questions: Sequence[str], maxlength: int, pad: str = "right"
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(questions)
        blob = "\n".join(q.replace("\n", " ") for q in questions).encode("utf-8")
        out = np.empty((n, maxlength), dtype=np.int32)
        lengths = np.empty(n, dtype=np.int32)
        self._lib.vt_encode_batch(
            self._handle,
            blob,
            len(blob),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            maxlength,
            1 if pad == "right" else 0,
        )
        return out, lengths

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.vt_free(handle)
