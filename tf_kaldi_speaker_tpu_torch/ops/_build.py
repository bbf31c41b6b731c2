"""Build and load the port's CUDA kernels.

The sources in ``tf_kaldi_speaker_tpu_torch/csrc`` have a plain C interface.
At first use they are compiled by ``nvcc`` for ``sm_90a`` into one shared
library under ``build/tfks_torch_kernels/`` (named by a hash of the sources
and flags, so an edited source is rebuilt), and the library is loaded with
``ctypes``. Tensors are passed as ``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``; every entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("cm_dequant.cu", "stats_pooling.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tfks_torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# name -> argtypes; pointers, then B, L, D, then the stream. The tests'
# tfks_stats_pooling_splits takes a bf16 flag first and a frame-split
# count before the stream.
_ENTRY_POINTS = {
    "tfks_cm_dequantize": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    "tfks_stats_pooling_f32": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    "tfks_stats_pooling_bf16": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    "tfks_stats_pooling_splits": [_INT, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled from "
        "tf_kaldi_speaker_tpu_torch/csrc with the CUDA toolkit "
        "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "libtfks_kernels_%s.so" % h.hexdigest()[:16])


def build() -> str:
    """Compile the library if it is missing; returns nvcc's log ('' when
    the library was already built). Raises with the log when nvcc fails."""
    path = library_path()
    if os.path.exists(path):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [
        os.path.join(CSRC_DIR, s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d): %s\n%s%s" % (
            proc.returncode, " ".join(cmd), proc.stdout, proc.stderr))
    os.replace(tmp, path)
    return proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built at the first call in the process."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(library_path())
            for name, argtypes in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tfks_error_string.argtypes = [ctypes.c_int]
            lib.tfks_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = load().tfks_error_string(err).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, err, msg))
