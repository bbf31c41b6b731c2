"""Build and load the port's CUDA kernels.

The sources in ``tf_kaldi_speaker_tpu_torch/csrc`` have a plain C interface.
At first use ``nvcc`` compiles each source for ``sm_90a``, all at once in
parallel processes, and links the objects into one shared library under
``build/tfks_torch_kernels/`` (named by a hash of the sources, the headers
and the flags, so an edited file is rebuilt); the library is loaded with
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
SOURCES = ("cm_dequant.cu", "stats_pooling.cu", "stats_pooling_bwd.cu", "batchnorm.cu")
HEADERS = ("vec4.cuh",)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tfks_torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR, _INT, _INT_PTR = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_LL, _FLT = ctypes.c_longlong, ctypes.c_float
# name -> argtypes; pointers, then B, L, D, then the stream. The tests'
# tfks_stats_pooling_splits takes a bf16 flag first and a frame-split
# count before the stream; the backward takes its plan (blocks, items,
# frames per item) before the stream, and its geometry query a bf16 flag
# and where to write its 4 numbers. The BatchNorm kernels take the x and
# parameter dtype flags, the layout and vector width, their pointers, then
# outer, inner, C, splits, rows a split and the tile, then their float
# scalars; a data group's finishes take the totals and the row count
# first, then C.
_ENTRY_POINTS = {
    "tfks_cm_dequantize": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    "tfks_stats_pooling_f32": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    "tfks_stats_pooling_bf16": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    "tfks_stats_pooling_splits": [_INT, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR],
    "tfks_stats_pooling_bwd_f32": [_PTR] * 5 + [_INT] * 6 + [_PTR],
    "tfks_stats_pooling_bwd_bf16": [_PTR] * 5 + [_INT] * 6 + [_PTR],
    "tfks_stats_pooling_bwd_geometry": [_INT, _INT_PTR],
    "tfks_bn_train_stats": [_INT] * 3 + [_PTR] * 2 + [_INT] + [_PTR] * 4 + [_LL] + [_INT] * 5
    + [_FLT] * 4 + [_PTR],
    "tfks_bn_train_normalize": [_INT] * 3 + [_PTR] * 4 + [_INT, _LL] + [_INT] * 5 + [_PTR],
    "tfks_bn_train_grad_stats": [_INT] * 3 + [_PTR] * 6 + [_INT, _PTR, _LL] + [_INT] * 5
    + [_FLT, _PTR],
    "tfks_bn_train_grad": [_INT] * 3 + [_PTR] * 5 + [_LL] + [_INT] * 5 + [_PTR],
    "tfks_bn_train_sums": [_INT] * 4 + [_PTR] * 6 + [_LL] + [_INT] * 5 + [_PTR],
    "tfks_bn_train_finish": [_PTR, _PTR, _INT, _PTR, _INT] + [_PTR] * 3 + [_FLT] * 3 + [_PTR],
    "tfks_bn_train_grad_finish": [_PTR] * 3 + [_INT] + [_PTR] * 4 + [_INT, _PTR],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
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
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "libtfks_kernels_%s.so" % h.hexdigest()[:16])


def _run(procs) -> str:
    """Wait for every (cmd, Popen); returns their logs, raises on a failure."""
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append("exit %d: %s\n%s" % (proc.returncode, " ".join(cmd), out))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return "".join(logs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build() -> str:
    """Compile the library if it is missing; returns nvcc's log ('' when
    the library was already built). Raises with the log when nvcc fails."""
    path = library_path()
    if os.path.exists(path):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    nvcc = _nvcc()
    objs = ["%s.%s.o" % (tmp, os.path.splitext(s)[0]) for s in SOURCES]
    try:
        log = _run([_start([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, s), "-o", o])
                    for s, o in zip(SOURCES, objs)])
        log += _run([_start([nvcc, "-shared", "-o", tmp, *objs])])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, path)
    return log


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


def count_launch(wrapper, shape, dtype_name: str) -> None:
    """Add one launch to a kernel wrapper's ``launches`` and to its
    ``shapes[(shape, dtype_name)]``, under one lock: server threads launch
    at once, and ``+= 1`` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1
        wrapper.shapes[shape, dtype_name] += 1
