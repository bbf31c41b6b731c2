"""ctypes bridge to the port's native ark reader (``native/ark_decoder.cpp``).

Counterpart of ``tf_kaldi_speaker_tpu/kio/native_decode.py`` with the same
entry points: :func:`read_submat_fast`, :func:`decode_batch_fast`,
:func:`read_batch_codes_fast`, :func:`crc32c_fast`,
:func:`native_available` and :func:`close_all`. The C++ reads the
requested rows of each column of a ``CM `` matrix with ``pread``: one read
a column, or, where the span that holds them all is at most 4 times the
requested bytes (a chunk of a short utterance), one read of that span
(``pread_cm_rows``). It decodes them (or returns the raw codes and
per-column headers), a batch in one call over a small thread pool; ctypes
releases the GIL for the call.

The library is built with ``g++`` at first use into
``build/tfks_torch_native/`` under a name hashed from the source, the flags
and the compiler's target macros (so a tree copied to another host builds
its own), written to a temporary name and renamed into place.
:func:`library_path` and :func:`build` take the source file, so the WFST
decoder's core (``native/wfst_decoder.cpp``, bridged by
``backend/decoder.py``) builds the same way beside it. ``-ffp-contract=off`` keeps ``p0 + s * v`` two roundings, so the
decode is bit-equal to the numpy codec (``kio/ark.py``) on hosts with FMA.

Every entry point returns None or False when the native core cannot serve
the read (a matrix that is not ``CM ``/``FM ``, a range error, or
``TFKS_DISABLE_NATIVE=1``, which forces the numpy path); callers then read
through the numpy codec. A failed build logs the compiler's output once at
WARNING. :data:`counts` counts the native reads that succeeded (by entry
point) and the reads handed back to numpy (``fallback``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger("tfks_torch.native_decode")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "native", "ark_decoder.cpp")
WFST_SOURCE = os.path.join(_PKG_DIR, "native", "wfst_decoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tfks_torch_native")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_MAX_COLS = 4096  # generous bound on feature dim for the scratch buffer

_lib = None
_lib_lock = threading.Lock()
_load_failed = False
_tls = threading.local()
_count_lock = threading.Lock()
counts: "collections.Counter[str]" = collections.Counter()


def _count(kind: str) -> None:
    with _count_lock:
        counts[kind] += 1


def reset_counts() -> None:
    with _count_lock:
        counts.clear()


def library_path(flags=GXX_FLAGS, source=None) -> str:
    """The library of ``source`` (default :data:`SOURCE`): a hash of the
    source, the flags and what ``-march=native`` means to this host's
    ``g++``."""
    source = source or SOURCE
    h = hashlib.sha256(" ".join(flags).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    macros = subprocess.run(["g++", "-march=native", "-E", "-dM", "-x", "c++", os.devnull],
                            check=True, capture_output=True).stdout
    h.update(macros)
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, "libtfks_%s_%s.so" % (name, h.hexdigest()[:16]))


def build(flags=GXX_FLAGS, source=None) -> str:
    """Compile ``source`` (default :data:`SOURCE`) with ``flags`` if its
    library is missing; returns its path. Raises RuntimeError with the
    compiler's output when ``g++`` fails. Other flags than GXX_FLAGS build
    a variant beside it (as ``-DTFKS_CM_SPAN_FACTOR=0`` for the JAX copy's
    column-by-column reads)."""
    source = source or SOURCE
    path = library_path(flags, source)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    proc = subprocess.run(["g++", *flags, source, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ exited %d building %s:\n%s%s"
                           % (proc.returncode, source, proc.stdout, proc.stderr))
    os.replace(tmp, path)
    return path


def load(path: str) -> ctypes.CDLL:
    """The library at ``path`` with its entry points typed."""
    lib = ctypes.CDLL(path)
    i32, i64, f32p = ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    batch = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64), ctypes.POINTER(i32),
             ctypes.POINTER(i32), i32, i32, i32]
    lib.tfks_decode_submat.restype = ctypes.c_int
    lib.tfks_decode_submat.argtypes = [ctypes.c_char_p, i64, i32, i32, f32p, i64]
    lib.tfks_close_all.restype = ctypes.c_int
    lib.tfks_read_batch_codes.restype = ctypes.c_int
    lib.tfks_read_batch_codes.argtypes = batch + [ctypes.POINTER(ctypes.c_uint8), f32p, i32]
    lib.tfks_decode_batch.restype = ctypes.c_int
    lib.tfks_decode_batch.argtypes = batch + [f32p, i32]
    lib.tfks_crc32c.restype = ctypes.c_uint32
    lib.tfks_crc32c.argtypes = [ctypes.c_char_p, i64]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if os.environ.get("TFKS_DISABLE_NATIVE") == "1":
        return None
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is None and not _load_failed:
            try:
                _lib = load(build())
            except Exception as e:  # noqa: BLE001 - logged once, numpy path after
                _load_failed = True
                log.warning("native ark reader unavailable, reading through numpy: %s", e)
    return _lib


def read_submat_fast(filename: str, offset: int, start: int,
                     length: int) -> Optional[np.ndarray]:
    """Decode rows [start, start+length) of the matrix at filename:offset:
    float32 [length, cols], or None (the caller reads through numpy)."""
    lib = _get_lib()
    if lib is None or start is None or length is None or length <= 0:
        _count("fallback")
        return None
    buf = getattr(_tls, "buf", None)
    if buf is None or buf.size < length * _MAX_COLS:
        # max(length, 2048) * 4096 floats: 32 MB per thread at first use
        buf = np.empty(max(length, 2048) * _MAX_COLS, dtype=np.float32)
        _tls.buf = buf
    cols = lib.tfks_decode_submat(
        filename.encode(), int(offset), int(start), int(length),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size)
    if cols <= 0:
        _count("fallback")
        return None
    _count("read_submat")
    return buf[: length * cols].reshape(length, cols).copy()


def batch_args(items):
    """(paths, offsets, starts, lengths) of (filename, offset, start,
    length) items as the batch entry points take them."""
    n = len(items)
    return ((ctypes.c_char_p * n)(*[it[0].encode() for it in items]),
            (ctypes.c_int64 * n)(*[int(it[1]) for it in items]),
            (ctypes.c_int32 * n)(*[int(it[2]) for it in items]),
            (ctypes.c_int32 * n)(*[int(it[3]) for it in items]))


def decode_batch_fast(items, out: np.ndarray, num_threads: int = 4) -> bool:
    """Decode a batch of (filename, offset, start, length) into ``out``
    [B, L, D] float32 in one native call; False (``out`` untouched or
    partly written) when the caller must read row by row."""
    lib = _get_lib()
    if not items:
        return False
    if lib is None:
        _count("fallback")
        return False
    b, stride_rows, cols = out.shape
    assert len(items) <= b
    r = lib.tfks_decode_batch(
        *batch_args(items), len(items), stride_rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    _count("decode_batch" if r == cols else "fallback")
    return r == cols


def read_batch_codes_fast(items, codes_out: np.ndarray, headers_out: np.ndarray,
                          num_threads: int = 4) -> bool:
    """Batch raw-code read: items = [(filename, offset, start, length)],
    codes_out [B, L, D] uint8, headers_out [B, 4, D] float32; False when
    the caller must read row by row."""
    lib = _get_lib()
    if not items:
        return False
    if lib is None:
        _count("fallback")
        return False
    b, stride_rows, cols = codes_out.shape
    assert headers_out.shape == (b, 4, cols)
    r = lib.tfks_read_batch_codes(
        *batch_args(items), len(items), stride_rows, cols,
        codes_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        headers_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    _count("read_batch_codes" if r == cols else "fallback")
    return r == cols


def close_all() -> None:
    lib = _get_lib()
    if lib is not None:
        lib.tfks_close_all()


def native_available() -> bool:
    return _get_lib() is not None


def crc32c_fast(data: bytes) -> Optional[int]:
    """Unmasked CRC32C through the native core, or None when it is
    unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    return int(lib.tfks_crc32c(data, len(data)))
