"""Kaldi binary ark codec for the port: float matrices (FM/DM/CM) and float
vectors (FV/DV), numpy only.

Counterpart of ``tf_kaldi_speaker_tpu/kio/ark.py``, holding the part of it
that the port's extraction path and ``chip_smoke.py`` use: the matrix
readers (compressed matrices included), the compressed-matrix writer, the
raw-code reader of the decode-on-device pipe (``read_codes_scp``), the
float-vector readers and writer, the int vectors of alignments
(``read_vec_int``, ``write_vec_int``, ``read_vec_int_ark`` and the ranged
``_read_subvec_int_binary``), the posteriors (``read_post``,
``write_post``, ``read_post_ark``) and ``ArkScpWriter``.
``tests/test_torch_kio.py`` and ``tests/test_torch_multitask.py`` hold
every function here bit-equal to the JAX package's codec in both
directions.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

import numpy as np

from .rspecifier import open_or_fd, read_key

class UnsupportedDataType(Exception):
    pass


class UnknownVectorHeader(Exception):
    pass


class UnknownMatrixHeader(Exception):
    pass


class BadInputFormat(Exception):
    pass


def _check_dims(*dims) -> None:
    """Reject negative header dimensions. Kaldi dims are non-negative;
    ``fd.read(negative)`` slurps the whole stream and numpy infers ANY
    negative reshape dim (not just -1), so a corrupted negative dimension
    field would otherwise be silently accepted instead of raising."""
    for d in dims:
        if int(d) < 0:
            raise BadInputFormat("negative dimension %d in header" % int(d))


# --------------------------------------------------------------------------
# Compressed matrix ("CM ") — format constants
# --------------------------------------------------------------------------

# GlobalHeader: min_value f32, range f32, num_rows i32, num_cols i32
_GLOBAL_HEADER = np.dtype(
    [("min_value", "<f4"), ("range", "<f4"), ("num_rows", "<i4"), ("num_cols", "<i4")]
)
# Per-column header: 4 uint16 percentiles (p0, p25, p75, p100)
_COL_HEADER = np.dtype("<u2")
# uint16 -> float dequantization step: range / 65535
_U16_SCALE = 1.52590218966964e-05


def _u16_to_float(u16: np.ndarray, gmin: float, grange: float) -> np.ndarray:
    return np.float32(gmin) + np.float32(grange) * np.float32(_U16_SCALE) * u16.astype(
        np.float32
    )


def _decode_cm_data(data_cm: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Dequantize compressed bytes.

    Args:
        data_cm: uint8 array [cols, rows] (Kaldi stores CM column-major).
        p: float32 [cols, 4] dequantized per-column percentiles.
    Returns:
        float32 [rows, cols].

    The piecewise-linear mapping (three segments split at code points 64 and
    192) follows Kaldi's CompressedMatrix::CharToFloat. Vectorized over the
    whole matrix with per-column broadcast instead of a per-column loop.
    """
    v = data_cm.astype(np.float32)  # [cols, rows]
    p0 = p[:, 0:1]
    p25 = p[:, 1:2]
    p75 = p[:, 2:3]
    p100 = p[:, 3:4]
    lo = p0 + (p25 - p0) * (v / 64.0)
    mid = p25 + (p75 - p25) * ((v - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((v - 192.0) / 63.0)
    out = np.where(data_cm <= 64, lo, np.where(data_cm <= 192, mid, hi))
    return out.T


def _read_compressed_parts(fd, fmt: str):
    """Read a whole compressed matrix after its 'CM*' token, undecoded:
    (codes uint8 [cols, rows], Kaldi's column-major order; dequantized
    percentiles float32 [cols, 4])."""
    if fmt != "CM ":
        raise UnknownMatrixHeader("Compressed format %r not supported" % fmt)
    gmin, grange, rows, cols = np.frombuffer(fd.read(16), dtype=_GLOBAL_HEADER, count=1)[0]
    _check_dims(rows, cols)
    headers_u16 = np.frombuffer(fd.read(int(cols) * 8), dtype=_COL_HEADER).reshape(cols, 4)
    p = _u16_to_float(headers_u16, gmin, grange)  # [cols, 4]
    data = np.frombuffer(fd.read(int(cols) * int(rows)), dtype=np.uint8)
    return data.reshape(cols, rows), p


def _read_compressed_mat(fd, fmt: str) -> np.ndarray:
    """Read and dequantize a compressed matrix after its 'CM*' token."""
    return _decode_cm_data(*_read_compressed_parts(fd, fmt))


def _read_compressed_codes(fd, fmt: str):
    """Like _read_compressed_mat but WITHOUT dequantization.

    Returns (codes uint8 [rows, cols], headers float32 [4, cols]) for the
    decode-on-device input path (ops/cm_dequant.py): the host ships
    1 byte/element and the card applies the piecewise mapping.
    """
    data, p = _read_compressed_parts(fd, fmt)
    return np.ascontiguousarray(data.T), np.ascontiguousarray(p.T.astype(np.float32))


def decode_cm_codes(codes: np.ndarray, headers: np.ndarray) -> np.ndarray:
    """Host dequantization of raw codes as returned by the codes readers:
    (codes [T, D] uint8, headers [4, D] float32) -> float32 [T, D]."""
    return _decode_cm_data(np.ascontiguousarray(codes.T), headers.T)


def read_codes_scp(file_or_fd):
    """Iterate (key, codes [T, D] uint8, headers [4, D] float32) over a
    Kaldi scp of COMPRESSED ('CM ') matrices — the host side of the
    decode-on-device extraction pipe (1 byte/element shipped instead of 4).
    Raises UnknownMatrixHeader on uncompressed/CM2/CM3 entries."""
    fd = open_or_fd(file_or_fd)
    fds: dict = {}
    try:
        for line in fd:
            key, rxfile = line.decode().strip().split(" ", 1)
            filename, offset = rxfile.rsplit(":", 1)
            afd = fds.get(filename)
            if afd is None:
                afd = fds[filename] = open(filename, "rb")
            afd.seek(int(offset))
            if afd.read(2) != b"\0B":
                raise BadInputFormat("scp entry %s is not binary Kaldi data" % key)
            fmt = afd.read(3).decode()
            codes, headers = _read_compressed_codes(afd, fmt)
            yield key, codes, headers
    finally:
        for afd in fds.values():
            afd.close()
        if fd is not file_or_fd:
            fd.close()


def compress_matrix(mat: np.ndarray) -> bytes:
    """Encode a float matrix into Kaldi 'CM ' bytes (excluding the \\0B flag).

    Uses the same percentile layout as Kaldi CompressedMatrix (global
    min/range + per-column p0/p25/p75/p100 sampled at ranks 0, n/4, 3n/4,
    n-1), quantized so that decode(encode(x)) round-trips within the format's
    resolution. The reference has no Python CM writer at all.
    """
    mat = np.asarray(mat, dtype=np.float32)
    rows, cols = mat.shape
    gmin = float(mat.min()) if mat.size else 0.0
    gmax = float(mat.max()) if mat.size else 0.0
    grange = gmax - gmin
    if grange <= 0:
        grange = 1e-5  # degenerate (constant) matrix

    def f2u16(v):
        return np.clip(
            np.floor((v - gmin) / (grange * _U16_SCALE) + 0.5), 0, 65535
        ).astype(np.uint16)

    colmaj = mat.T  # [cols, rows]
    srt = np.sort(colmaj, axis=1)
    q0 = srt[:, 0]
    q25 = srt[:, min(rows // 4, rows - 1)]
    q75 = srt[:, min((3 * rows) // 4, rows - 1)]
    q100 = srt[:, rows - 1]

    # Keep percentiles strictly increasing so the decode segments are
    # non-degenerate (Kaldi's ComputeColHeader does the same clamping).
    # Work in int64 to avoid uint16 overflow at the top of the range.
    u0 = np.minimum(f2u16(q0).astype(np.int64), 65532)
    u25 = np.clip(f2u16(q25).astype(np.int64), u0 + 1, 65533)
    u75 = np.clip(f2u16(q75).astype(np.int64), u25 + 1, 65534)
    u100 = np.clip(f2u16(q100).astype(np.int64), u75 + 1, 65535)
    u0, u25, u75, u100 = (u.astype(np.uint16) for u in (u0, u25, u75, u100))

    p = _u16_to_float(np.stack([u0, u25, u75, u100], axis=1), gmin, grange)
    p0, p25, p75, p100 = (p[:, i : i + 1] for i in range(4))

    # Piecewise inverse of _decode_cm_data, with round-to-nearest.
    x = colmaj
    c_lo = np.floor((x - p0) / np.maximum(p25 - p0, 1e-30) * 64.0 + 0.5)
    c_mid = np.floor((x - p25) / np.maximum(p75 - p25, 1e-30) * 128.0 + 64.0 + 0.5)
    c_hi = np.floor((x - p75) / np.maximum(p100 - p75, 1e-30) * 63.0 + 192.0 + 0.5)
    codes = np.where(
        x <= p25, np.clip(c_lo, 0, 64), np.where(x <= p75, np.clip(c_mid, 65, 192), np.clip(c_hi, 193, 255))
    ).astype(np.uint8)

    out = bytearray()
    out += b"CM "
    out += struct.pack("<ffii", gmin, grange, rows, cols)
    out += np.stack([u0, u25, u75, u100], axis=1).astype("<u2").tobytes()
    out += codes.tobytes()
    return bytes(out)


# --------------------------------------------------------------------------
# Matrices
# --------------------------------------------------------------------------

def _read_mat_binary(fd) -> np.ndarray:
    header = fd.read(3).decode()
    if header.startswith("CM"):
        return _read_compressed_mat(fd, header)
    if header == "FM ":
        dtype, size = np.float32, 4
    elif header == "DM ":
        dtype, size = np.float64, 8
    else:
        raise UnknownMatrixHeader("The header contained '%s'" % header)
    s1, rows, s2, cols = np.frombuffer(fd.read(10), dtype="int8,int32,int8,int32", count=1)[0]
    _check_dims(rows, cols)
    buf = fd.read(int(rows) * int(cols) * size)
    return np.frombuffer(buf, dtype=dtype).reshape(rows, cols)


def _read_mat_ascii(fd) -> np.ndarray:
    rows = []
    while True:
        line = fd.readline().decode()
        if len(line) == 0:
            raise BadInputFormat("EOF inside ascii matrix")
        if len(line.strip()) == 0:
            continue
        arr = line.strip().split()
        if arr[-1] != "]":
            rows.append(np.array(arr, dtype="float32"))
        else:
            rows.append(np.array(arr[:-1], dtype="float32"))
            return np.vstack(rows)


def read_mat(file_or_fd) -> np.ndarray:
    """Read a single Kaldi matrix (ascii or binary, incl. compressed)."""
    fd = open_or_fd(file_or_fd)
    try:
        binary = fd.read(2).decode()
        if binary == "\0B":
            return _read_mat_binary(fd)
        if binary == " [":
            return _read_mat_ascii(fd)
        raise BadInputFormat("Unexpected matrix start: %r" % binary)
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_mat(file_or_fd, m: np.ndarray, key: str = "", compress: bool = False) -> None:
    """Write a binary Kaldi matrix (float32/float64, optionally compressed)."""
    fd = open_or_fd(file_or_fd, mode="wb")
    try:
        if key != "":
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\0B")
        if compress:
            fd.write(compress_matrix(m))
            return
        if m.dtype == np.float32:
            fd.write(b"FM ")
        elif m.dtype == np.float64:
            fd.write(b"DM ")
        else:
            raise UnsupportedDataType("'%s', use float32 or float64" % m.dtype)
        fd.write(b"\04" + struct.pack("<I", m.shape[0]))
        fd.write(b"\04" + struct.pack("<I", m.shape[1]))
        fd.write(m.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        key = read_key(fd)
        while key:
            yield key, read_mat(fd)
            key = read_key(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, rxfile = line.decode().split(" ", 1)
            yield key, read_mat(rxfile.strip())
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_rspec(rspecifier) -> Iterator[Tuple[str, np.ndarray]]:
    """Dispatch a Kaldi matrix rspecifier by type: ``scp:``/``scp,o:`` etc.
    route to :func:`read_mat_scp`; ``ark:``, bare paths, and pipes to
    :func:`read_mat_ark` (Kaldi table rspecifier grammar)."""
    if isinstance(rspecifier, str):
        head, sep, rest = rspecifier.partition(":")
        if sep and head.split(",")[0] == "scp":
            return read_mat_scp(rest)
    return read_mat_ark(rspecifier)


# --------------------------------------------------------------------------
# Float vectors (VAD decisions, x-vectors, ...)
# --------------------------------------------------------------------------

def read_vec_flt(file_or_fd) -> np.ndarray:
    fd = open_or_fd(file_or_fd)
    try:
        binary = fd.read(2).decode()
        if binary == "\0B":
            return _read_vec_flt_binary(fd)
        arr = (binary + fd.readline().decode()).strip().split()
        for tok in ("[", "]"):
            if tok in arr:
                arr.remove(tok)
        return np.array(arr, dtype=float)
    finally:
        if fd is not file_or_fd:
            fd.close()


def _read_vec_flt_binary(fd) -> np.ndarray:
    header = fd.read(3).decode()
    if header == "FV ":
        dtype, size = np.float32, 4
    elif header == "DV ":
        dtype, size = np.float64, 8
    else:
        raise UnknownVectorHeader("The header contained '%s'" % header)
    if fd.read(1).decode() != "\4":
        raise BadInputFormat("missing int32 size marker")
    dim = np.frombuffer(fd.read(4), dtype="int32", count=1)[0]
    _check_dims(dim)
    # count= makes a short read raise instead of silently returning a
    # truncated vector (frombuffer without count accepts whatever is there)
    return np.frombuffer(fd.read(int(dim) * size), dtype=dtype, count=int(dim))


def _read_subvec_flt_binary(fd, start: int, length: int) -> np.ndarray:
    header = fd.read(3).decode()
    if header == "FV ":
        dtype, size = np.float32, 4
    elif header == "DV ":
        dtype, size = np.float64, 8
    else:
        raise UnknownVectorHeader("The header contained '%s'" % header)
    if fd.read(1).decode() != "\4":
        raise BadInputFormat("missing int32 size marker")
    dim = np.frombuffer(fd.read(4), dtype="int32", count=1)[0]
    _check_dims(dim)

    if start + length > dim:
        raise ValueError("subvector read out of range")
    if start > 0:
        fd.seek(start * size, 1)
    return np.frombuffer(fd.read(length * size), dtype=dtype, count=int(length))


def write_vec_flt(file_or_fd, v: np.ndarray, key: str = "") -> None:
    fd = open_or_fd(file_or_fd, mode="wb")
    try:
        if key != "":
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\0B")
        if v.dtype == np.float32:
            fd.write(b"FV ")
        elif v.dtype == np.float64:
            fd.write(b"DV ")
        else:
            raise UnsupportedDataType("'%s', use float32 or float64" % v.dtype)
        fd.write(b"\04" + struct.pack("<I", v.shape[0]))
        fd.write(v.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_vec_flt_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        key = read_key(fd)
        while key:
            yield key, read_vec_flt(fd)
            key = read_key(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_vec_flt_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, rxfile = line.decode().split(" ")
            yield key, read_vec_flt(rxfile.strip())
    finally:
        if fd is not file_or_fd:
            fd.close()


# --------------------------------------------------------------------------
# Int vectors (alignments)
# --------------------------------------------------------------------------

def read_vec_int(file_or_fd) -> np.ndarray:
    fd = open_or_fd(file_or_fd)
    try:
        binary = fd.read(2).decode()
        if binary == "\0B":
            if fd.read(1).decode() != "\4":
                raise BadInputFormat("missing int32 size marker")
            dim = np.frombuffer(fd.read(4), dtype="int32", count=1)[0]
            _check_dims(dim)

            # elements are (int8 size, int32 value) pairs
            vec = np.frombuffer(
                fd.read(int(dim) * 5), dtype=[("size", "int8"), ("value", "int32")], count=dim
            )
            return vec["value"].copy()
        arr = (binary + fd.readline().decode()).strip().split()
        for tok in ("[", "]"):
            if tok in arr:
                arr.remove(tok)
        return np.array(arr, dtype=int)
    finally:
        if fd is not file_or_fd:
            fd.close()


def _read_subvec_int_binary(fd, start: int, length: int) -> np.ndarray:
    if fd.read(1).decode() != "\4":
        raise BadInputFormat("missing int32 size marker")
    dim = np.frombuffer(fd.read(4), dtype="int32", count=1)[0]
    _check_dims(dim)

    if start + length > dim:
        raise ValueError("subvector read out of range")
    if start > 0:
        fd.seek(start * 5, 1)
    vec = np.frombuffer(
        fd.read(length * 5), dtype=[("size", "int8"), ("value", "int32")], count=length
    )
    return vec["value"].copy()


def write_vec_int(file_or_fd, v: np.ndarray, key: str = "") -> None:
    fd = open_or_fd(file_or_fd, mode="wb")
    try:
        if key != "":
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\0B")
        fd.write(b"\4" + struct.pack("<i", int(v.shape[0])))
        # interleave the per-element int32 size marker, vectorized
        out = np.empty(len(v), dtype=[("size", "int8"), ("value", "<i4")])
        out["size"] = 4
        out["value"] = np.asarray(v, dtype=np.int32)
        fd.write(out.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_vec_int_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        key = read_key(fd)
        while key:
            yield key, read_vec_int(fd)
            key = read_key(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


# --------------------------------------------------------------------------
# Posteriors (vector<vector<pair<int32, float>>>)
# --------------------------------------------------------------------------

def read_post(file_or_fd):
    """Read a Kaldi Posterior: list (frames) of lists of (int id, float post)."""
    fd = open_or_fd(file_or_fd)
    try:
        binary = fd.read(2).decode()
        if binary != "\0B":
            raise BadInputFormat("only binary posteriors supported")
        if fd.read(1).decode() != "\4":
            raise BadInputFormat("missing int32 size marker")
        num_frames = int(np.frombuffer(fd.read(4), dtype="int32", count=1)[0])
        post = []
        for _ in range(num_frames):
            if fd.read(1).decode() != "\4":
                raise BadInputFormat("missing int32 size marker")
            n = int(np.frombuffer(fd.read(4), dtype="int32", count=1)[0])
            rec = np.frombuffer(
                fd.read(n * 10),
                dtype=[("s1", "int8"), ("id", "int32"), ("s2", "int8"), ("p", "float32")],
                count=n,
            )
            post.append(list(zip(rec["id"].tolist(), rec["p"].tolist())))
        return post
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_post(file_or_fd, post, key: str = "") -> None:
    fd = open_or_fd(file_or_fd, mode="wb")
    try:
        if key != "":
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\0B")
        fd.write(b"\4" + struct.pack("<i", len(post)))
        for frame in post:
            fd.write(b"\4" + struct.pack("<i", len(frame)))
            for ident, p in frame:
                fd.write(b"\4" + struct.pack("<i", int(ident)))
                fd.write(b"\4" + struct.pack("<f", float(p)))
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_post_ark(file_or_fd):
    fd = open_or_fd(file_or_fd)
    try:
        key = read_key(fd)
        while key:
            yield key, read_post(fd)
            key = read_key(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


class ArkScpWriter:
    """Keyed ark writer with Kaldi 'ark,scp:ark,scp' wspecifier support.

    ``wspecifier`` may be "ark:foo.ark", "ark,scp:foo.ark,foo.scp", a bare
    path, or an output pipe "| cmd"; the scp (when requested) records
    ``key ark:offset`` entries pointing at each object's binary flag.
    """

    def __init__(self, wspecifier: str, kind: str = "vec"):
        assert kind in ("vec", "mat")
        self.kind = kind
        self.scp_fd = None
        self.ark_path = None
        spec = wspecifier
        if spec.startswith("ark,scp:"):
            ark_path, scp_path = spec[len("ark,scp:"):].split(",", 1)
            self.ark_path = ark_path
            self.fd = open(ark_path, "wb")
            self.scp_fd = open(scp_path, "w")
        else:
            if spec.startswith("ark:"):
                spec = spec[4:]
                if not (spec.startswith("|") or spec.endswith("|")):
                    self.ark_path = spec
            self.fd = open_or_fd("ark:" + spec if not spec.startswith("|") else spec, "wb")

    def write(self, key: str, value: np.ndarray, compress: bool = False) -> None:
        offset = None
        if self.scp_fd is not None:
            offset = self.fd.tell() + len(key) + 1
        if self.kind == "vec":
            write_vec_flt(self.fd, value, key=key)
        else:
            write_mat(self.fd, value, key=key, compress=compress)
        if self.scp_fd is not None:
            self.scp_fd.write("%s %s:%d\n" % (key, self.ark_path, offset))

    def close(self) -> None:
        self.fd.close()
        if self.scp_fd is not None:
            self.scp_fd.close()
