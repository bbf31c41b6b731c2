"""TensorFlow TensorBundle checkpoints without TensorFlow: the reader and
the writer.

Counterpart of ``tf_kaldi_speaker_tpu/kio/tf_bundle.py``, whole. Reads TF1
``model-XXXX.index`` / ``model-XXXX.data-#####-of-#####`` checkpoint pairs
(the format the reference's tf.train.Saver writes), so the reference's
published pretrained models import into the port (``train/tf_import.py``),
and writes them back (``train/tf_export.py``):

- the index file is a LevelDB-format SSTable (prefix-compressed blocks,
  BlockHandle-indexed, 48-byte footer with magic 0xdb4775248b80fb57);
- values are BundleEntryProto protobufs (dtype, shape, shard, offset, size),
  parsed with a minimal varint/wire-format decoder;
- data shards hold raw little-endian tensor bytes at (offset, size).

The writer emits one uncompressed data block with masked-CRC32C block
trailers and per-tensor checksums, so a real TensorFlow Saver restores its
output. The CRC32C goes through the port's native core
(``native_decode.crc32c_fast``) where it is built, else the table loop here.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy (the subset Saver checkpoints use)
_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    9: np.int64,
    10: np.bool_,
    19: np.float16,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


# ----------------------------------------------------------------------
# varint / protobuf wire helpers
# ----------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError("Unsupported wire type %d" % wire)
        yield field, wire, val


def _parse_shape(buf: bytes) -> List[int]:
    dims = []
    for field, _, val in _iter_fields(buf):
        if field == 2:  # Dim
            size = 0
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    # zigzag is NOT used; Dim.size is int64 varint
                    size = v2
            dims.append(size)
    return dims


def _parse_bundle_entry(buf: bytes):
    dtype, shape, shard, offset, size = np.float32, [], 0, 0, 0
    for field, _, val in _iter_fields(buf):
        if field == 1:
            dtype = _DTYPES.get(val, None)
            if dtype is None:
                raise ValueError("Unsupported TF dtype enum %d" % val)
        elif field == 2:
            shape = _parse_shape(val)
        elif field == 3:
            shard = val
        elif field == 4:
            offset = val
        elif field == 5:
            size = val
        elif field == 7:
            # BundleEntryProto.slices: the variable was saved partitioned.
            # Treating slice entries as full tensors silently mis-reads the
            # checkpoint, so reject outright.
            raise ValueError(
                "Partitioned TF variables (BundleEntryProto.slices) are not "
                "supported; re-save the checkpoint unpartitioned."
            )
    return dtype, shape, shard, offset, size


def _parse_bundle_header(buf: bytes) -> int:
    num_shards = 1
    for field, _, val in _iter_fields(buf):
        if field == 1:
            num_shards = val
    return num_shards


# ----------------------------------------------------------------------
# SSTable reader
# ----------------------------------------------------------------------

def _read_block(data: bytes, offset: int, size: int) -> bytes:
    block = data[offset : offset + size]
    compression = data[offset + size]
    if compression != 0:
        raise ValueError(
            "Compressed SSTable blocks (type %d) not supported" % compression
        )
    return block


def _iter_block_entries(block: bytes):
    """Yield (key, value) from a prefix-compressed table block."""
    (num_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield bytes(key), bytes(value)


def _parse_block_handle(buf: bytes) -> Tuple[int, int, int]:
    offset, pos = _read_varint(buf, 0)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def read_index_file(path: str) -> Dict[bytes, bytes]:
    """All (key, value) pairs of a TensorBundle .index SSTable."""
    with open(path, "rb") as f:
        data = f.read()
    footer = data[-48:]
    (magic,) = struct.unpack_from("<Q", footer, 40)
    if magic != _TABLE_MAGIC:
        raise ValueError("%s is not an SSTable (bad magic)" % path)
    _, _, pos = _parse_block_handle(footer)          # metaindex handle
    idx_off, idx_size, _ = _parse_block_handle(footer[pos:])
    index_block = _read_block(data, idx_off, idx_size)
    out: Dict[bytes, bytes] = {}
    for _key, handle in _iter_block_entries(index_block):
        b_off, b_size, _ = _parse_block_handle(handle)
        for k, v in _iter_block_entries(_read_block(data, b_off, b_size)):
            out[k] = v
    return out


def read_tf_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """Load all tensors of a TF checkpoint given its prefix (no extension)."""
    entries = read_index_file(prefix + ".index")
    header = entries.pop(b"", None)
    num_shards = _parse_bundle_header(header) if header else 1
    shards = {}
    out: Dict[str, np.ndarray] = {}
    for key, value in entries.items():
        if key.startswith(b"\x00"):
            # Slice-data entries (escape1-prefixed keys) mean the variable
            # was saved partitioned — same condition as BundleEntryProto
            # field 7 on the header entry; reject rather than mis-read.
            raise ValueError(
                "Partitioned TF variables (slice-encoded bundle key %r) are "
                "not supported; re-save the checkpoint unpartitioned." % key
            )
        name = key.decode()
        dtype, shape, shard, offset, size = _parse_bundle_entry(value)
        path = "%s.data-%05d-of-%05d" % (prefix, shard, num_shards)
        if path not in shards:
            with open(path, "rb") as f:
                shards[path] = f.read()
        buf = shards[path][offset : offset + size]
        arr = np.frombuffer(buf, dtype=dtype)
        out[name] = arr.reshape(shape) if shape else arr.reshape(())
    return out


# ----------------------------------------------------------------------
# Minimal writer (no prefix compression, one block per entry group, no
# compression; real masked-CRC32C block trailers and per-tensor checksums
# so actual TensorFlow Savers restore the output)
# ----------------------------------------------------------------------

_CRC32C_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)
del _n, _c


def _crc32c(data: bytes) -> int:
    # Hot for real-model export (every tensor + every SSTable block is
    # checksummed): prefer the native core (hardware CRC / table in C++),
    # fall back to the pure-Python table loop.
    from .native_decode import crc32c_fast

    crc = crc32c_fast(data)
    if crc is not None:
        return crc
    crc = 0xFFFFFFFF
    tbl = _CRC32C_TABLE
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    """LevelDB/TF CRC masking: rotate right 15 and add a constant."""
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _encode_entry(key: bytes, value: bytes, prev_key: bytes) -> bytes:
    # no prefix compression (shared=0) — readers must handle it
    return (
        _write_varint(0)
        + _write_varint(len(key))
        + _write_varint(len(value))
        + key
        + value
    )


def _build_block(items: List[Tuple[bytes, bytes]]) -> bytes:
    body = bytearray()
    prev = b""
    for k, v in items:
        body += _encode_entry(k, v, prev)
        prev = k
    body += struct.pack("<I", 0)       # one restart at offset 0
    body += struct.pack("<I", 1)       # num_restarts
    return bytes(body)


def write_tf_checkpoint(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a TensorBundle-compatible checkpoint (for tests)."""
    names = sorted(tensors)
    data = bytearray()
    entries: List[Tuple[bytes, bytes]] = []

    header = _write_varint((1 << 3) | 0) + _write_varint(1)  # num_shards=1
    entries.append((b"", bytes(header)))
    for name in names:
        arr = np.ascontiguousarray(tensors[name])
        if np.ndim(tensors[name]) == 0:
            arr = arr.reshape(())  # ascontiguousarray promotes 0-d to 1-d
        offset = len(data)
        raw = arr.tobytes()  # serialize once: data shard + checksum share it
        data += raw
        shape_buf = bytearray()
        for d in arr.shape:
            dim_msg = _write_varint((1 << 3) | 0) + _write_varint(int(d))
            shape_buf += _write_varint((2 << 3) | 2) + _write_varint(len(dim_msg)) + dim_msg
        entry = bytearray()
        entry += _write_varint((1 << 3) | 0) + _write_varint(_DTYPE_CODES[arr.dtype])
        entry += _write_varint((2 << 3) | 2) + _write_varint(len(shape_buf)) + bytes(shape_buf)
        entry += _write_varint((4 << 3) | 0) + _write_varint(offset)
        entry += _write_varint((5 << 3) | 0) + _write_varint(arr.nbytes)
        # field 6 (crc32c, fixed32): TF's BundleReader validates tensor
        # bytes against this masked checksum on every read
        entry += _write_varint((6 << 3) | 5) + struct.pack(
            "<I", _masked_crc32c(raw))
        entries.append((name.encode(), bytes(entry)))

    with open("%s.data-00000-of-00001" % prefix, "wb") as f:
        f.write(bytes(data))

    def with_trailer(block: bytes) -> bytes:
        # 1-byte compression type (0 = none) + masked CRC32C of block+type
        return block + b"\x00" + struct.pack("<I", _masked_crc32c(block + b"\x00"))

    # one data block with everything, plus index + footer
    block = _build_block(entries)
    file_buf = bytearray()
    file_buf += with_trailer(block)
    data_handle = _write_varint(0) + _write_varint(len(block))

    index_block = _build_block([(b"\xff", bytes(data_handle))])
    index_off = len(file_buf)
    file_buf += with_trailer(index_block)
    index_handle = _write_varint(index_off) + _write_varint(len(index_block))

    meta_block = _build_block([])
    meta_off = len(file_buf)
    file_buf += with_trailer(meta_block)
    meta_handle = _write_varint(meta_off) + _write_varint(len(meta_block))

    footer = bytearray()
    footer += meta_handle + index_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(file_buf) + bytes(footer))
