"""Native TensorBoard event-file writer (no TensorFlow dependency).

A copy of ``tf_kaldi_speaker_tpu/utils/tb_events.py``, which is
framework-free but cannot be imported without running the JAX package's
``__init__``; ``tests/test_torch_summary.py`` holds the two byte-equal.

The reference writes TB scalar summaries everywhere (trainer.py:363-376,
424-433); SURVEY §5 names TensorBoard as the observability surface. This
module emits real ``events.out.tfevents.*`` files TensorBoard can load:

- TFRecord framing: <uint64 length> <masked crc32c(length)> <payload>
  <masked crc32c(payload)>, crc32c = Castagnoli polynomial, mask =
  rot15 + 0xa282ead8 (tensorflow/core/lib/hash/crc32c.h).
- Payload: an ``Event`` proto — field 1 wall_time (double), field 2 step
  (int64), field 3 file_version (first record, "brain.Event:2"), field 5
  Summary{ repeated Value{ tag=1 (string), simple_value=2 (float) } } —
  hand-encoded, so no protobuf runtime is needed either.

Verified byte-compatible with TensorFlow's own
``tf.compat.v1.train.summary_iterator``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

# ----------------------------------------------------------------------
# crc32c (Castagnoli, table-driven) + TFRecord masking
# ----------------------------------------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------------------
# Minimal proto encoding
# ----------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint((num << 3) | 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _packed_doubles(num: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _field_bytes(num, payload)


def _encode_histogram(values) -> bytes:
    """HistogramProto from raw values: TB-style exponential bucket grid.

    Fields: 1 min, 2 max, 3 num, 4 sum, 5 sum_squares, 6 bucket_limit
    (packed double), 7 bucket (packed double).
    """
    import numpy as np

    v = np.asarray(values, np.float64).reshape(-1)
    if v.size == 0:
        v = np.zeros(1)
    # exponential grid (tensorboard's default generator, both signs)
    limits = [1e-12]
    while limits[-1] < 1e20:
        limits.append(limits[-1] * 1.1)
    grid = [-x for x in reversed(limits)] + [0.0] + limits
    counts, _ = np.histogram(v, bins=[-np.inf] + grid + [np.inf])
    # merge the two open-ended end bins into their neighbors' limits
    bucket_limit = grid + [np.finfo(np.float64).max]
    bucket = counts[:-1].astype(np.float64)
    bucket[-1] += counts[-1]
    # drop empty tail/head runs to keep records small
    nz = np.nonzero(bucket)[0]
    if nz.size:
        lo, hi = nz[0], nz[-1] + 1
        bucket_limit = bucket_limit[lo:hi]
        bucket = bucket[lo:hi]
    msg = _field_double(1, float(v.min()))
    msg += _field_double(2, float(v.max()))
    msg += _field_double(3, float(v.size))
    msg += _field_double(4, float(v.sum()))
    msg += _field_double(5, float(np.square(v).sum()))
    msg += _packed_doubles(6, bucket_limit)
    msg += _packed_doubles(7, bucket)
    return msg


def _encode_event(wall_time: float, step: int = 0,
                  file_version: str = "", scalars: Dict[str, float] = None,
                  histograms: Dict[str, "object"] = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step:
        msg += _field_varint(2, step)
    if file_version:
        msg += _field_bytes(3, file_version.encode())
    if scalars or histograms:
        summary = b""
        for tag, value in (scalars or {}).items():
            val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
            summary += _field_bytes(1, val)
        for tag, values in (histograms or {}).items():
            # Summary.Value.histo is field 5 (4 is image)
            val = _field_bytes(1, tag.encode()) + _field_bytes(
                5, _encode_histogram(values)
            )
            summary += _field_bytes(1, val)
        msg += _field_bytes(5, summary)
    return msg


# ----------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------

class TBEventWriter:
    """Append scalar summaries to an events.out.tfevents.* file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        # pid suffix: two writers in the same second must not interleave
        # TFRecord frames in one file (TB accepts extra dotted suffixes)
        name = "events.out.tfevents.%d.%s.%d" % (
            int(time.time()), socket.gethostname(), os.getpid()
        )
        self.path = os.path.join(logdir, name)
        self._fp = open(self.path, "ab")
        self._record(_encode_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fp.write(header)
        self._fp.write(struct.pack("<I", _masked_crc(header)))
        self._fp.write(payload)
        self._fp.write(struct.pack("<I", _masked_crc(payload)))
        self._fp.flush()

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        clean = {}
        for k, v in values.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        if clean:
            self._record(_encode_event(time.time(), step=int(step), scalars=clean))

    def histograms(self, step: int, tensors: Dict[str, "object"]) -> None:
        """Per-tensor value histograms (reference trainer.py:431-432 writes
        one per trainable variable; misc/utils.py:333-346 per activation)."""
        if tensors:
            self._record(
                _encode_event(time.time(), step=int(step), histograms=tensors)
            )

    def close(self) -> None:
        self._fp.close()


def read_tfevents(path: str):
    """Decode scalars back out of a tfevents file (for tests/tools):
    returns {tag: [(step, value)]}. Validates both record CRCs."""
    out: Dict[str, list] = {}
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("bad header crc in %s" % path)
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError("bad payload crc in %s" % path)
            step, scalars = 0, {}
            pos = 0
            while pos < len(payload):
                tag_byte, pos = _read_varint(payload, pos)
                field, wire = tag_byte >> 3, tag_byte & 7
                if wire == 0:
                    val, pos = _read_varint(payload, pos)
                    if field == 2:
                        step = val
                elif wire == 1:
                    pos += 8
                elif wire == 5:
                    pos += 4
                elif wire == 2:
                    ln, pos = _read_varint(payload, pos)
                    blob = payload[pos : pos + ln]
                    pos += ln
                    if field == 5:
                        scalars.update(_decode_summary(blob))
                else:
                    raise ValueError("bad wire type %d" % wire)
            for tag, value in scalars.items():
                out.setdefault(tag, []).append((step, value))
    return out


def _read_varint(buf: bytes, pos: int):
    shift, val = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _decode_summary(buf: bytes) -> Dict[str, float]:
    out = {}
    pos = 0
    while pos < len(buf):
        tag_byte, pos = _read_varint(buf, pos)
        field, wire = tag_byte >> 3, tag_byte & 7
        assert wire == 2 and field == 1, (field, wire)
        ln, pos = _read_varint(buf, pos)
        value_msg = buf[pos : pos + ln]
        pos += ln
        vpos, tag, val = 0, None, None
        while vpos < len(value_msg):
            vt, vpos = _read_varint(value_msg, vpos)
            vfield, vwire = vt >> 3, vt & 7
            if vwire == 2:
                vln, vpos = _read_varint(value_msg, vpos)
                blob = value_msg[vpos : vpos + vln]
                vpos += vln
                if vfield == 1:
                    tag = blob.decode()
            elif vwire == 5:
                if vfield == 2:
                    (val,) = struct.unpack("<f", value_msg[vpos : vpos + 4])
                vpos += 4
            elif vwire == 1:
                vpos += 8
            else:
                _, vpos = _read_varint(value_msg, vpos)
        if tag is not None and val is not None:
            out[tag] = val
    return out
