"""Kaldi CompressedMatrix decoding in numpy, for the reference.

A frozen copy of the format's arithmetic (Kaldi ``CompressedMatrix``:
``Uint16ToFloat`` and ``CharToFloat``), written apart from the program:
each column's four uint16 percentiles become floats as ``min + range *
u16 / 65535``, and a code c maps piecewise-linearly onto [p0, p25] for
c <= 64, [p25, p75] for c <= 192 and [p75, p100] above, in float32.
"""

from __future__ import annotations

import numpy as np

U16_SCALE = np.float32(1.52590218966964e-05)


def percentiles(headers_u16: np.ndarray, gmin: float, grange: float) -> np.ndarray:
    """[..., dim, 4] uint16 -> [..., dim, 4] float32."""
    return np.float32(gmin) + np.float32(grange) * U16_SCALE * headers_u16.astype(np.float32)


def decode(codes: np.ndarray, p: np.ndarray) -> np.ndarray:
    """codes [..., T, dim] uint8 with percentiles p [..., dim, 4] float32
    -> [..., T, dim] float32."""
    c = codes.astype(np.float32)
    p = p[..., None, :, :]
    p0, p25, p75, p100 = (p[..., k] for k in range(4))
    lo = p0 + (p25 - p0) * (c / np.float32(64.0))
    mid = p25 + (p75 - p25) * ((c - np.float32(64.0)) / np.float32(128.0))
    hi = p75 + (p100 - p75) * ((c - np.float32(192.0)) / np.float32(63.0))
    return np.where(c <= 64.0, lo, np.where(c <= 192.0, mid, hi)).astype(np.float32)
