"""Persistent-descriptor feature reader over a Kaldi data directory.

Counterpart of ``FeatureReader`` in ``tf_kaldi_speaker_tpu/kio/reader.py``
(reference ``dataset/kaldi_io.py:40-150``): one open fd per ark file,
chunk reads located through ``utt2num_frames``, and raw compressed codes for
the device pool. It decodes through the port's own codec (``kio/ark.py``):
a chunk read decodes the whole matrix and slices it, which gives the same
values as the JAX package's partial reads (the decode is elementwise).
``tests/test_torch_pool.py`` holds it equal to the JAX reader.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional, Tuple

import numpy as np

from . import ark


class FeatureReader:
    """Random-access reader for the features of one Kaldi data directory."""

    def __init__(self, data: str):
        self.fd: Dict[str, object] = {}
        self.data = data
        self.utt2num_frames: Dict[str, int] = {}
        path = os.path.join(data, "utt2num_frames")
        if not os.path.exists(path):
            raise FileNotFoundError("Expect utt2num_frames in %s" % data)
        with open(path) as f:
            for line in f:
                utt, length = line.strip().split(" ")
                self.utt2num_frames[utt] = int(length)
        self.dim = self.get_dim()

    def get_dim(self) -> int:
        with open(os.path.join(self.data, "feats.scp")) as f:
            mat, _ = self.read(f.readline().strip())
        return mat.shape[1]

    def close(self) -> None:
        for fd in self.fd.values():
            fd.close()
        self.fd.clear()

    def _open(self, segment: str):
        """The fd of ``segment``'s ark, positioned after its binary flag."""
        _, rxfile = segment.split(" ")
        filename, offset = rxfile.rsplit(":", 1)
        fd = self.fd.get(filename)
        if fd is None:
            fd = open(filename, "rb")
            self.fd[filename] = fd
        fd.seek(int(offset))
        if fd.read(2).decode() != "\0B":
            raise IOError("Cannot read features from %s" % segment)
        return fd

    def _chunk(self, segment, length, shuffle, start, rng) -> Tuple[Optional[int], Optional[int]]:
        if length is not None and start is None:
            n = self.utt2num_frames[segment.split(" ")[0]]
            length = min(length, n)
            r = rng if rng is not None else random
            start = r.randint(0, n - length) if shuffle else 0
        return length, start

    def read(
        self,
        segment: str,
        length: Optional[int] = None,
        shuffle: bool = False,
        start: Optional[int] = None,
        rng: Optional[random.Random] = None,
    ) -> Tuple[np.ndarray, Optional[int]]:
        """Read a full matrix, then (optionally) slice a chunk from it.

        ``segment`` is "utt filename:offset" as stored in feats.scp."""
        mat = ark._read_mat_binary(self._open(segment))
        if length is not None:
            if start is None:
                n = mat.shape[0]
                length = min(length, n)
                r = rng if rng is not None else random
                start = r.randint(0, n - length) if shuffle else 0
            mat = mat[start : start + length, :]
        return mat, start

    def read_segment(
        self,
        segment: str,
        length: Optional[int] = None,
        shuffle: bool = False,
        start: Optional[int] = None,
        rng: Optional[random.Random] = None,
    ) -> Tuple[np.ndarray, Optional[int]]:
        """Read the requested row range (the whole matrix for length None)."""
        length, start = self._chunk(segment, length, shuffle, start, rng)
        mat = ark._read_mat_binary(self._open(segment))
        if length is None:
            return mat, start
        if mat.shape[0] < start + length:
            raise ValueError("Not enough frames for submatrix read")
        return mat[start : start + length], start

    def read_segment_codes(
        self,
        segment: str,
        length: Optional[int] = None,
        shuffle: bool = False,
        start: Optional[int] = None,
        rng: Optional[random.Random] = None,
    ):
        """Raw compressed codes for decode-on-device: (codes [L, D] uint8,
        headers [4, D] float32, start). Requires a compressed ('CM ') ark."""
        length, start = self._chunk(segment, length, shuffle, start, rng)
        fd = self._open(segment)
        codes, headers = ark._read_compressed_codes(fd, fd.read(3).decode())
        first = 0 if start is None else int(start)
        count = codes.shape[0] - first if length is None else int(length)
        if codes.shape[0] < first + count:
            raise ValueError("Not enough frames for codes read")
        return np.ascontiguousarray(codes[first : first + count]), headers, start
