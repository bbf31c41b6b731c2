"""Persistent-descriptor feature reader over a Kaldi data directory.

Counterpart of ``FeatureReader`` in ``tf_kaldi_speaker_tpu/kio/reader.py``
(reference ``dataset/kaldi_io.py:40-150``): one open fd per ark file,
chunk reads located through ``utt2num_frames``, and raw compressed codes for
the device pool. A ranged read (:meth:`FeatureReader.read_segment` with a
length) goes through the native reader (``kio/native_decode.py``), which
reads and decodes only the requested rows, as the JAX reader does; where
that cannot serve it, the port's numpy codec (``kio/ark.py``) decodes the
whole matrix and slices it, the same values (the decode is elementwise).
``tests/test_torch_pool.py`` and ``tests/test_torch_native_decode.py`` hold
it equal to the JAX reader.

:class:`FeatureReaderV2` (the multitask path's joint feature, VAD and
alignment reader) is a copy of the JAX package's, its feature rows read
the same way; ``tests/test_torch_multitask.py`` holds its segments equal
to the JAX reader's.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional, Tuple

import numpy as np

from . import ark
from .native_decode import read_submat_fast


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
        if length is not None:
            filename, offset = segment.split(" ")[1].rsplit(":", 1)
            fast = read_submat_fast(filename, int(offset), start, length)
            if fast is not None:
                return fast, start
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


class FeatureReaderV2:
    """Joint feature + VAD + alignment segment reader (multitask training).

    Features are expanded by ``left_context``/``right_context`` frames via
    edge tiling; VAD and alignment are returned for the un-expanded range
    (parity with reference kaldi_io.py:152-338). The feature rows that the
    expanded range covers are read through the native reader, or, where it
    cannot serve them, decoded whole by the numpy codec and sliced.
    """

    def __init__(self, data_dir: str, ali_dir: str, left_context: int, right_context: int):
        self.fd: Dict[str, object] = {}
        self.vad_fd: Dict[str, object] = {}
        self.ali_fd: Dict[str, object] = {}
        self.left_context = left_context
        self.right_context = right_context
        self.data_dir = data_dir
        self.ali_dir = ali_dir

        self.utt2num_frames = _load_utt2int(os.path.join(data_dir, "utt2num_frames"))
        self.utt2feats_offset = _load_scp_offsets(os.path.join(data_dir, "feats.scp"))
        self.utt2vad_offset = _load_scp_offsets(os.path.join(data_dir, "vad.scp"))
        self.utt2ali_offset = _load_scp_offsets(os.path.join(ali_dir, "pdf.scp"))
        self.dim = self.get_dim()

    def get_dim(self) -> int:
        utt = next(iter(self.utt2feats_offset))
        mat, _, _, _ = self.read_segment(utt)
        return mat.shape[1]

    def close(self) -> None:
        for d in (self.fd, self.vad_fd, self.ali_fd):
            for fd in d.values():
                fd.close()
            d.clear()

    def _fd_at(self, cache: Dict[str, object], filename: str, offset: int):
        fd = cache.get(filename)
        if fd is None:
            fd = open(filename, "rb")
            cache[filename] = fd
        fd.seek(offset)
        return fd

    def _rows(self, filename: str, offset: int, start: int, length: int) -> np.ndarray:
        """Rows [start, start + length) of the matrix at filename:offset."""
        fast = read_submat_fast(filename, offset, start, length)
        if fast is not None:
            return fast
        fd = self._fd_at(self.fd, filename, offset)
        if fd.read(2).decode() != "\0B":
            raise IOError("Cannot read features from %s" % filename)
        mat = ark._read_mat_binary(fd)
        if mat.shape[0] < start + length:
            raise ValueError("Not enough frames for submatrix read")
        return mat[start : start + length]

    def read_segment(
        self,
        utt: str,
        length: Optional[int] = None,
        shuffle: bool = False,
        start: Optional[int] = None,
        rng: Optional[random.Random] = None,
    ):
        num_features = self.utt2num_frames[utt]
        if length is not None:
            if start is None:
                length = min(length, num_features)
                if shuffle:
                    r = rng if rng is not None else random
                    start = r.randint(0, num_features - 1)
                    if start + length > num_features:
                        start = num_features - length
                else:
                    start = 0
            else:
                if start + length > num_features:
                    length = num_features - start
        else:
            start = 0
            length = num_features
        real_start = start - self.left_context
        real_length = length + self.left_context + self.right_context

        feats_filename, feats_offset = self.utt2feats_offset[utt]
        tmp_start = max(real_start, 0)
        tmp_end = min(real_start + real_length, num_features)
        mat = self._rows(feats_filename, feats_offset, tmp_start, tmp_end - tmp_start)
        if real_start < 0:
            mat = np.concatenate([np.tile(mat[0, :], [-real_start, 1]), mat], axis=0)
        if real_start + real_length > num_features:
            pad = real_start + real_length - num_features
            mat = np.concatenate([mat, np.tile(mat[-1, :], [pad, 1])], axis=0)
        assert mat.shape[0] == real_length

        vad_filename, vad_offset = self.utt2vad_offset[utt]
        vfd = self._fd_at(self.vad_fd, vad_filename, vad_offset)
        if vfd.read(2).decode() != "\0B":
            raise IOError("Cannot read vad from %s" % vad_filename)
        vad = ark._read_subvec_flt_binary(vfd, start, length)

        ali_filename, ali_offset = self.utt2ali_offset[utt]
        afd = self._fd_at(self.ali_fd, ali_filename, ali_offset)
        if afd.read(2).decode() != "\0B":
            raise IOError("Cannot read ali from %s" % ali_filename)
        ali = ark._read_subvec_int_binary(afd, start, length)

        assert mat.shape[0] == vad.shape[0] + self.left_context + self.right_context
        assert mat.shape[0] == ali.shape[0] + self.left_context + self.right_context
        return mat, vad, ali, start


def _load_utt2int(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    out = {}
    with open(path) as f:
        for line in f:
            utt, v = line.strip().split(" ")
            out[utt] = int(v)
    return out


def _load_scp_offsets(path: str) -> Dict[str, Tuple[str, int]]:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    out = {}
    with open(path) as f:
        for line in f:
            utt, info = line.strip().split(" ")
            filename, offset = info.rsplit(":", 1)
            out[utt] = (filename, int(offset))
    return out
