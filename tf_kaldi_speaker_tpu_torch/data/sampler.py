"""Batch samplers: random N-speaker x M-segment chunks and one-pass
sequential, over one feature stream or a main and named auxiliary streams.

A copy of ``tf_kaldi_speaker_tpu/data/sampler.py`` (reference
dataset/data_loader.py:229-573, 580-826). Per-batch lengths are drawn from a
small bucket set spanning [min_len, max_len]; batches are exactly
bucket-length (no padding), and sampling is deterministic given the seed.
The draws are the JAX package's, in its order (``tests/test_torch_pool.py``,
``tests/test_torch_native_decode.py``, ``tests/test_torch_trainer_mi.py``).
``RandomChunkSampler`` reads a batch in one threaded native call
(``kio/native_decode.py``) and row by row through the numpy codec when the
native reader cannot serve it; the other samplers read row by row through
``FeatureReader.read_segment``, whose ranged reads are native too.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..kio.native_decode import decode_batch_fast, read_batch_codes_fast
from ..kio.reader import FeatureReader
from .speaker_index import get_aux_speaker_info, get_speaker_info


class DataOutOfRange(Exception):
    """Raised by sequential samplers at end of data (parity with reference)."""


def bucket_lengths(min_len: int, max_len: int, num_buckets: int = 8) -> List[int]:
    """Static chunk lengths spanning [min_len, max_len], multiples of 8."""
    if max_len <= min_len:
        return [int(min_len)]
    pts = np.linspace(min_len, max_len, num_buckets)
    out = sorted({int(np.clip(int(round(p / 8.0)) * 8, min_len, max_len)) for p in pts})
    return out


class RandomChunkSampler:
    """Infinite random batches of num_speakers x num_segments chunks.

    Yields (features [B, L, D] float32, labels [B] int32), or with
    ``raw_codes`` (codes [B, L, D] uint8, headers [B, 4, D] float32, labels);
    L varies over the bucket set, one draw per ``group`` batches (stacked on
    a leading axis when group > 1). Speaker resampling when no utterance
    exceeds the batch length follows reference data_loader.py:277-288."""

    def __init__(
        self,
        data_dir: str,
        spklist: str,
        num_speakers: int,
        num_segments: int = 1,
        min_len: int = 200,
        max_len: int = 400,
        shuffle: bool = True,
        seed: int = 0,
        num_buckets: int = 8,
        spk2features: Optional[Dict[int, List[str]]] = None,
        num_total_speakers: Optional[int] = None,
        raw_codes: bool = False,
        length_seed: Optional[int] = None,
        group: int = 1,
    ):
        self.data_dir = data_dir
        if spk2features is None:
            spk2features, _, spk2index = get_speaker_info(data_dir, spklist)
            num_total_speakers = len(spk2index)
        self.spk2features = spk2features
        self.num_total_speakers = num_total_speakers
        self.num_speakers = num_speakers
        self.num_segments = num_segments
        self.buckets = bucket_lengths(min_len, max_len, num_buckets)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        self.length_rng = random.Random(seed if length_seed is None else length_seed)
        self.raw_codes = raw_codes
        self.group = int(group)
        self.reader: Optional[FeatureReader] = None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        if self.reader is None:
            self.reader = FeatureReader(self.data_dir)
        reader = self.reader
        speakers = list(self.spk2features.keys())
        if len(speakers) < self.num_speakers:
            speakers = speakers * (self.num_speakers // len(speakers) + 1)
        while True:
            batch_length = self.length_rng.choice(self.buckets)
            if self.group == 1:
                yield self._one_batch(reader, speakers, batch_length)
            else:
                parts = [
                    self._one_batch(reader, speakers, batch_length)
                    for _ in range(self.group)
                ]
                yield tuple(
                    np.stack([p[i] for p in parts]) for i in range(len(parts[0]))
                )

    def _one_batch(self, reader, speakers, batch_length):
        rng = self.rng
        B = self.num_speakers * self.num_segments
        batch_speakers = rng.sample(speakers, self.num_speakers)
        labels = np.zeros((B,), dtype=np.int32)
        plan = []  # (row, segment) read work list for the batch
        for i in range(self.num_speakers):
            spk = batch_speakers[i]
            feature_list: List[str] = []
            while not feature_list:
                feature_list = [
                    feat
                    for feat in self.spk2features[spk]
                    if reader.utt2num_frames[feat.split(" ")[0]] > batch_length
                ]
                if not feature_list:
                    spk = rng.choice(list(set(speakers) - set(batch_speakers)))
                    batch_speakers[i] = spk
            labels[i * self.num_segments : (i + 1) * self.num_segments] = spk
            if len(feature_list) < self.num_segments:
                feature_list = feature_list * (
                    self.num_segments // len(feature_list) + 1
                )
            for j, feat in enumerate(rng.sample(feature_list, self.num_segments)):
                plan.append((i * self.num_segments + j, feat))
        if self.raw_codes:
            codes = np.zeros((B, batch_length, reader.dim), dtype=np.uint8)
            headers = np.zeros((B, 4, reader.dim), dtype=np.float32)
            self._read_codes_plan(reader, rng, plan, codes, headers, batch_length)
            return codes, headers, labels
        features = np.zeros((B, batch_length, reader.dim), dtype=np.float32)
        self._decode_plan(reader, rng, plan, features, batch_length)
        return features, labels

    def _plan_items(self, reader, rng, plan, batch_length):
        """The chunk starts, drawn for the whole plan before any read:
        (row, filename, offset, start, length, segment) per row."""
        items = []
        for row, seg in plan:
            utt, rxfile = seg.split(" ")
            filename, offset = rxfile.rsplit(":", 1)
            n = reader.utt2num_frames[utt]
            start = rng.randint(0, n - batch_length) if self.shuffle else 0
            items.append((row, filename, int(offset), start, batch_length, seg))
        return items

    def _decode_plan(self, reader, rng, plan, features, batch_length):
        """Decode the batch: one threaded native call, else row by row."""
        items = self._plan_items(reader, rng, plan, batch_length)
        scratch = np.empty((len(items), batch_length, reader.dim), np.float32)
        if decode_batch_fast([(f, o, s, n) for _, f, o, s, n, _ in items], scratch):
            for k, (row, *_rest) in enumerate(items):
                features[row] = scratch[k]
            return
        for row, _f, _o, start, length, seg in items:
            features[row], _ = reader.read_segment(seg, length, start=start)

    def _read_codes_plan(self, reader, rng, plan, codes, headers, batch_length):
        """Raw codes of the batch: one threaded native call, else row by row."""
        items = self._plan_items(reader, rng, plan, batch_length)
        c_scratch = np.empty((len(items), batch_length, reader.dim), np.uint8)
        h_scratch = np.empty((len(items), 4, reader.dim), np.float32)
        if read_batch_codes_fast([(f, o, s, n) for _, f, o, s, n, _ in items],
                                 c_scratch, h_scratch):
            for k, (row, *_rest) in enumerate(items):
                codes[row] = c_scratch[k]
                headers[row] = h_scratch[k]
            return
        for row, _f, _o, start, length, seg in items:
            codes[row], headers[row], _ = reader.read_segment_codes(seg, length, start=start)

    def close(self) -> None:
        if self.reader is not None:
            self.reader.close()
            self.reader = None


class SequentialChunkSampler:
    """One pass over a feature list in fixed-size batches (valid / dumps).

    Batch length = bucket draw, shrunk to the shortest utterance in the
    batch (reference batch_sequence, data_loader.py:447-461). The final
    batch may be smaller than batch_size."""

    def __init__(
        self,
        data_dir: str,
        spklist: str,
        batch_size: int = 128,
        min_len: int = 200,
        max_len: int = 400,
        shuffle: bool = True,
        seed: int = 0,
        num_buckets: int = 8,
        feature_list: Optional[Sequence[str]] = None,
        features2spk: Optional[Dict[str, int]] = None,
    ):
        self.data_dir = data_dir
        if feature_list is None:
            spk2features, features2spk, _ = get_speaker_info(data_dir, spklist)
            feature_list = [f for feats in spk2features.values() for f in feats]
        self.feature_list = list(feature_list)
        self.features2spk = features2spk
        self.batch_size = batch_size
        self.buckets = bucket_lengths(min_len, max_len, num_buckets)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        if shuffle:
            self.rng.shuffle(self.feature_list)
        self.reader: Optional[FeatureReader] = None

    @property
    def num_batches(self) -> int:
        return -(-len(self.feature_list) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.reader is None:
            self.reader = FeatureReader(self.data_dir)
        reader, rng = self.reader, self.rng
        for i in range(self.num_batches):
            batch = self.feature_list[i * self.batch_size : (i + 1) * self.batch_size]
            batch_length = rng.choice(self.buckets)
            for seg in batch:
                batch_length = min(
                    batch_length, reader.utt2num_frames[seg.split(" ")[0]]
                )
            features = np.zeros(
                (len(batch), batch_length, reader.dim), dtype=np.float32
            )
            labels = np.zeros((len(batch),), dtype=np.int32)
            for j, seg in enumerate(batch):
                features[j], _ = reader.read_segment(
                    seg, batch_length, shuffle=self.shuffle, rng=rng
                )
                labels[j] = self.features2spk[seg]
            yield features, labels

    def close(self) -> None:
        if self.reader is not None:
            self.reader.close()
            self.reader = None


class MultiRandomChunkSampler:
    """Random sampler over a main + named auxiliary feature streams.

    Yields (dict name -> [B, L, D_name], labels), the main stream under
    "features"; with ``group`` > 1 each array gains a leading axis of K
    batches at one bucket length. Aux chunks start at the SAME frame as the
    main chunk (reference data_loader.py:652-661). Each row's start is drawn
    inside the main stream's read, between one speaker's draws and the
    next's, as in the JAX sampler.
    """

    def __init__(
        self,
        data_dir: str,
        aux_data: Dict[str, str],
        spklist: str,
        num_speakers: int,
        num_segments: int = 1,
        min_len: int = 200,
        max_len: int = 400,
        shuffle: bool = True,
        seed: int = 0,
        num_buckets: int = 8,
        length_seed: Optional[int] = None,
        group: int = 1,
    ):
        self.data_dir = data_dir
        self.aux_data = aux_data
        self.spk2features, _, spk2index = get_aux_speaker_info(data_dir, aux_data, spklist)
        self.num_total_speakers = len(spk2index)
        self.num_speakers = num_speakers
        self.num_segments = num_segments
        self.buckets = bucket_lengths(min_len, max_len, num_buckets)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        # shared multi-rank length stream (see RandomChunkSampler)
        self.length_rng = random.Random(seed if length_seed is None else length_seed)
        self.group = int(group)
        self.readers: Optional[Dict[str, FeatureReader]] = None

    def __iter__(self):
        if self.readers is None:
            self.readers = {"features": FeatureReader(self.data_dir)}
            for name, d in self.aux_data.items():
                self.readers[name] = FeatureReader(d)
        speakers = list(self.spk2features.keys())
        if len(speakers) < self.num_speakers:
            speakers = speakers * (self.num_speakers // len(speakers) + 1)
        while True:
            batch_length = self.length_rng.choice(self.buckets)
            if self.group == 1:
                yield self._one_batch(speakers, batch_length)
            else:
                parts = [
                    self._one_batch(speakers, batch_length)
                    for _ in range(self.group)
                ]
                feats = {
                    name: np.stack([p[0][name] for p in parts])
                    for name in parts[0][0]
                }
                yield feats, np.stack([p[1] for p in parts])

    def _one_batch(self, speakers, batch_length):
        rng = self.rng
        main = self.readers["features"]
        B = self.num_speakers * self.num_segments
        batch_speakers = rng.sample(speakers, self.num_speakers)
        features = {
            name: np.zeros((B, batch_length, r.dim), dtype=np.float32)
            for name, r in self.readers.items()
        }
        labels = np.zeros((B,), dtype=np.int32)
        for i in range(self.num_speakers):
            spk = batch_speakers[i]
            cand: List[Dict[str, str]] = []
            while not cand:
                cand = [
                    fdict
                    for fdict in self.spk2features[spk]
                    if main.utt2num_frames[fdict["features"].split(" ")[0]]
                    > batch_length
                ]
                if not cand:
                    spk = rng.choice(list(set(speakers) - set(batch_speakers)))
                    batch_speakers[i] = spk
            labels[i * self.num_segments : (i + 1) * self.num_segments] = spk
            if len(cand) < self.num_segments:
                cand = cand * (self.num_segments // len(cand) + 1)
            for j, fdict in enumerate(rng.sample(cand, self.num_segments)):
                row = i * self.num_segments + j
                mat, start = main.read_segment(
                    fdict["features"], batch_length, shuffle=self.shuffle, rng=rng
                )
                features["features"][row] = mat
                for name in self.aux_data:
                    features[name][row], _ = self.readers[name].read_segment(
                        fdict[name], batch_length, start=start
                    )
        return features, labels

    def close(self) -> None:
        if self.readers:
            for r in self.readers.values():
                r.close()
            self.readers = None


class MultiSequentialChunkSampler:
    """One-pass multi-stream loader (reference KaldiMultiDataSeqQueue,
    data_loader.py:775-826): dict-of-features batches, aux chunks cut at the
    same start frame as the main chunk."""

    def __init__(
        self,
        data_dir: str,
        aux_data: Dict[str, str],
        spklist: str,
        batch_size: int = 128,
        min_len: int = 200,
        max_len: int = 400,
        shuffle: bool = True,
        seed: int = 0,
        num_buckets: int = 8,
        feature_list=None,
        features2spk=None,
    ):
        self.data_dir = data_dir
        self.aux_data = aux_data
        if feature_list is None:
            spk2features, features2spk, _ = get_aux_speaker_info(data_dir, aux_data, spklist)
            feature_list = [f for feats in spk2features.values() for f in feats]
        self.feature_list = list(feature_list)
        self.features2spk = features2spk
        self.batch_size = batch_size
        self.buckets = bucket_lengths(min_len, max_len, num_buckets)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        if shuffle:
            self.rng.shuffle(self.feature_list)
        self.readers: Optional[Dict[str, FeatureReader]] = None

    @property
    def num_batches(self) -> int:
        return -(-len(self.feature_list) // self.batch_size)

    def __iter__(self):
        if self.readers is None:
            self.readers = {"features": FeatureReader(self.data_dir)}
            for name, d in self.aux_data.items():
                self.readers[name] = FeatureReader(d)
        rng = self.rng
        main = self.readers["features"]
        for i in range(self.num_batches):
            batch = self.feature_list[i * self.batch_size : (i + 1) * self.batch_size]
            batch_length = rng.choice(self.buckets)
            for fdict in batch:
                batch_length = min(
                    batch_length, main.utt2num_frames[fdict["features"].split(" ")[0]]
                )
            features = {
                name: np.zeros((len(batch), batch_length, r.dim), dtype=np.float32)
                for name, r in self.readers.items()
            }
            labels = np.zeros((len(batch),), dtype=np.int32)
            for j, fdict in enumerate(batch):
                mat, start = main.read_segment(
                    fdict["features"], batch_length, shuffle=self.shuffle, rng=rng
                )
                features["features"][j] = mat
                for name in self.aux_data:
                    features[name][j], _ = self.readers[name].read_segment(
                        fdict[name], batch_length, start=start
                    )
                labels[j] = self.features2spk[fdict["features"]]
            yield features, labels

    def close(self) -> None:
        if self.readers:
            for r in self.readers.values():
                r.close()
            self.readers = None
