"""Batch samplers: random N-speaker x M-segment chunks and one-pass sequential.

A copy of ``RandomChunkSampler``, ``SequentialChunkSampler``,
``bucket_lengths`` and ``DataOutOfRange`` from
``tf_kaldi_speaker_tpu/data/sampler.py`` (reference
dataset/data_loader.py:229-573). Per-batch lengths are drawn from a small
bucket set spanning [min_len, max_len]; batches are exactly bucket-length
(no padding), and sampling is deterministic given the seed. The draws are
the JAX package's, in its order (``tests/test_torch_pool.py``); rows are
read one by one through the port's reader, where the JAX package calls its
native batch decoder when it is built.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..kio.reader import FeatureReader
from .speaker_index import get_speaker_info


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
        # The chunk starts are drawn for the whole plan first, then read.
        starts = [
            rng.randint(0, reader.utt2num_frames[seg.split(" ")[0]] - batch_length)
            if self.shuffle else 0
            for _, seg in plan
        ]
        if self.raw_codes:
            codes = np.zeros((B, batch_length, reader.dim), dtype=np.uint8)
            headers = np.zeros((B, 4, reader.dim), dtype=np.float32)
            for (row, seg), start in zip(plan, starts):
                codes[row], headers[row], _ = reader.read_segment_codes(
                    seg, batch_length, start=start)
            return codes, headers, labels
        features = np.zeros((B, batch_length, reader.dim), dtype=np.float32)
        for (row, seg), start in zip(plan, starts):
            features[row], _ = reader.read_segment(seg, batch_length, start=start)
        return features, labels

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
