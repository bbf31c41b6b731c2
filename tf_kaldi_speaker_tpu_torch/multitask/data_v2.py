"""Multitask data pipeline: features + VAD + alignment batches.

Counterpart of ``tf_kaldi_speaker_tpu/multitask/data_v2.py`` (reference
dataset/multitask/data_loader_v2.py), copied on the port's
``PrefetchLoader`` (worker threads), ``bucket_lengths``,
``get_speaker_info`` and ``FeatureReaderV2``: frame-count-proportional
speaker/utterance sampling (:16-36), batches of (features expanded by
context, vad, ali, valid_length, labels, resample, valid_pos) (:93-135),
and a one-pass sequential variant. ``num_total_phones`` comes from
``<ali_dir>/num_pdfs`` when present, else from Kaldi ``tree-info`` like the
reference (:228-229).

``length_seed`` seeds the bucket-length stream apart from the sampling
stream, so the data ranks of a multi-card run, each with its own ``seed``,
draw the same lengths (from ``seed`` when None, as in JAX).
"""

from __future__ import annotations

import os
import random
import subprocess
from typing import Dict, List, Optional

import numpy as np

from ..data.pipeline import PrefetchLoader
from ..data.sampler import bucket_lengths
from ..data.speaker_index import get_speaker_info
from ..kio.reader import FeatureReaderV2


def sample_with_probability(rd: random.Random, candidates, num_selects, regions):
    """Sample without replacement, probability ∝ region width (#frames)."""
    selected = []
    num_candidates = len(candidates)
    guard = 0
    while len(selected) < num_selects:
        r = rd.uniform(0, regions[-1])
        for k in range(num_candidates):
            if regions[k] >= r:
                if candidates[k] not in selected:
                    selected.append(candidates[k])
                break
        guard += 1
        if guard > 100 * num_selects:  # tiny datasets: fall back to uniform
            remaining = [c for c in candidates if c not in selected]
            selected += remaining[: num_selects - len(selected)]
    return selected


def get_num_phones(ali_dir: str) -> int:
    """#pdfs: from <ali_dir>/num_pdfs, else Kaldi tree-info (reference
    data_loader_v2.py:228-229)."""
    path = os.path.join(ali_dir, "num_pdfs")
    if os.path.exists(path):
        with open(path) as f:
            return int(f.read().strip())
    out = subprocess.run(
        "tree-info %s/tree | grep num-pdfs | awk '{print $2}'" % ali_dir,
        shell=True, capture_output=True, text=True, check=True,
    )
    return int(out.stdout.strip())


class RandomChunkSamplerV2:
    """Infinite random multitask batches.

    Yields (features [B, L+lc+rc, D], vad [B, L], ali [B, L],
    valid_length [B], labels [B], resample [B], valid_pos [B, 2]).
    """

    def __init__(
        self,
        data_dir: str,
        ali_dir: str,
        spklist: str,
        left_context: int,
        right_context: int,
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
        self.data_dir, self.ali_dir = data_dir, ali_dir
        self.left_context, self.right_context = left_context, right_context
        self.spk2features, _, spk2index = get_speaker_info(data_dir, spklist)
        # V2 keys utterances by plain utt id (no rxfile suffix).
        self.spk2utts: Dict[int, List[str]] = {
            spk: [seg.split(" ")[0] for seg in segs]
            for spk, segs in self.spk2features.items()
        }
        self.num_total_speakers = len(spk2index)
        self.num_speakers = num_speakers
        self.num_segments = num_segments
        self.buckets = bucket_lengths(min_len, max_len, num_buckets)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        # a separate stream for the bucket lengths, shared by the data ranks
        # (data/sampler.py)
        self.length_rng = random.Random(seed if length_seed is None else length_seed)
        # K-batch groups for single-dispatch training (see data/sampler.py)
        self.group = int(group)
        self.reader: Optional[FeatureReaderV2] = None

    def _regions(self, utt2num_frames):
        speakers = list(self.spk2utts.keys())
        spk_regions, cur = [], 0
        for spk in speakers:
            cur += sum(utt2num_frames[u] for u in self.spk2utts[spk])
            spk_regions.append(cur)
        utt_regions = {}
        for spk in speakers:
            cur, reg = 0, []
            for u in self.spk2utts[spk]:
                cur += utt2num_frames[u]
                reg.append(cur)
            utt_regions[spk] = reg
        return speakers, spk_regions, utt_regions

    def __iter__(self):
        if self.reader is None:
            self.reader = FeatureReaderV2(
                self.data_dir, self.ali_dir, self.left_context, self.right_context
            )
        reader, rng = self.reader, self.rng
        lc, rc = self.left_context, self.right_context
        speakers, spk_regions, utt_regions = self._regions(reader.utt2num_frames)
        while True:
            batch_length = self.length_rng.choice(self.buckets)
            if self.group == 1:
                yield self._one_batch(speakers, spk_regions, utt_regions,
                                      batch_length)
            else:
                parts = [
                    self._one_batch(speakers, spk_regions, utt_regions,
                                    batch_length)
                    for _ in range(self.group)
                ]
                yield tuple(
                    np.stack([p[i] for p in parts])
                    for i in range(len(parts[0]))
                )

    def _one_batch(self, speakers, spk_regions, utt_regions, batch_length):
        reader, rng = self.reader, self.rng
        lc, rc = self.left_context, self.right_context
        B = self.num_speakers * self.num_segments
        batch_speakers = sample_with_probability(
            rng, speakers, self.num_speakers, spk_regions
        )
        features = np.zeros((B, batch_length + lc + rc, reader.dim), np.float32)
        vad = np.zeros((B, batch_length), np.float32)
        ali = np.zeros((B, batch_length), np.int32)
        labels = np.zeros((B,), np.int32)
        valid_length = np.zeros((B,), np.int32)
        valid_pos = np.zeros((B, 2), np.int32)
        resample = np.zeros((B,), np.int32)
        for i, spk in enumerate(batch_speakers):
            labels[i * self.num_segments : (i + 1) * self.num_segments] = spk
            segs = sample_with_probability(
                rng, self.spk2utts[spk], self.num_segments, utt_regions[spk]
            )
            for j, utt in enumerate(segs):
                row = i * self.num_segments + j
                utt_feat, utt_vad, utt_ali, start = reader.read_segment(
                    utt, batch_length, shuffle=self.shuffle, rng=rng
                )
                utt_len = utt_feat.shape[0] - lc - rc
                features[row, : utt_feat.shape[0]] = utt_feat
                if utt_len < batch_length:
                    features[row, utt_feat.shape[0] :] = utt_feat[-1]
                vad[row, :utt_len] = utt_vad
                ali[row, :utt_len] = utt_ali
                valid_length[row] = utt_len
                n = reader.utt2num_frames[utt]
                resample[row] = 1 if start + utt_len == n else 0
                valid_pos[row, 0] = max(lc - start, 0)
                valid_pos[row, 1] = (
                    n - start - rc if start + utt_len > n - rc else utt_len
                )
        return features, vad, ali, valid_length, labels, resample, valid_pos

    def close(self):
        if self.reader is not None:
            self.reader.close()
            self.reader = None


class SequentialChunkSamplerV2:
    """One pass over utterances (validation / phone-embedding dumps)."""

    def __init__(
        self,
        data_dir: str,
        ali_dir: str,
        spklist: str,
        left_context: int,
        right_context: int,
        batch_size: int = 64,
        min_len: int = 200,
        max_len: int = 400,
        shuffle: bool = True,
        seed: int = 0,
        num_buckets: int = 8,
        feature_list: Optional[List[str]] = None,
        utt2spk: Optional[Dict[str, int]] = None,
    ):
        self.data_dir, self.ali_dir = data_dir, ali_dir
        self.left_context, self.right_context = left_context, right_context
        if feature_list is None:
            spk2features, features2spk, _ = get_speaker_info(data_dir, spklist)
            feature_list = [
                seg.split(" ")[0] for segs in spk2features.values() for seg in segs
            ]
            utt2spk = {
                seg.split(" ")[0]: spk for seg, spk in features2spk.items()
            }
        self.feature_list = list(feature_list)
        self.utt2spk = utt2spk
        self.batch_size = batch_size
        self.buckets = bucket_lengths(min_len, max_len, num_buckets)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        if shuffle:
            self.rng.shuffle(self.feature_list)
        self.reader: Optional[FeatureReaderV2] = None

    @property
    def num_batches(self) -> int:
        # Ceil: the final partial batch is yielded too (dropping it would
        # skip utterances from validation whenever a shard < batch_size).
        return -(-len(self.feature_list) // self.batch_size)

    def __iter__(self):
        if self.reader is None:
            self.reader = FeatureReaderV2(
                self.data_dir, self.ali_dir, self.left_context, self.right_context
            )
        reader, rng = self.reader, self.rng
        lc, rc = self.left_context, self.right_context
        for i in range(self.num_batches):
            batch = self.feature_list[i * self.batch_size : (i + 1) * self.batch_size]
            batch_length = rng.choice(self.buckets)
            for utt in batch:
                batch_length = min(batch_length, reader.utt2num_frames[utt])
            B = len(batch)
            features = np.zeros((B, batch_length + lc + rc, reader.dim), np.float32)
            vad = np.zeros((B, batch_length), np.float32)
            ali = np.zeros((B, batch_length), np.int32)
            labels = np.zeros((B,), np.int32)
            valid_length = np.zeros((B,), np.int32)
            valid_pos = np.zeros((B, 2), np.int32)
            resample = np.zeros((B,), np.int32)
            for j, utt in enumerate(batch):
                utt_feat, utt_vad, utt_ali, start = reader.read_segment(
                    utt, batch_length, shuffle=self.shuffle, rng=rng
                )
                utt_len = utt_feat.shape[0] - lc - rc
                features[j, : utt_feat.shape[0]] = utt_feat
                if utt_len < batch_length:
                    features[j, utt_feat.shape[0] :] = utt_feat[-1]
                vad[j, :utt_len] = utt_vad
                ali[j, :utt_len] = utt_ali
                valid_length[j] = utt_len
                labels[j] = self.utt2spk[utt]
                n = reader.utt2num_frames[utt]
                resample[j] = 1 if start + utt_len == n else 0
            yield features, vad, ali, valid_length, labels, resample, valid_pos

    def close(self):
        if self.reader is not None:
            self.reader.close()
            self.reader = None


class KaldiDataRandomQueueV2(PrefetchLoader):
    def __init__(self, data_dir, ali_dir, spklist, left_context, right_context,
                 num_parallel=2, max_qsize=10, num_speakers=64, num_segments=1,
                 min_len=200, max_len=400, shuffle=True, seed=0, length_seed=None,
                 group=1):
        _, _, spk2index = get_speaker_info(data_dir, spklist)
        self.num_total_speakers = len(spk2index)
        self.num_total_phones = get_num_phones(ali_dir)

        def factory(worker_seed):
            return RandomChunkSamplerV2(
                data_dir, ali_dir, spklist, left_context, right_context,
                num_speakers, num_segments, min_len, max_len, shuffle, worker_seed,
                length_seed=length_seed, group=group,
            )

        super().__init__(factory, num_parallel, max_qsize, base_seed=seed, finite=False)


class KaldiDataSeqQueueV2(PrefetchLoader):
    def __init__(self, data_dir, ali_dir, spklist, left_context, right_context,
                 num_parallel=1, max_qsize=10, batch_size=64,
                 min_len=200, max_len=400, shuffle=True, seed=0):
        spk2features, features2spk, spk2index = get_speaker_info(data_dir, spklist)
        self.num_total_speakers = len(spk2index)
        self.num_total_phones = get_num_phones(ali_dir)
        feature_list = [seg.split(" ")[0] for segs in spk2features.values() for seg in segs]
        utt2spk = {seg.split(" ")[0]: spk for seg, spk in features2spk.items()}
        if shuffle:
            random.Random(seed).shuffle(feature_list)
        n = max(1, len(feature_list) // num_parallel)
        shards = [
            feature_list[i * n :] if i == num_parallel - 1 else feature_list[i * n : (i + 1) * n]
            for i in range(num_parallel)
        ]

        def factory(worker_seed):
            wid = worker_seed - seed
            return SequentialChunkSamplerV2(
                data_dir, ali_dir, spklist, left_context, right_context,
                batch_size, min_len, max_len, shuffle, worker_seed,
                feature_list=shards[wid], utt2spk=utt2spk,
            )

        super().__init__(factory, num_parallel, max_qsize, base_seed=seed, finite=True)
