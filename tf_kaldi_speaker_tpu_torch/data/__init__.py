"""Data pipeline of the port: speaker index, chunk samplers, the prefetch
loaders, the host-to-card transfer (``device_prefetch``) and the
device-resident sample pool (``device_pool``).

``KaldiDataRandomQueue`` and ``KaldiDataSeqQueue`` keep the reference's
class names (dataset/data_loader.py) and the JAX package's constructors
(``tf_kaldi_speaker_tpu/data/__init__.py``), so the trainer reads the same
way. The loaders are threads, not processes: a forked child cannot use
CUDA once the parent has initialized it.
"""

from __future__ import annotations

import random

from .pipeline import PrefetchLoader, device_prefetch
from .sampler import (
    DataOutOfRange,
    RandomChunkSampler,
    SequentialChunkSampler,
    bucket_lengths,
)
from .speaker_index import get_aux_speaker_info, get_speaker_info


class KaldiDataRandomQueue(PrefetchLoader):
    """Infinite random-batch loader with the reference's constructor shape."""

    def __init__(
        self,
        data_dir: str,
        spklist: str,
        num_parallel: int = 4,
        max_qsize: int = 10,
        num_speakers: int = 64,
        num_segments: int = 1,
        min_len: int = 200,
        max_len: int = 400,
        shuffle: bool = True,
        seed: int = 0,
        num_buckets: int = 8,
        raw_codes: bool = False,
        length_seed: "int | None" = None,
        group: int = 1,
    ):
        spk2features, _, spk2index = get_speaker_info(data_dir, spklist)
        self.num_total_speakers = len(spk2index)

        def factory(worker_seed: int):
            return RandomChunkSampler(
                data_dir,
                spklist,
                num_speakers,
                num_segments,
                min_len,
                max_len,
                shuffle,
                worker_seed,
                num_buckets,
                spk2features=spk2features,
                num_total_speakers=self.num_total_speakers,
                raw_codes=raw_codes,
                length_seed=length_seed,
                group=group,
            )

        super().__init__(factory, num_parallel, max_qsize, base_seed=seed, finite=False)


class KaldiDataSeqQueue(PrefetchLoader):
    """One-pass sequential loader; fetch() raises DataOutOfRange at the end."""

    def __init__(
        self,
        data_dir: str,
        spklist: str,
        num_parallel: int = 1,
        max_qsize: int = 10,
        batch_size: int = 128,
        min_len: int = 200,
        max_len: int = 400,
        shuffle: bool = True,
        seed: int = 0,
        num_buckets: int = 8,
    ):
        spk2features, features2spk, spk2index = get_speaker_info(data_dir, spklist)
        self.num_total_speakers = len(spk2index)
        feature_list = [f for feats in spk2features.values() for f in feats]
        if shuffle:
            random.Random(seed).shuffle(feature_list)
        # Split the list across workers (reference data_loader.py:505-511).
        n = max(1, len(feature_list) // num_parallel)
        shards = [
            feature_list[i * n :] if i == num_parallel - 1 else feature_list[i * n : (i + 1) * n]
            for i in range(num_parallel)
        ]

        def factory(worker_seed: int):
            wid = worker_seed - seed
            return SequentialChunkSampler(
                data_dir,
                spklist,
                batch_size,
                min_len,
                max_len,
                shuffle,
                worker_seed,
                num_buckets,
                feature_list=shards[wid],
                features2spk=features2spk,
            )

        super().__init__(factory, num_parallel, max_qsize, base_seed=seed, finite=True)


__all__ = [
    "DataOutOfRange",
    "KaldiDataRandomQueue",
    "KaldiDataSeqQueue",
    "PrefetchLoader",
    "RandomChunkSampler",
    "SequentialChunkSampler",
    "bucket_lengths",
    "device_prefetch",
    "get_aux_speaker_info",
    "get_speaker_info",
]
