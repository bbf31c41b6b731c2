"""Data pipeline of the port: speaker index, chunk samplers, the prefetch
loader, and the device-resident sample pool (``device_pool``).

``KaldiDataSeqQueue`` keeps the reference's class name
(dataset/data_loader.py) and the JAX package's constructor, so the trainer
reads the same way.
"""

from __future__ import annotations

import random

from .pipeline import PrefetchLoader
from .sampler import (
    DataOutOfRange,
    RandomChunkSampler,
    SequentialChunkSampler,
    bucket_lengths,
)
from .speaker_index import get_aux_speaker_info, get_speaker_info


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
    "KaldiDataSeqQueue",
    "PrefetchLoader",
    "RandomChunkSampler",
    "SequentialChunkSampler",
    "bucket_lengths",
    "get_aux_speaker_info",
    "get_speaker_info",
]
