"""The trainer's chunk sampling, for the reference: which (utterance,
start, label) triples a training step draws.

A frozen copy of the fully resident device pool's sampler
(``data/device_pool.py``: ``sample_group`` with ``_draw_speaker_rows`` and
``_resolve_speaker``), the reference recipe's rule (speaker-balanced
batches, random starts inside each utterance, a speaker without an
utterance longer than the chunk resampled) over the utterances in
``feats.scp`` order grouped by speaker. The trainer seeds it per epoch
with ``seed + step0``, its bucket-length stream with the same value, one
bucket length a group of K steps.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np


def bucket_lengths(min_len: int, max_len: int, num_buckets: int = 8) -> List[int]:
    """Chunk lengths spanning [min_len, max_len], multiples of 8."""
    if max_len <= min_len:
        return [int(min_len)]
    pts = np.linspace(min_len, max_len, num_buckets)
    return sorted({int(np.clip(int(round(p / 8.0)) * 8, min_len, max_len)) for p in pts})


class PoolIndex:
    """Utterances in pool order: ``labels`` [N] and ``lengths`` [N] in the
    data directory's feats.scp order, speakers in order of first
    appearance."""

    def __init__(self, labels: Sequence[int], lengths: Sequence[int]):
        self.lengths = [int(x) for x in lengths]
        self.spk2utts: Dict[int, List[int]] = {}
        for i, spk in enumerate(labels):
            self.spk2utts.setdefault(int(spk), []).append(i)

    def _resolve(self, rng, spk, batch_speakers, i, length):
        tried = set()
        while True:
            cand = [u for u in self.spk2utts[spk] if self.lengths[u] > length]
            if cand:
                batch_speakers[i] = spk
                return spk, cand
            tried.add(spk)
            pool = [s for s in self.spk2utts if s not in tried and s not in batch_speakers]
            if not pool:
                raise ValueError("no speaker has an utterance longer than %d frames" % length)
            spk = rng.choice(pool)

    def sample_group(self, rng: random.Random, group: int, num_speakers: int,
                     num_segments: int, length: int) -> List[List[Tuple[int, int, int]]]:
        """``group`` batches of (utt, start within the utterance, label)."""
        speakers = list(self.spk2utts)
        if len(speakers) < num_speakers:
            speakers = speakers * (num_speakers // len(speakers) + 1)
        out = []
        for _ in range(group):
            batch_speakers = rng.sample(speakers, num_speakers)
            rows = []
            for i in range(num_speakers):
                spk, cand = self._resolve(rng, batch_speakers[i], batch_speakers, i, length)
                if len(cand) < num_segments:
                    cand = cand * (num_segments // len(cand) + 1)
                for u in rng.sample(cand, num_segments):
                    rows.append((u, rng.randint(0, self.lengths[u] - length), spk))
            out.append(rows)
        return out


def epoch_batches(index: PoolIndex, seed: int, step0: int, steps: int, group: int,
                  num_speakers: int, num_segments: int, buckets: Sequence[int]):
    """The batches of an epoch that starts at step ``step0`` and runs
    ``steps`` steps in groups of ``group``: a list of (length, rows)."""
    rng = random.Random(seed + step0)
    length_rng = random.Random(seed + step0)
    out = []
    for _ in range(steps // group):
        length = length_rng.choice(list(buckets))
        for rows in index.sample_group(rng, group, num_speakers, num_segments, length):
            out.append((length, rows))
    return out

