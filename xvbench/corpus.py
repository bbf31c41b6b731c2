"""The benchmark's one traffic generator: a synthetic Kaldi corpus of
compressed ("CM ") feature matrices, made from the seed and written as a
Kaldi data directory.

A cell's corpus comes from its configuration (``num_speakers``,
``utts_per_speaker``) and its traffic file's ``corpus`` block:

- ``lengths``: ``{"kind": "even", "min": a, "max": b}`` spreads the frame
  counts evenly over [a, b]; every seed gets the same multiset of lengths,
  in an order the seed draws, so the work does not change with the seed;
- ``stored_per_speaker``: how many distinct matrices a speaker's
  utterances share (a divisor of ``utts_per_speaker``): utterance j of a
  speaker is its matrix j mod ``stored_per_speaker``, written once in the
  ark and listed under each utterance's own key in ``feats.scp``. So a
  corpus of a deployment's utterance count, whose index the program builds,
  searches and stages one utterance at a time, writes a few hundred MB;
- ``dim``: feature columns.

The codes are written as Kaldi's CompressedMatrix stores them: a global
header (min, range, rows, cols), four uint16 percentiles a column, then the
uint8 codes column by column. The generator draws codes directly rather
than compressing float features, so a corpus of a few hundred MB takes
about a second. Its arrays stay in memory for the plain reference, which
decodes them with its own codec (``reference/codec.py``).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# CompressedMatrix's uint16 step: range / 65535
U16_SCALE = 1.52590218966964e-05
GLOBAL_MIN, GLOBAL_RANGE = -30.0, 60.0


@dataclass
class Corpus:
    """A generated corpus: where it was written and what the reference
    needs to read it again. Utterance i's codes are ``codes[starts[i]:
    starts[i] + dim * lengths[i]]``, column-major ([dim, T])."""

    data_dir: str
    scp: str
    spklist: str
    keys: list
    labels: np.ndarray      # [N] speaker index of each utterance
    lengths: np.ndarray     # [N] frames
    starts: np.ndarray      # [N] offset of the utterance's codes
    codes: np.ndarray       # flat uint8, every stored matrix column-major
    headers_u16: np.ndarray  # [N, dim, 4] uint16 percentiles
    dim: int

    def utt_codes(self, i: int) -> np.ndarray:
        """Utterance i's codes as [T, dim] (a transposed view)."""
        t = int(self.lengths[i])
        s = int(self.starts[i])
        return self.codes[s:s + self.dim * t].reshape(self.dim, t).T


def frame_lengths(spec: Dict, n: int) -> np.ndarray:
    """The multiset of ``n`` frame counts that ``spec`` describes, sorted."""
    if spec["kind"] != "even":
        raise ValueError("unknown length kind %r" % spec["kind"])
    lo, hi = int(spec["min"]), int(spec["max"])
    return lo + (np.arange(n, dtype=np.int64) * (hi - lo + 1)) // n


def _u16(values: np.ndarray) -> np.ndarray:
    return np.clip(np.floor((values - GLOBAL_MIN) / (GLOBAL_RANGE * U16_SCALE) + 0.5),
                   0, 65535).astype(np.uint16)


def generate(spec: Dict, speakers: int, per: int, seed: int, root: str) -> Corpus:
    """Draw the corpus of ``speakers`` x ``per`` utterances that ``spec``
    describes from ``seed`` and write it under ``root`` as a Kaldi data
    directory (feats.ark/scp, utt2num_frames, spk2utt, utt2spk) with a
    speaker list."""
    rng = np.random.default_rng(seed)
    dim = int(spec.get("dim", 30))
    stored = int(spec.get("stored_per_speaker", per))
    if per % stored:
        raise ValueError("stored_per_speaker %d does not divide %d" % (stored, per))
    m, n = speakers * stored, speakers * per
    # the stored matrices, speaker by speaker
    m_lengths = rng.permutation(frame_lengths(spec["lengths"], m))
    sizes = m_lengths * dim
    m_starts = np.zeros(m, np.int64)
    m_starts[1:] = np.cumsum(sizes)[:-1]
    codes = rng.integers(0, 256, int(sizes.sum()), dtype=np.uint8)
    jitter = rng.random((m, dim, 4))
    m_headers = _u16(np.stack([-20.0 + 2.0 * jitter[..., 0], -5.0 + jitter[..., 1],
                               4.0 + jitter[..., 2], 18.0 + 2.0 * jitter[..., 3]], -1))
    # each utterance's matrix
    labels = np.repeat(np.arange(speakers), per)
    matrix = labels * stored + np.tile(np.arange(per) % stored, speakers)
    keys = ["spk%05d-%07d" % (labels[i], i) for i in range(n)]

    os.makedirs(root, exist_ok=True)
    ark = os.path.join(root, "feats.ark")
    offsets = np.zeros(m, np.int64)
    with open(ark, "wb") as f:
        for j in range(m):
            f.write(keys[(j // stored) * per + j % stored].encode() + b" ")
            offsets[j] = f.tell()
            f.write(b"\0BCM ")
            f.write(struct.pack("<ffii", GLOBAL_MIN, GLOBAL_RANGE, int(m_lengths[j]), dim))
            f.write(m_headers[j].astype("<u2").tobytes())
            f.write(codes[m_starts[j]:m_starts[j] + sizes[j]].data)
    lengths = m_lengths[matrix]
    scp = os.path.join(root, "feats.scp")
    with open(scp, "w") as f:
        f.writelines("%s %s:%d\n" % (k, ark, o) for k, o in zip(keys, offsets[matrix]))
    with open(os.path.join(root, "utt2num_frames"), "w") as f:
        f.writelines("%s %d\n" % (k, l) for k, l in zip(keys, lengths))
    with open(os.path.join(root, "utt2spk"), "w") as f:
        f.writelines("%s spk%05d\n" % (k, s) for k, s in zip(keys, labels))
    with open(os.path.join(root, "spk2utt"), "w") as f:
        for s in range(speakers):
            f.write("spk%05d %s\n" % (s, " ".join(keys[s * per:(s + 1) * per])))
    spklist = os.path.join(root, "spklist")
    with open(spklist, "w") as f:
        f.writelines("spk%05d %d\n" % (s, s) for s in range(speakers))
    return Corpus(root, scp, spklist, keys, labels, lengths, m_starts[matrix], codes,
                  m_headers[matrix], dim)
