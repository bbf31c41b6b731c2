"""Word-error-rate scoring (Kaldi ``compute-wer`` equivalent).

The reference scores ASR decodes with the external Kaldi ``compute-wer``
binary (invoked by the egs ``local/score.sh`` scripts the decode flow hands
off to, reference nnet/run_decode.sh). This provides the same metric
natively: Levenshtein alignment per utterance with insertion/deletion/
substitution counts, aggregated to %WER / %SER.

Tie-breaking matches Kaldi's convention: among equal-cost alignments,
substitution is preferred over insertion+deletion pairs (single pass DP
with sub <= ins/del priority), which only affects the ins/del/sub split,
never the total distance.

Counterpart of ``tf_kaldi_speaker_tpu/backend/wer.py``, whole (numpy only);
``tests/test_torch_decode.py`` holds it equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """Levenshtein distance with operation counts.

    Returns (total_errors, insertions, deletions, substitutions) where
    insertions are words in hyp but not ref.
    """
    nr, nh = len(ref), len(hyp)
    if nr == 0:
        return nh, nh, 0, 0
    if nh == 0:
        return nr, 0, nr, 0
    # DP over (errors, ins, del, sub); tuple order makes min() prefer fewer
    # total errors first, then fewer insertions (Kaldi-compatible split).
    prev: List[Tuple[int, int, int, int]] = [
        (j, j, 0, 0) for j in range(nh + 1)
    ]
    for i in range(1, nr + 1):
        cur = [(i, 0, i, 0)]
        for j in range(1, nh + 1):
            if ref[i - 1] == hyp[j - 1]:
                match = prev[j - 1]
            else:
                e, ins, dl, sb = prev[j - 1]
                match = (e + 1, ins, dl, sb + 1)
            e, ins, dl, sb = prev[j]
            delete = (e + 1, ins, dl + 1, sb)
            e, ins, dl, sb = cur[j - 1]
            insert = (e + 1, ins + 1, dl, sb)
            cur.append(min(match, delete, insert))
        prev = cur
    return prev[nh]


@dataclass
class WerStats:
    errors: int = 0
    insertions: int = 0
    deletions: int = 0
    substitutions: int = 0
    ref_words: int = 0
    sentences: int = 0
    wrong_sentences: int = 0
    missing: List[str] = field(default_factory=list)

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(1, self.ref_words)

    @property
    def ser(self) -> float:
        return 100.0 * self.wrong_sentences / max(1, self.sentences)

    def report(self) -> str:
        lines = [
            "%%WER %.2f [ %d / %d, %d ins, %d del, %d sub ]"
            % (self.wer, self.errors, self.ref_words, self.insertions,
               self.deletions, self.substitutions),
            "%%SER %.2f [ %d / %d ]"
            % (self.ser, self.wrong_sentences, self.sentences),
            "Scored %d sentences, %d not present in hyp."
            % (self.sentences, len(self.missing)),
        ]
        return "\n".join(lines)


def compute_wer(
    refs: Dict[str, Sequence], hyps: Dict[str, Sequence]
) -> WerStats:
    """Aggregate WER over utterances keyed like Kaldi text files.

    Reference utterances missing from ``hyps`` are scored as all-deletions
    (Kaldi --mode=present counts them separately; we score them, like
    --mode=all, and list them in ``missing``)."""
    stats = WerStats()
    for key in sorted(refs):
        ref = list(refs[key])
        hyp = list(hyps.get(key, []))
        if key not in hyps:
            stats.missing.append(key)
        e, ins, dl, sb = edit_distance(ref, hyp)
        stats.errors += e
        stats.insertions += ins
        stats.deletions += dl
        stats.substitutions += sb
        stats.ref_words += len(ref)
        stats.sentences += 1
        if e:
            stats.wrong_sentences += 1
    return stats


def filter_transcripts(
    texts: Dict[str, Sequence], drop: Sequence[str]
) -> Dict[str, List[str]]:
    """Token-deletion WER filter applied to refs and hyps before scoring —
    the native form of the reference's sed-based ``wer_output_filter`` /
    ``wer_ref_filter`` hooks (scripts/diagnostic/score.sh:46-50, which
    strip e.g. <NOISE>/<SPOKEN_NOISE>/<UNK> on both sides)."""
    dropset = set(drop)
    return {k: [w for w in v if w not in dropset] for k, v in texts.items()}


def read_text_file(path: str) -> Dict[str, List[str]]:
    """Kaldi text format: 'utt-id word word ...' per line."""
    out: Dict[str, List[str]] = {}
    with open(path) as fd:
        for line in fd:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out
