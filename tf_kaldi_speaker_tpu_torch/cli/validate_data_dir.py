"""Validate a Kaldi data dir: the native utils/validate_data_dir.sh.

Counterpart of ``tf_kaldi_speaker_tpu/cli/validate_data_dir.py``, copied as it is
(the port imports nothing of the JAX package).

The reference recipes validate after every corpus combine
(the reference's egs/sre/v1/run.sh:76-84 calls
``utils/validate_data_dir.sh --no-text --no-feats`` on the combined
SRE04-08 and SWBD dirs before fixing them). The script itself is
Kaldi-symlinked at stage -1 and is not part of the reference tree; this
is a behavioral equivalent of its checks:

- ``utt2spk`` exists, is non-empty, every line has exactly 2 fields,
  keys are unique and in C-locale sorted order, and the file is also
  sorted when sorted first on speaker-id (speakers must be contiguous
  blocks in sorted order — Kaldi's "sorted on speaker-id" rule, which
  utterance ids carrying their speaker as a prefix satisfies),
- ``spk2utt`` (if present) is the exact inverse of utt2spk, sorted,
- ``wav.scp`` keys equal the utt2spk keys — or, with a ``segments``
  file, cover every recording the segments reference (wav.scp is
  recording-keyed then; segments rows need 4 fields with start < end),
- per-utterance tables (``utt2num_frames``, ``utt2dur``, ``vad.scp``,
  ``utt2lang``) have sorted unique keys equal to the utterance set;
  utt2num_frames must be positive integers, utt2dur positive floats,
- without ``--no-feats``: ``feats.scp`` must exist and match the
  utterance set; without ``--no-text``: ``text`` must exist and match.

Exit status 0 = valid; 1 = first violated invariant (printed).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.validate_data_dir \
        [--no-text] [--no-feats] [--no-wav] data_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, List, Tuple

log = logging.getLogger("tfks.validate_data_dir")


class ValidationError(SystemExit):
    def __init__(self, msg: str):
        super().__init__("validate_data_dir: %s" % msg)


def _read_lines(path: str) -> List[Tuple[str, str]]:
    """[(key, rest)] preserving file order; rejects empty/whitespace lines."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line.strip():
                raise ValidationError("%s:%d: empty line" % (path, i))
            parts = line.split(" ", 1)
            out.append((parts[0], parts[1] if len(parts) == 2 else ""))
    return out


def _check_sorted_unique(path: str, rows: List[Tuple[str, str]]) -> None:
    keys = [k for k, _ in rows]
    for a, b in zip(keys, keys[1:]):
        if a == b:
            raise ValidationError("%s: duplicate key %r" % (path, a))
        if a > b:
            raise ValidationError(
                "%s: not in sorted order (%r > %r); run tfks-fix-data-dir"
                % (path, a, b))


def validate_data_dir(data: str, no_text: bool = False,
                      no_feats: bool = False,
                      no_wav: bool = False) -> Dict[str, int]:
    """Returns {table: row count} for the validated tables.

    Defaults match the CLI and Kaldi's ``utils/validate_data_dir.sh``:
    ``text`` and ``feats.scp`` are REQUIRED unless explicitly waived, so
    a library call validates exactly as strictly as the identical-looking
    shell invocation."""
    u2s_path = os.path.join(data, "utt2spk")
    if not os.path.exists(u2s_path):
        raise ValidationError("%s: no utt2spk — not a data dir" % data)
    u2s_rows = _read_lines(u2s_path)
    if not u2s_rows:
        raise ValidationError("%s: utt2spk is empty" % data)
    for k, rest in u2s_rows:
        if not rest or " " in rest:
            raise ValidationError(
                "utt2spk: line for %r does not have exactly 2 fields" % k)
    _check_sorted_unique(u2s_path, u2s_rows)
    # Kaldi's second ordering rule: utt2spk must also be sorted when sorted
    # first on speaker-id — i.e. each speaker's utterances form one
    # contiguous block and the blocks appear in sorted speaker order.
    spks_in_order = []
    for _, s in u2s_rows:
        if not spks_in_order or spks_in_order[-1] != s:
            spks_in_order.append(s)
    if len(set(spks_in_order)) != len(spks_in_order):
        raise ValidationError(
            "utt2spk: utterances of a speaker are not contiguous "
            "(not sorted when sorted first on speaker-id)")
    if spks_in_order != sorted(spks_in_order):
        raise ValidationError(
            "utt2spk: speaker blocks not in sorted order "
            "(not sorted when sorted first on speaker-id)")
    utts = [k for k, _ in u2s_rows]
    utt_set = set(utts)
    counts = {"utt2spk": len(u2s_rows)}

    s2u_path = os.path.join(data, "spk2utt")
    if os.path.exists(s2u_path):
        s2u_rows = _read_lines(s2u_path)
        _check_sorted_unique(s2u_path, s2u_rows)
        inverse: Dict[str, str] = {}
        for s, rest in s2u_rows:
            for u in rest.split():
                if u in inverse:
                    raise ValidationError(
                        "spk2utt: utterance %r listed twice" % u)
                inverse[u] = s
        if inverse != dict(u2s_rows):
            raise ValidationError(
                "spk2utt is not the inverse of utt2spk "
                "(run tfks-fix-data-dir)")
        counts["spk2utt"] = len(s2u_rows)

    seg_path = os.path.join(data, "segments")
    has_segments = os.path.exists(seg_path)
    recos = None
    if has_segments:
        seg_rows = _read_lines(seg_path)
        _check_sorted_unique(seg_path, seg_rows)
        if [k for k, _ in seg_rows] != utts:
            raise ValidationError("segments: keys differ from utt2spk")
        recos = set()
        for k, rest in seg_rows:
            fields = rest.split()
            if len(fields) != 3:
                raise ValidationError(
                    "segments: line for %r does not have 4 fields" % k)
            reco, start, end = fields
            try:
                s0, s1 = float(start), float(end)
            except ValueError:
                raise ValidationError(
                    "segments: non-numeric times for %r" % k)
            if not (s1 > s0 >= 0 or s1 == -1):  # -1 = "until end" convention
                raise ValidationError(
                    "segments: bad times for %r (%s >= %s)" % (k, start, end))
            recos.add(reco)
        counts["segments"] = len(seg_rows)

    wav_path = os.path.join(data, "wav.scp")
    if not no_wav:
        if not os.path.exists(wav_path):
            raise ValidationError("%s: no wav.scp" % data)
        wav_rows = _read_lines(wav_path)
        _check_sorted_unique(wav_path, wav_rows)
        wav_keys = {k for k, _ in wav_rows}
        if has_segments:
            assert recos is not None
            missing = recos - wav_keys
            if missing:
                raise ValidationError(
                    "wav.scp: %d recordings referenced by segments are "
                    "missing (e.g. %r)" % (len(missing), sorted(missing)[0]))
        elif wav_keys != utt_set:
            raise ValidationError(
                "wav.scp: keys differ from utt2spk (%d vs %d utterances)"
                % (len(wav_keys), len(utt_set)))
        counts["wav.scp"] = len(wav_rows)

    def check_utt_table(name, required, value_check=None):
        path = os.path.join(data, name)
        if not os.path.exists(path):
            if required:
                raise ValidationError("%s: no %s" % (data, name))
            return
        rows = _read_lines(path)
        _check_sorted_unique(path, rows)
        if [k for k, _ in rows] != utts:
            raise ValidationError("%s: keys differ from utt2spk" % name)
        if value_check is not None:
            for k, rest in rows:
                if not value_check(rest):
                    raise ValidationError(
                        "%s: bad value %r for %r" % (name, rest, k))
        counts[name] = len(rows)

    def _pos_int(v):
        return v.isdigit() and int(v) > 0

    def _pos_float(v):
        try:
            return float(v) > 0
        except ValueError:
            return False

    check_utt_table("feats.scp", required=not no_feats)
    check_utt_table("text", required=not no_text)
    check_utt_table("utt2num_frames", required=False, value_check=_pos_int)
    check_utt_table("utt2dur", required=False, value_check=_pos_float)
    check_utt_table("vad.scp", required=False)
    check_utt_table("utt2lang", required=False)

    log.info("%s: ok — %d utterances, %d speakers%s", data, len(utts),
             len(set(spks_in_order)),
             ", %d segments" % counts["segments"] if has_segments else "")
    return counts


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data", help="Kaldi data dir to validate")
    parser.add_argument("--no-text", action="store_true",
                        help="do not require a text file")
    parser.add_argument("--no-feats", action="store_true",
                        help="do not require feats.scp")
    parser.add_argument("--no-wav", action="store_true",
                        help="do not require wav.scp")
    args = parser.parse_args(argv)
    validate_data_dir(args.data, no_text=args.no_text,
                      no_feats=args.no_feats, no_wav=args.no_wav)
    return 0


if __name__ == "__main__":
    sys.exit(main())
