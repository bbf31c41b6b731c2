"""Combine Kaldi data dirs: the native utils/combine_data.sh.

Counterpart of ``tf_kaldi_speaker_tpu/cli/combine_data.py``, copied as it is
(the port imports nothing of the JAX package).

The reference recipes combine corpora and augmentation copies with Kaldi's
``utils/combine_data.sh`` throughout their data-prep front halves:
SRE04-08 + Mixer6 -> data/sre, SWBD phases -> data/swbd, then
``combine_data.sh --extra-files utt2num_frames $data/swbd_sre $data/swbd
$data/sre`` (the reference's egs/sre/v1/run.sh:73-181) and the
clean+augmented merges in voxceleb
(the reference's egs/voxceleb/v1/run.sh:53,114,130).

Semantics preserved:

- a per-utterance table (utt2spk, wav.scp, feats.scp, text, segments,
  utt2dur, utt2num_frames, vad.scp, utt2lang + ``--extra-files``) is
  written to the destination only when EVERY source has it; present-in-
  some files are skipped with a warning (combine_data.sh's behavior),
- duplicate utterance ids across sources are an error (the reference
  aborts on non-unique utts),
- outputs are key-sorted, spk2utt is regenerated from utt2spk, and the
  result is passed through fix_data_dir to restore the remaining
  invariants (combine_data.sh ends with fix_data_dir.sh).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.combine_data \
        [--extra-files utt2num_frames] dest src1 src2 [...]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, Iterable, List, Sequence

from .fix_data_dir import _read_table, fix_data_dir

log = logging.getLogger("tfks.combine_data")

# Candidate tables, first field = utterance id (segments/wav.scp handled
# like fix_data_dir: with segments present, wav.scp is recording-keyed but
# concatenation + the final fix keep it consistent).
COMBINE_FILES = (
    "utt2spk", "wav.scp", "feats.scp", "text", "segments", "utt2dur",
    "utt2num_frames", "vad.scp", "utt2lang",
)


def combine_data(dest: str, srcs: Sequence[str],
                 extra_files: Iterable[str] = ()) -> Dict[str, int]:
    """Concatenate ``srcs`` into ``dest``; returns {filename: rows}."""
    if len(srcs) < 1:
        raise SystemExit("combine_data: need at least one source dir")
    for s in srcs:
        if not os.path.exists(os.path.join(s, "utt2spk")):
            raise SystemExit("%s: no utt2spk — not a data dir" % s)
    os.makedirs(dest, exist_ok=True)

    written: Dict[str, int] = {}
    for fname in list(COMBINE_FILES) + list(extra_files):
        have = [os.path.exists(os.path.join(s, fname)) for s in srcs]
        if not any(have):
            continue
        if not all(have):
            log.warning("%s: present in %d/%d sources — not combined",
                        fname, sum(have), len(srcs))
            continue
        merged: Dict[str, str] = {}
        for s in srcs:
            path = os.path.join(s, fname)
            table = _read_table(path)
            # _read_table collapses repeated keys silently; a repeat WITHIN
            # one source is just as much a non-unique utterance id as one
            # across sources (the reference aborts on any of them).
            with open(path) as fd:
                n_rows = sum(1 for ln in fd if ln.strip())
            if n_rows != len(table):
                raise SystemExit(
                    "combine_data: %s contains %d duplicate keys — "
                    "utterance ids must be unique" % (path, n_rows - len(table)))
            dup = set(table) & set(merged)
            if dup:
                raise SystemExit(
                    "combine_data: %d duplicate keys in %s across sources "
                    "(e.g. %s) — utterance ids must be unique"
                    % (len(dup), fname, sorted(dup)[0]))
            merged.update(table)
        with open(os.path.join(dest, fname), "w") as fd:
            for k in sorted(merged):
                fd.write("%s %s\n" % (k, merged[k]) if merged[k]
                         else "%s\n" % k)
        written[fname] = len(merged)

    # spk2utt regenerated from the combined utt2spk (speakers MAY repeat
    # across sources — their utterance lists merge).
    utt2spk = _read_table(os.path.join(dest, "utt2spk"))
    spk2utt: Dict[str, List[str]] = {}
    for u in sorted(utt2spk):
        spk2utt.setdefault(utt2spk[u], []).append(u)
    with open(os.path.join(dest, "spk2utt"), "w") as fd:
        for s in sorted(spk2utt):
            fd.write("%s %s\n" % (s, " ".join(spk2utt[s])))
    written["spk2utt"] = len(spk2utt)

    fix_data_dir(dest, backup=False)
    log.info("%s: combined %d dirs -> %d utterances, %d speakers",
             dest, len(srcs), len(utt2spk), len(spk2utt))
    return written


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--extra-files", nargs="*", default=[],
                        help="additional per-utterance tables to combine "
                             "(combine_data.sh --extra-files)")
    parser.add_argument("dest", help="destination data dir (created)")
    parser.add_argument("srcs", nargs="+", help="source data dirs")
    args = parser.parse_args(argv)
    combine_data(args.dest, args.srcs, args.extra_files)
    return 0


if __name__ == "__main__":
    sys.exit(main())
