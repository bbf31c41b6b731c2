"""Fix a Kaldi data dir in place: the native utils/fix_data_dir.sh.

Counterpart of ``tf_kaldi_speaker_tpu/cli/fix_data_dir.py``, copied as it is
(the port imports nothing of the JAX package).

The reference recipes call Kaldi's ``utils/fix_data_dir.sh`` after every
filtering step (e.g. the reference's egs/fisher/v1/run.sh:42-68 calls it
three times while pruning short utterances and small speakers) to restore
the data-dir invariants:

- every per-utterance file (wav.scp, feats.scp, utt2spk, vad.scp,
  utt2num_frames, utt2dur, text) is filtered to the common utterance set
  (with a ``segments`` file, wav.scp is recording-keyed and is instead
  filtered to the recordings the surviving segments reference),
- files are sorted by key (C locale, like Kaldi's validate_data_dir),
- spk2utt is regenerated from utt2spk,
- a ``.backup/`` subdirectory keeps the pre-fix files.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.fix_data_dir data_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
from typing import Dict, List

log = logging.getLogger("tfks.fix_data_dir")

# Per-utterance tables, first field = utterance id.
UTT_FILES = (
    "wav.scp", "feats.scp", "utt2spk", "vad.scp", "utt2num_frames",
    "utt2dur", "text", "utt2lang",
)


def _read_table(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split(" ", 1)
            out[parts[0]] = parts[1] if len(parts) == 2 else ""
    return out


def fix_data_dir(data: str, backup: bool = True) -> Dict[str, int]:
    """Returns {filename: kept_count}; raises if utt2spk is missing."""
    # With a segments file, wav.scp is keyed by RECORDING id, not utterance
    # id (utils/fix_data_dir.sh special-cases this): keep it out of the
    # utterance intersection and filter it afterwards to the recordings the
    # surviving segments reference.
    has_segments = os.path.exists(os.path.join(data, "segments"))
    utt_files = [f for f in UTT_FILES if not (has_segments and f == "wav.scp")]
    if has_segments:
        utt_files.append("segments")
    present = [f for f in utt_files if os.path.exists(os.path.join(data, f))]
    if "utt2spk" not in present:
        raise SystemExit("%s: no utt2spk — not a data dir" % data)
    tables = {f: _read_table(os.path.join(data, f)) for f in present}

    common = None
    for f, t in tables.items():
        keys = set(t)
        common = keys if common is None else (common & keys)
    assert common is not None

    if backup:
        bdir = os.path.join(data, ".backup")
        os.makedirs(bdir, exist_ok=True)
        for f in present + ["spk2utt", "wav.scp"]:
            src = os.path.join(data, f)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(bdir, f))

    kept: Dict[str, int] = {}
    for f, t in tables.items():
        dropped = len(t) - len(common)
        if dropped:
            log.info("%s: dropped %d/%d utterances", f, dropped, len(t))
        with open(os.path.join(data, f), "w") as fd:
            for k in sorted(common):
                fd.write("%s %s\n" % (k, t[k]) if t[k] else "%s\n" % k)
        kept[f] = len(common)

    # With segments: filter the recording-keyed wav.scp to the recordings
    # that surviving segments reference.
    wav_path = os.path.join(data, "wav.scp")
    if has_segments and os.path.exists(wav_path):
        recos = {tables["segments"][u].split()[0] for u in common}
        wav = _read_table(wav_path)
        kept_recos = sorted(set(wav) & recos)
        missing = recos - set(wav)
        if missing:
            log.warning("wav.scp: %d recordings referenced by segments "
                        "are missing", len(missing))
        dropped = len(wav) - len(kept_recos)
        if dropped:
            log.info("wav.scp: dropped %d/%d recordings", dropped, len(wav))
        with open(wav_path, "w") as fd:
            for k in kept_recos:
                fd.write("%s %s\n" % (k, wav[k]) if wav[k] else "%s\n" % k)
        kept["wav.scp"] = len(kept_recos)

    # Regenerate spk2utt from the fixed utt2spk.
    spk2utt: Dict[str, List[str]] = {}
    for u in sorted(common):
        spk2utt.setdefault(tables["utt2spk"][u], []).append(u)
    with open(os.path.join(data, "spk2utt"), "w") as fd:
        for s in sorted(spk2utt):
            fd.write("%s %s\n" % (s, " ".join(spk2utt[s])))
    kept["spk2utt"] = len(spk2utt)
    log.info(
        "%s: %d utterances, %d speakers after fix", data, len(common),
        len(spk2utt),
    )
    return kept


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data", help="Kaldi data dir to fix in place")
    parser.add_argument("--no-backup", action="store_true",
                        help="skip the .backup/ copy")
    args = parser.parse_args(argv)
    fix_data_dir(args.data, backup=not args.no_backup)
    return 0


if __name__ == "__main__":
    sys.exit(main())
