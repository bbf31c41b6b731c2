"""Filter a prepared egs dir and build the speaker index + train/valid split.

Counterpart of ``tf_kaldi_speaker_tpu/cli/filter_egs_dir.py``, copied as it is
(the port imports nothing of the JAX package).

Replaces the reference's inline recipe shell (egs/voxceleb/v1/run.sh:140-194):
drop utterances shorter than --min-len, drop speakers with fewer than
--min-num-utts utterances, write the ``spklist`` (speaker → index) file, and
optionally carve out a validation subset (N speakers × M utts, like
misc/tools/sample_validset_spk2utt.py at run.sh:179).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.filter_egs_dir --min-len 200 \
        --min-num-utts 8 [--valid-speakers 200 --valid-utts 5] data_dir out_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys
from typing import Dict, List


def _read_pairs(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ", 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def _write_dir(out_dir, feats, u2nf, utt2spk):
    os.makedirs(out_dir, exist_ok=True)
    spk2utt: Dict[str, List[str]] = {}
    for u, s in utt2spk.items():
        spk2utt.setdefault(s, []).append(u)
    with open(os.path.join(out_dir, "feats.scp"), "w") as f:
        for u in sorted(feats):
            f.write("%s %s\n" % (u, feats[u]))
    with open(os.path.join(out_dir, "utt2num_frames"), "w") as f:
        for u in sorted(u2nf):
            f.write("%s %s\n" % (u, u2nf[u]))
    with open(os.path.join(out_dir, "utt2spk"), "w") as f:
        for u in sorted(utt2spk):
            f.write("%s %s\n" % (u, utt2spk[u]))
    with open(os.path.join(out_dir, "spk2utt"), "w") as f:
        for s in sorted(spk2utt):
            f.write("%s %s\n" % (s, " ".join(sorted(spk2utt[s]))))
    return sorted(spk2utt)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--min-len", type=int, default=200)
    parser.add_argument("--min-num-utts", type=int, default=8)
    parser.add_argument("--valid-speakers", type=int, default=0)
    parser.add_argument("--valid-utts", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("data_dir")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)

    feats = _read_pairs(os.path.join(args.data_dir, "feats.scp"))
    u2nf = _read_pairs(os.path.join(args.data_dir, "utt2num_frames"))
    utt2spk = _read_pairs(os.path.join(args.data_dir, "utt2spk"))

    kept = {u for u in feats if int(u2nf.get(u, 0)) >= args.min_len and u in utt2spk}
    by_spk: Dict[str, List[str]] = {}
    for u in kept:
        by_spk.setdefault(utt2spk[u], []).append(u)
    by_spk = {s: us for s, us in by_spk.items() if len(us) >= args.min_num_utts}
    kept = {u for us in by_spk.values() for u in us}
    logging.info("Kept %d utts over %d speakers.", len(kept), len(by_spk))

    rng = random.Random(args.seed)
    valid_utts = set()
    if args.valid_speakers > 0:
        spks = sorted(by_spk)
        vspk = rng.sample(spks, min(args.valid_speakers, len(spks)))
        for s in vspk:
            us = sorted(by_spk[s])
            valid_utts.update(rng.sample(us, min(args.valid_utts, len(us))))

    train_utts = kept - valid_utts
    spks = _write_dir(
        os.path.join(args.out_dir, "train"),
        {u: feats[u] for u in train_utts},
        {u: u2nf[u] for u in train_utts},
        {u: utt2spk[u] for u in train_utts},
    )
    with open(os.path.join(args.out_dir, "train", "spklist"), "w") as f:
        for i, s in enumerate(spks):
            f.write("%s %d\n" % (s, i))
    if valid_utts:
        _write_dir(
            os.path.join(args.out_dir, "valid"),
            {u: feats[u] for u in valid_utts},
            {u: u2nf[u] for u in valid_utts},
            {u: utt2spk[u] for u in valid_utts},
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
