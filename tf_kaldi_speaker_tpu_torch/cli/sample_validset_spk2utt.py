"""Sample a held-out validation subset from a spk2utt file.

Counterpart of ``tf_kaldi_speaker_tpu/cli/sample_validset_spk2utt.py``, copied as it is
(the port imports nothing of the JAX package).

Behavioral spec: reference misc/tools/sample_validset_spk2utt.py (used by
egs/voxceleb/v1/run.sh:179): pick min(num_utts, available) utterances from
each of num_speakers random speakers.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.sample_validset_spk2utt \
        num_speakers num_utts_per_speaker in_spk2utt > out_spk2utt
"""

from __future__ import annotations

import random
import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 1
    num_speakers, num_utts = int(argv[0]), int(argv[1])
    rng = random.Random(0)
    spk2utt = {}
    with open(argv[2]) as f:
        for line in f:
            spk, utts = line.strip().split(" ", 1)
            spk2utt[spk] = utts.split(" ")
    speakers = sorted(spk2utt)
    chosen = rng.sample(speakers, min(num_speakers, len(speakers)))
    for spk in chosen:
        utts = spk2utt[spk]
        sel = rng.sample(utts, min(num_utts, len(utts)))
        print("%s %s" % (spk, " ".join(sel)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
