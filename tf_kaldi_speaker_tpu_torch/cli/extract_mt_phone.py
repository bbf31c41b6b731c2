"""Per-frame phone log-posteriors from the multitask model (ark -> matrix ark).

Counterpart of ``tf_kaldi_speaker_tpu/cli/extract_mt_phone.py`` (reference
egs/voxceleb/v1/nnet/lib/extract_mt_phone.py, commented out upstream and
working in the JAX package) with the same arguments, plus ``--device``
(default ``cuda``; without a card it raises): the phone head's
log-posteriors per frame as float32 matrices; utterances longer than
``--chunk-size`` are skipped.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.extract_mt_phone [--device cuda] \\
        model_dir rspecifier wspecifier
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from ..kio import open_or_fd, read_mat_rspec, write_mat
from .extract_mt import load_mt_trainer


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunk-size", type=int, default=10000)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("model_dir")
    parser.add_argument("rspecifier")
    parser.add_argument("wspecifier")
    args = parser.parse_args(argv)

    trainer = load_mt_trainer(args.model_dir, device=args.device)
    fp_out = open_or_fd(args.wspecifier, "wb")
    count = 0
    for key, feature in read_mat_rspec(args.rspecifier):
        if feature.shape[0] > args.chunk_size:
            logging.info("Key %s too long (%d), skip.", key, feature.shape[0])
            continue
        # phone log-posteriors serve as frame-level phonetic features
        mat = trainer.predict_phone(feature.astype(np.float32))
        write_mat(fp_out, mat.astype(np.float32), key=key)
        count += 1
    fp_out.close()
    logging.info("Extracted %d phone matrices.", count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
