"""Phone-head log-likelihoods for hybrid ASR decoding.

Counterpart of ``tf_kaldi_speaker_tpu/cli/compute_loglike.py`` (reference
egs/voxceleb/v1/nnet/lib/compute_loglike.py) with the same arguments, plus
``--device`` (default ``cuda``; without a card it raises): the multitask
phone head's log-posteriors minus the log-priors (``--prior``, a text
vector summing to 1), written as a Kaldi matrix ark for
``latgen-faster-mapped``. An utterance longer than ``--chunk-size`` is
refused.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.compute_loglike --prior prior.vec \\
        [--device cuda] model_dir rspecifier wspecifier
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from ..kio import open_or_fd, read_mat_rspec, write_mat
from ._frontend import device_or_raise
from .extract_mt import load_mt_trainer


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--prior", required=True, help="text prior vector '[p0 p1 ...]'")
    parser.add_argument("--chunk-size", type=int, default=10000)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("model_dir")
    parser.add_argument("rspecifier")
    parser.add_argument("wspecifier")
    args = parser.parse_args(argv)
    device = device_or_raise(args.device)

    with open(args.prior) as f:
        prior = np.array(
            [float(x) for x in f.readline().strip().strip("[]").strip().split()],
            dtype=np.float64,
        )
    assert np.allclose(prior.sum(), 1.0), "prior must sum to 1"
    log_prior = np.log(prior)[None, :]

    trainer = load_mt_trainer(args.model_dir, device=device)
    fp_out = open_or_fd(args.wspecifier, "wb")
    count = 0
    for key, feature in read_mat_rspec(args.rspecifier):
        if feature.shape[0] > args.chunk_size:
            raise NotImplementedError("Do not let the utterance be split.")
        log_post = trainer.predict_phone(feature.astype(np.float32))
        assert log_post.shape == (feature.shape[0], prior.shape[0])
        write_mat(fp_out, (log_post - log_prior).astype(np.float32), key=key)
        count += 1
    fp_out.close()
    logging.info("Computed %d log-likelihood matrices.", count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
