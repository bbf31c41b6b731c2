"""Analyze an LR-finder sweep and suggest a learning rate.

A copy of ``tf_kaldi_speaker_tpu/cli/tune_lr.py`` (numpy only). Replaces
reference misc/tuning/tune_lr.m (MATLAB plot): reads the
``learning_rate_tuning`` file written by cli.train_lr_learning
("k lr mean_loss" lines) and prints the steepest-descent LR and the
pre-divergence maximum, the two standard pick rules.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.tune_lr model_dir_or_file
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 1
    path = argv[0]
    if os.path.isdir(path):
        path = os.path.join(path, "learning_rate_tuning")
    rows = np.loadtxt(path, ndmin=2)
    lrs, losses = rows[:, 1], rows[:, 2]
    finite = np.isfinite(losses)
    lrs, losses = lrs[finite], losses[finite]
    if len(lrs) < 3:
        print("Not enough sweep points.", file=sys.stderr)
        return 1
    # steepest descent: most negative d(loss)/d(log lr)
    slope = np.diff(losses) / np.diff(np.log(lrs))
    k = int(np.argmin(slope))
    steepest = lrs[k]
    # divergence point: first loss > 1.5x running min
    running_min = np.minimum.accumulate(losses)
    div = np.argmax(losses > 1.5 * running_min) or len(lrs) - 1
    print("steepest-descent lr: %.2e" % steepest)
    print("max stable lr:       %.2e" % lrs[max(div - 1, 0)])
    print("suggested lr (steepest/1): %.2e" % steepest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
