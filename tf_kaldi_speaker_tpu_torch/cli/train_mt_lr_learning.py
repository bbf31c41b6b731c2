"""LR-finder for the multitask model.

Counterpart of ``tf_kaldi_speaker_tpu/cli/train_mt_lr_learning.py``
(reference train_mt_lr_learning.py) with the same arguments, plus
``--device`` (default ``cuda``; without a card it raises): an exponential
learning-rate sweep, ``--tune_period`` steps a rate, written to
``<model_dir>/learning_rate_tuning``.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.train_mt_lr_learning --config conf.json \\
        [--device cuda] train_dir train_ali_dir train_spklist model_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..kio import FeatureReaderV2
from ..multitask import TrainerMultiTask, get_num_phones
from ..utils import bookkeeping as bk
from ._frontend import device_or_raise


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--tune_period", type=int, default=100)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("train_dir")
    parser.add_argument("train_ali_dir")
    parser.add_argument("train_spklist")
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)

    device = device_or_raise(args.device)
    params = bk.save_codes_and_config(False, args.model_dir, args.config)
    nnet_dir = os.path.join(args.model_dir, "nnet")
    reader = FeatureReaderV2(
        args.train_dir, args.train_ali_dir,
        int(params.phone_left_context), int(params.phone_right_context),
    )
    dim = reader.dim
    reader.close()
    with open(args.train_spklist) as f:
        num_speakers = len(f.readlines())
    num_phones = get_num_phones(args.train_ali_dir)
    bk.write_scalar_file(os.path.join(nnet_dir, "feature_dim"), dim)
    bk.write_scalar_file(os.path.join(nnet_dir, "num_speakers"), num_speakers)
    bk.write_scalar_file(os.path.join(nnet_dir, "num_phones"), num_phones)

    trainer = TrainerMultiTask(params, nnet_dir, dim=dim, num_speakers=num_speakers,
                               num_phones=num_phones, device=device)
    trainer.build("train", dim, num_speakers=num_speakers, num_phones=num_phones)
    trainer.train_tune_lr(args.train_dir, args.train_ali_dir, args.train_spklist,
                          tune_period=args.tune_period)
    return 0


if __name__ == "__main__":
    sys.exit(main())
