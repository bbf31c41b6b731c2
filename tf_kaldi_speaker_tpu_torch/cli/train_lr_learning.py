"""LR-finder CLI: exponential learning-rate sweep (1e-5 · 1.15^k).

Counterpart of ``tf_kaldi_speaker_tpu/cli/train_lr_learning.py``
(reference egs/voxceleb/v1/nnet/lib/train_lr_learning.py +
trainer.py:522-590, train_tune_lr). Writes ``learning_rate_tuning`` lines
"k lr mean_loss" into the model dir for plotting or ``cli.tune_lr``.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.train_lr_learning --config conf.json \\
        [--tune_period 100] [--pretrain_model dir] [--device cuda] \\
        train_dir train_spklist model_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..kio import FeatureReader
from ..train.trainer import Trainer
from ..utils import bookkeeping as bk
from ._frontend import device_or_raise


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--tune_period", type=int, default=100)
    parser.add_argument("--pretrain_model", default=None,
                        help="sweep starting from a pretrained checkpoint "
                             "(reference finetune_lr_learning.py)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("train_dir")
    parser.add_argument("train_spklist")
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)
    device = device_or_raise(args.device)

    params = bk.save_codes_and_config(False, args.model_dir, args.config)
    nnet_dir = os.path.join(args.model_dir, "nnet")
    reader = FeatureReader(args.train_dir)
    dim = reader.dim
    reader.close()
    with open(args.train_spklist) as f:
        num_speakers = len(f.readlines())
    bk.write_scalar_file(os.path.join(nnet_dir, "feature_dim"), dim)
    bk.write_scalar_file(os.path.join(nnet_dir, "num_speakers"), num_speakers)

    trainer = Trainer(params, nnet_dir, dim=dim, num_speakers=num_speakers, device=device)
    trainer.build("train", dim, params.loss_func, num_speakers)
    try:
        if args.pretrain_model:
            bk.get_pretrain_model(os.path.join(args.pretrain_model, "nnet"), nnet_dir)
            trainer.get_finetune_model(params.dict.get("noload_var_list", []))
        trainer.train_tune_lr(args.train_dir, args.train_spklist, tune_period=args.tune_period)
    finally:
        trainer.close()
    logging.info("Wrote %s", os.path.join(args.model_dir, "learning_rate_tuning"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
