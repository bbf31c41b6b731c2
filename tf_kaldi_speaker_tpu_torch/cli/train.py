"""Training CLI: epoch driver with validation-driven LR halving.

Counterpart of ``tf_kaldi_speaker_tpu/cli/train.py`` (reference
egs/voxceleb/v1/nnet/lib/train.py): the epoch loop, the learning-rate file
or validation-driven halving (:108-120), early stop (:133-139), ``--cont``,
and the model-dir bookkeeping files. Epochs are 1-based, so checkpoint step
= epoch * num_steps_per_epoch. Batches come from the streaming loader or,
with ``device_pool: true``, from the device pool. On SIGTERM the epoch stops
at the next group boundary with a checkpoint at the step reached and the
CLI exits 75 (``train/preemption.py``); a validation pass that a SIGTERM
cut is not recorded. ``--cont`` resumes the remainder of the epoch.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.train [--cont] [--config conf.json] \\
        [--device cuda] train_dir train_spklist valid_dir valid_spklist model_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..backend.metrics import compute_cos_pairwise_eer
from ..kio import FeatureReader
from ..train.preemption import exit_code_if_preempted, install_preemption_handler
from ..train.trainer import Trainer
from ..utils import bookkeeping as bk
from . import _launch


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--cont", action="store_true", help="continue training")
    parser.add_argument("--config", default=None, help="JSON config (required unless --cont)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("train_dir")
    parser.add_argument("train_spklist")
    parser.add_argument("valid_dir")
    parser.add_argument("valid_spklist")
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)

    device = _launch.start(args.device)
    params = _launch.model_dir_params(args.cont, args.model_dir, args.config, device)
    nnet_dir = os.path.join(args.model_dir, "nnet")

    reader = FeatureReader(args.train_dir)
    dim = reader.dim
    reader.close()
    with open(args.train_spklist) as f:
        num_speakers = len(f.readlines())
    _launch.on_main(bk.write_scalar_file, os.path.join(nnet_dir, "feature_dim"), dim)
    _launch.on_main(bk.write_scalar_file, os.path.join(nnet_dir, "num_speakers"), num_speakers)

    trainer = Trainer(params, nnet_dir, dim=dim, num_speakers=num_speakers, device=device)
    trainer.build("train", dim, params.loss_func, num_speakers)
    trainer.build("valid", dim, params.loss_func, num_speakers)
    install_preemption_handler(trainer)

    start_epoch = 0
    if args.cont:
        step = trainer.load()
        start_epoch = step // int(params.num_steps_per_epoch)

    lr_path = os.path.join(nnet_dir, "learning_rate")
    valid_path = os.path.join(nnet_dir, "valid_loss")
    lr_schedule = bk.load_learning_rate_schedule(params.learning_rate, int(params.num_epochs))
    lr_history = bk.load_lr_file(lr_path)
    valid_history = bk.load_valid_loss(valid_path)

    if lr_history and args.cont:
        learning_rate = lr_history[max(lr_history)]
    elif lr_schedule is None:
        learning_rate = float(params.learning_rate)
    else:
        learning_rate = lr_schedule[min(lr_schedule)]

    min_lr = float(params.dict.get("min_learning_rate", 1e-6))
    reduce_lr_epochs = int(params.dict.get("reduce_lr_epochs", 4))
    early_stop_epochs = int(params.dict.get("early_stop_epochs", 10))
    batch_type = params.dict.get("batch_type", "softmax")

    best_loss = min((v[1] for v in valid_history), default=float("inf"))
    epochs_since_improve = 0
    epochs_since_reduce = 0

    try:
        for epoch in range(start_epoch + 1, int(params.num_epochs) + 1):
            if lr_schedule is not None and epoch in lr_schedule:
                learning_rate = lr_schedule[epoch]
            _launch.on_main(bk.append_lr, lr_path, epoch, learning_rate)
            trainer.train(args.train_dir, args.train_spklist, learning_rate)
            rc = exit_code_if_preempted(trainer)
            if rc is not None:
                return rc
            valid_loss, embeddings, labels = trainer.valid(
                args.valid_dir, args.valid_spklist,
                batch_type=batch_type, output_embeddings=True,
            )
            rc = exit_code_if_preempted(trainer)
            if rc is not None:
                # SIGTERM landed during validation: the pass is partial, so do
                # not record it (a truncated loss would poison LR halving on
                # resume); the epoch checkpoint was already saved by train().
                return rc
            eer = compute_cos_pairwise_eer(embeddings, labels) if len(labels) else 1.0
            logging.info("epoch %d: valid loss %f eer %.4f lr %g",
                         epoch, valid_loss, eer, learning_rate)
            _launch.on_main(bk.append_valid_loss, valid_path, epoch, valid_loss, eer)

            if lr_schedule is None:
                # Validation-driven halving (reference train.py:108-120).
                if valid_loss < best_loss:
                    best_loss = valid_loss
                    epochs_since_improve = 0
                else:
                    epochs_since_improve += 1
                epochs_since_reduce += 1
                if (epochs_since_improve >= reduce_lr_epochs
                        and epochs_since_reduce >= reduce_lr_epochs):
                    learning_rate /= 2.0
                    epochs_since_reduce = 0
                    logging.info("Halving learning rate to %g", learning_rate)
                if learning_rate < min_lr and epochs_since_improve >= early_stop_epochs:
                    logging.info("Early stopping at epoch %d", epoch)
                    break
                if epochs_since_improve >= early_stop_epochs:
                    logging.info("No improvement for %d epochs; stopping", early_stop_epochs)
                    break
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
