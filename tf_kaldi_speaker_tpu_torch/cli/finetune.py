"""Fine-tuning CLI: init from a pretrained model, optionally freezing or
re-initializing variables by name.

Counterpart of ``tf_kaldi_speaker_tpu/cli/finetune.py`` (reference
egs/voxceleb/v1/nnet/lib/finetune.py): copy the pretrained checkpoint in as
step 0 (:65-67; the port's ``.pt`` or a JAX-written ``.msgpack``), honor
the config keys ``noload_var_list`` (re-initialized) and
``noupdate_var_list`` (frozen) (:105,118), whose entries are substrings of
the JAX package's variable names (``tdnn/tdnn1_conv``,
``softmax/output_kernel``), evaluate before training (:121-125), then run
the epoch loop of cli/train.py, with its SIGTERM handling (exit 75).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.finetune --config conf.json \\
        --pretrain_model pretrain_dir [--checkpoint last] [--device cuda] \\
        train_dir train_spklist valid_dir valid_spklist model_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..backend.metrics import compute_cos_pairwise_eer
from ..kio import FeatureReader
from ..train import checkpoints
from ..train.preemption import exit_code_if_preempted, install_preemption_handler
from ..train.trainer import Trainer
from ..utils import bookkeeping as bk


def _var_list(value):
    return [s for s in value.split(",") if s] if isinstance(value, str) else list(value)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--cont", action="store_true")
    parser.add_argument("--config", default=None)
    parser.add_argument("--pretrain_model", required=False, default=None)
    parser.add_argument("--checkpoint", default="last", help="pretrain checkpoint: last|step|-1(best)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("train_dir")
    parser.add_argument("train_spklist")
    parser.add_argument("valid_dir")
    parser.add_argument("valid_spklist")
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)

    params = bk.save_codes_and_config(args.cont, args.model_dir, args.config)
    nnet_dir = os.path.join(args.model_dir, "nnet")

    reader = FeatureReader(args.train_dir)
    dim = reader.dim
    reader.close()
    with open(args.train_spklist) as f:
        num_speakers = len(f.readlines())
    bk.write_scalar_file(os.path.join(nnet_dir, "feature_dim"), dim)
    bk.write_scalar_file(os.path.join(nnet_dir, "num_speakers"), num_speakers)

    noload = _var_list(params.dict.get("noload_var_list", []))
    noupdate = _var_list(params.dict.get("noupdate_var_list", []))

    trainer = Trainer(params, nnet_dir, dim=dim, num_speakers=num_speakers, device=args.device)
    trainer.build("train", dim, params.loss_func, num_speakers, noupdate_var_list=noupdate)
    trainer.build("valid", dim, params.loss_func, num_speakers)
    install_preemption_handler(trainer)
    batch_type = params.dict.get("batch_type", "softmax")

    try:
        start_epoch = 0
        if args.cont:
            step = trainer.load()
            start_epoch = step // int(params.num_steps_per_epoch)
        else:
            assert args.pretrain_model, "--pretrain_model required unless --cont"
            pretrain_nnet = os.path.join(args.pretrain_model, "nnet")
            if args.checkpoint != "last":
                checkpoints.select_checkpoint(pretrain_nnet, args.checkpoint)
            bk.get_pretrain_model(pretrain_nnet, nnet_dir)
            trainer.get_finetune_model(noload)

        # Pre-training evaluation (finetune.py:121-125).
        valid_loss, embeddings, labels = trainer.valid(
            args.valid_dir, args.valid_spklist, batch_type=batch_type, output_embeddings=True)
        eer = compute_cos_pairwise_eer(embeddings, labels) if len(labels) else 1.0
        logging.info("BEFORE training: valid loss %f eer %.4f", valid_loss, eer)

        lr_path = os.path.join(nnet_dir, "learning_rate")
        valid_path = os.path.join(nnet_dir, "valid_loss")
        lr_schedule = bk.load_learning_rate_schedule(params.learning_rate, int(params.num_epochs))
        learning_rate = (
            float(params.learning_rate) if lr_schedule is None else lr_schedule[min(lr_schedule)]
        )
        min_lr = float(params.dict.get("min_learning_rate", 1e-6))
        reduce_lr_epochs = int(params.dict.get("reduce_lr_epochs", 4))
        early_stop_epochs = int(params.dict.get("early_stop_epochs", 10))
        best_loss = float("inf")
        since_improve = since_reduce = 0

        for epoch in range(start_epoch + 1, int(params.num_epochs) + 1):
            if lr_schedule is not None and epoch in lr_schedule:
                learning_rate = lr_schedule[epoch]
            bk.append_lr(lr_path, epoch, learning_rate)
            trainer.train(args.train_dir, args.train_spklist, learning_rate)
            rc = exit_code_if_preempted(trainer)
            if rc is not None:
                return rc
            valid_loss, embeddings, labels = trainer.valid(
                args.valid_dir, args.valid_spklist, batch_type=batch_type,
                output_embeddings=True)
            rc = exit_code_if_preempted(trainer)
            if rc is not None:
                # partial valid pass: not recorded (see cli/train.py)
                return rc
            eer = compute_cos_pairwise_eer(embeddings, labels) if len(labels) else 1.0
            logging.info("epoch %d: valid loss %f eer %.4f lr %g",
                         epoch, valid_loss, eer, learning_rate)
            bk.append_valid_loss(valid_path, epoch, valid_loss, eer)
            if lr_schedule is None:
                if valid_loss < best_loss:
                    best_loss, since_improve = valid_loss, 0
                else:
                    since_improve += 1
                since_reduce += 1
                if since_improve >= reduce_lr_epochs and since_reduce >= reduce_lr_epochs:
                    learning_rate /= 2.0
                    since_reduce = 0
                if since_improve >= early_stop_epochs or learning_rate < min_lr:
                    break
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
