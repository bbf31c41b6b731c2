"""Multi-input training CLI (main + auxiliary feature streams).

Counterpart of ``tf_kaldi_speaker_tpu/cli/train_mi.py`` (reference
egs/voxceleb/v1/nnet/lib/train_mi.py) with the same arguments, plus
``--device`` (default ``cuda``): the epoch driver of ``cli.train`` (the
learning-rate file or validation-driven halving, early stop, ``--cont``),
with the aux data directories passed as "name1:dir1;name2:dir2" and
``aux_feature_dim`` in the config. On SIGTERM the epoch stops at the next
group boundary with a checkpoint and the CLI exits 75.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.train_mi --config conf.json \\
        --aux_data "bnf:/path/to/bnf_datadir" [--device cuda] \\
        train_dir train_spklist valid_dir valid_spklist model_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..backend.metrics import compute_cos_pairwise_eer
from ..kio import FeatureReader
from ..train.preemption import exit_code_if_preempted, install_preemption_handler
from ..train.trainer_mi import TrainerMultiInput
from ..utils import bookkeeping as bk
from . import _launch


def parse_aux_data(spec: str):
    """'name1:dir1;name2:dir2' -> {name: dir}."""
    out = {}
    for part in spec.split(";"):
        if not part:
            continue
        name, d = part.split(":", 1)
        out[name] = d
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--cont", action="store_true")
    parser.add_argument("--config", default=None)
    parser.add_argument("--aux_data", required=True, help='"name:dir;name2:dir2"')
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("train_dir")
    parser.add_argument("train_spklist")
    parser.add_argument("valid_dir")
    parser.add_argument("valid_spklist")
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)

    device = _launch.start(args.device)
    aux_data = parse_aux_data(args.aux_data)
    params = _launch.model_dir_params(args.cont, args.model_dir, args.config, device)
    nnet_dir = os.path.join(args.model_dir, "nnet")

    reader = FeatureReader(args.train_dir)
    dim = reader.dim
    reader.close()
    with open(args.train_spklist) as f:
        num_speakers = len(f.readlines())
    _launch.on_main(bk.write_scalar_file, os.path.join(nnet_dir, "feature_dim"), dim)
    _launch.on_main(bk.write_scalar_file, os.path.join(nnet_dir, "num_speakers"), num_speakers)

    trainer = TrainerMultiInput(params, nnet_dir, dim=dim, num_speakers=num_speakers,
                                device=device)
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
        _launch.on_main(bk.append_lr, lr_path, epoch, learning_rate)
        trainer.train(args.train_dir, args.train_spklist, learning_rate, aux_data=aux_data)
        rc = exit_code_if_preempted(trainer)
        if rc is not None:
            return rc
        valid_loss, embeddings, labels = trainer.valid(
            args.valid_dir, args.valid_spklist,
            batch_type=params.dict.get("batch_type", "softmax"),
            output_embeddings=True, aux_data=aux_data,
        )
        rc = exit_code_if_preempted(trainer)
        if rc is not None:
            # partial valid pass: not recorded (see cli/train.py)
            return rc
        eer = compute_cos_pairwise_eer(embeddings, labels) if len(labels) else 1.0
        logging.info("epoch %d: valid loss %f eer %.4f lr %g", epoch, valid_loss, eer, learning_rate)
        _launch.on_main(bk.append_valid_loss, valid_path, epoch, valid_loss, eer)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
