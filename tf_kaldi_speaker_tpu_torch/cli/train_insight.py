"""Debug CLI: evaluate the valid loss and cosine EER of a trained model.

Counterpart of ``tf_kaldi_speaker_tpu/cli/train_insight.py`` with the same
arguments, plus ``--device`` (behavioral spec: reference
egs/voxceleb/v1/nnet/lib/train_insight.py + trainer.insight,
trainer.py:821-928): poke a trained model with the valid set and report
the loss and the cosine EER (without the pdb breakpoints).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.train_insight [--device cuda] \\
        valid_dir valid_spklist model_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..backend.metrics import compute_cos_pairwise_eer
from ..train.trainer import Trainer
from ..utils import bookkeeping as bk
from ..utils.params import Params
from ._frontend import device_or_raise


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("valid_dir")
    parser.add_argument("valid_spklist")
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)
    device = device_or_raise(args.device)

    nnet_dir = os.path.join(args.model_dir, "nnet")
    params = Params(os.path.join(nnet_dir, "config.json"))
    dim = bk.read_scalar_file(os.path.join(nnet_dir, "feature_dim"))
    num_speakers = bk.read_scalar_file(os.path.join(nnet_dir, "num_speakers"))

    trainer = Trainer(params, nnet_dir, dim=dim, num_speakers=num_speakers, device=device)
    trainer.build("train", dim, params.loss_func, num_speakers)
    trainer.build("valid", dim, params.loss_func, num_speakers)
    step = trainer.load()
    logging.info("Loaded step %d", step)

    valid_loss, embeddings, labels = trainer.valid(
        args.valid_dir, args.valid_spklist,
        batch_type=params.dict.get("batch_type", "softmax"), output_embeddings=True,
    )
    eer = compute_cos_pairwise_eer(embeddings, labels) if len(labels) else float("nan")
    print("valid_loss %f eer %.4f (%d embeddings)" % (valid_loss, eer, len(labels)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
