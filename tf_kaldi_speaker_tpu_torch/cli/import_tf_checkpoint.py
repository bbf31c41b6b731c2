"""Import a reference (tf-kaldi-speaker) TF checkpoint into a model dir.

Counterpart of ``tf_kaldi_speaker_tpu/cli/import_tf_checkpoint.py`` with
the same arguments, plus ``--device``.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.import_tf_checkpoint \\
        --config config.json --feature-dim 30 --num-speakers 7323 \\
        [--device cuda] /path/to/tf/model-120000 out_model_dir

The TF checkpoint prefix must have .index and .data-* files next to it.
The result is a step-0 checkpoint (``model-0.pt``) in <out>/nnet with
``config.json``, ``feature_dim`` and ``num_speakers``, ready for
``cli.extract``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from ..train.tf_import import import_reference_checkpoint
from ..train.trainer import Trainer
from ..utils import bookkeeping as bk
from ..utils.params import Params
from ._frontend import device_or_raise


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="the model's nnet_conf JSON")
    parser.add_argument("--feature-dim", type=int, required=True)
    parser.add_argument("--num-speakers", type=int, required=True)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("tf_prefix")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)
    device = device_or_raise(args.device)

    params = Params(args.config)
    nnet_dir = os.path.join(args.out_dir, "nnet")
    trainer = Trainer(params, nnet_dir, dim=args.feature_dim,
                      num_speakers=args.num_speakers, device=device)
    trainer.build("train", args.feature_dim,
                  params.dict.get("loss_func", "softmax"), args.num_speakers)
    imported, skipped = import_reference_checkpoint(args.tf_prefix, trainer)
    trainer.save(0)
    with open(os.path.join(nnet_dir, "config.json"), "w") as f:
        json.dump(params.dict, f, indent=2)
    bk.write_scalar_file(os.path.join(nnet_dir, "feature_dim"), args.feature_dim)
    bk.write_scalar_file(os.path.join(nnet_dir, "num_speakers"), args.num_speakers)
    print("Imported %d tensors (%d skipped) -> %s" % (len(imported), len(skipped), nnet_dir))
    if not imported:
        print("WARNING: nothing imported — check the checkpoint prefix/config.",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
