"""Pin the checkpoint pointer to best/last/step before extraction.

Counterpart of ``tf_kaldi_speaker_tpu/cli/make_checkpoint.py`` (reference
egs/voxceleb/v1/nnet/lib/make_checkpoint.py + misc/utils.py:217-270,
get_checkpoint): "-1" selects the best epoch by the ``valid_loss`` file;
"last" the newest; an integer a specific step. Only the ``checkpoint``
pointer file is rewritten; the port's ``.pt`` and the JAX package's
``.msgpack`` checkpoints both count. Nothing here touches a device.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.make_checkpoint [--checkpoint last] model_dir
"""

from __future__ import annotations

import argparse
import os
import sys

from ..train.checkpoints import select_checkpoint


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", default="last", help='"last", "-1" (best) or a step id')
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)
    nnet_dir = os.path.join(args.model_dir, "nnet")
    if not os.path.isdir(nnet_dir):
        nnet_dir = args.model_dir
    step = select_checkpoint(nnet_dir, args.checkpoint)
    print("checkpoint -> model-%d" % step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
