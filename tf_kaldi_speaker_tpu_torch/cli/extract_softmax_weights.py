"""Dump the softmax weight matrix (class centers) for inspection/t-SNE.

Counterpart of ``tf_kaldi_speaker_tpu/cli/extract_softmax_weights.py``
(behavioral spec: reference
egs/voxceleb/v1/nnet/lib/extract_softmax_weights.py): write the
``output/kernel`` columns (one vector per speaker) to an ark. It reads the
port's ``.pt`` or the JAX package's ``.msgpack`` on the host.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.extract_softmax_weights model_dir out.ark
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..kio import open_or_fd, write_vec_flt
from ..train import checkpoints


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("model_dir")
    parser.add_argument("wspecifier")
    args = parser.parse_args(argv)

    nnet_dir = os.path.join(args.model_dir, "nnet")
    if not os.path.isdir(nnet_dir):
        nnet_dir = args.model_dir
    raw, step = checkpoints.load_checkpoint(nnet_dir)
    kernel = raw["params"]["softmax"]["output_kernel"].float().numpy()  # [D, C]
    fp = open_or_fd(args.wspecifier, "wb")
    for c in range(kernel.shape[1]):
        write_vec_flt(fp, kernel[:, c].astype(np.float32), key="class%05d" % c)
    fp.close()
    print("Wrote %d class weight vectors (step %d)" % (kernel.shape[1], step))
    return 0


if __name__ == "__main__":
    sys.exit(main())
