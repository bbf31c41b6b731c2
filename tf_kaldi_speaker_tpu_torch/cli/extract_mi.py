"""Multi-input embedding extraction: main ark + named aux arks -> x-vectors.

Counterpart of ``tf_kaldi_speaker_tpu/cli/extract_mi.py`` (reference
egs/voxceleb/v1/nnet/lib/extract_mi.py) with the same arguments, plus
``--device`` (default ``cuda``): aux rspecifiers passed as
"name:rspecifier;name2:rspecifier2", assumed key-aligned with the main
rspecifier (a stream out of sync skips the utterance with a warning), each
aux matrix cut to the main one's frames; utterances shorter than
``--min-chunk-size`` are skipped, ``--normalize`` L2-normalizes.
``--chunk-size`` is accepted and unused, as in the JAX CLI.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.extract_mi --aux_rspecifier \\
        "bnf:scp:bnf/feats.scp" [--device cuda] model_dir rspecifier wspecifier
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from ..kio import read_mat_rspec
from ..kio.ark import ArkScpWriter
from ..train.trainer_mi import TrainerMultiInput
from ..utils import bookkeeping as bk
from ..utils.params import Params
from ._frontend import device_or_raise


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--node", default="")
    parser.add_argument("--normalize", action="store_true")
    parser.add_argument("--min-chunk-size", type=int, default=25)
    parser.add_argument("--chunk-size", type=int, default=10000)
    parser.add_argument("--aux_rspecifier", required=True, help='"name:ark:...;..."')
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("model_dir")
    parser.add_argument("rspecifier")
    parser.add_argument("wspecifier")
    args = parser.parse_args(argv)

    device = device_or_raise(args.device)
    nnet_dir = os.path.join(args.model_dir, "nnet")
    params = Params(os.path.join(nnet_dir, "config.json"))
    if args.node:
        params.dict["embedding_node"] = args.node
    dim = bk.read_scalar_file(os.path.join(nnet_dir, "feature_dim"))
    num_speakers = bk.read_scalar_file(os.path.join(nnet_dir, "num_speakers"))

    trainer = TrainerMultiInput(params, nnet_dir, dim=dim, num_speakers=num_speakers,
                                device=device)
    trainer.build("train", dim, params.loss_func, num_speakers)
    trainer.load()
    trainer.build("predict", dim)

    # Open aux streams; assumed key-aligned with the main rspecifier.
    aux_iters = {}
    for part in args.aux_rspecifier.split(";"):
        if not part:
            continue
        name, rspec = part.split(":", 1)
        aux_iters[name] = read_mat_rspec(rspec)

    writer = ArkScpWriter(args.wspecifier, kind="vec")
    count = 0
    for key, feature in read_mat_rspec(args.rspecifier):
        aux = {}
        ok = True
        for name, it in aux_iters.items():
            akey, amat = next(it)
            if akey != key:
                logging.warning("aux stream %s out of sync: %s vs %s", name, akey, key)
                ok = False
                break
            aux[name] = amat[: feature.shape[0]].astype(np.float32)
        if not ok or feature.shape[0] < args.min_chunk_size:
            continue
        embedding = trainer.predict(feature.astype(np.float32), aux)
        if args.normalize:
            embedding = embedding / np.sqrt(np.sum(np.square(embedding)))
        writer.write(key, embedding.astype(np.float32))
        count += 1
    writer.close()
    logging.info("Extracted %d embeddings.", count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
