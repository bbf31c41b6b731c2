"""Multitask speaker-embedding extraction (ark -> x-vector ark).

Counterpart of ``tf_kaldi_speaker_tpu/cli/extract_mt.py`` (reference
egs/voxceleb/v1/nnet/lib/extract_mt.py) with the same arguments, plus
``--device`` (default ``cuda``; without a card it raises): the speaker
embedding (``--node``, default the config's ``embedding_node``) of the
multitask model in float32; the input features are UN-expanded and the
edge frames are tiled for the phone context (kaldi_io.py:286-294).
Utterances shorter than ``--min-chunk-size`` are skipped; longer than
``--chunk-size`` are cut in 50%-overlapping chunks whose embeddings are
averaged by length; ``--normalize`` L2-normalizes.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.extract_mt [--node zs_mu_dense] \\
        [--device cuda] model_dir rspecifier wspecifier
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from ..kio import read_mat_rspec
from ..kio.ark import ArkScpWriter
from ..multitask import TrainerMultiTask
from ..utils import bookkeeping as bk
from ..utils.params import Params
from ._frontend import device_or_raise


def load_mt_trainer(model_dir: str, node: str = "", device="cuda") -> TrainerMultiTask:
    """The multitask trainer of ``model_dir`` in its last checkpoint's
    state, on ``device``."""
    device = device_or_raise(device)
    nnet_dir = os.path.join(model_dir, "nnet")
    params = Params(os.path.join(nnet_dir, "config.json"))
    if node:
        params.dict["embedding_node"] = node
    dim = bk.read_scalar_file(os.path.join(nnet_dir, "feature_dim"))
    num_speakers = bk.read_scalar_file(os.path.join(nnet_dir, "num_speakers"))
    num_phones = bk.read_scalar_file(os.path.join(nnet_dir, "num_phones"))
    trainer = TrainerMultiTask(params, nnet_dir, dim=dim, num_speakers=num_speakers,
                               num_phones=num_phones, device=device)
    trainer.build("train", dim, num_speakers=num_speakers, num_phones=num_phones)
    trainer.load()
    trainer.build("predict", dim)
    return trainer


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--node", default="")
    parser.add_argument("--normalize", action="store_true")
    parser.add_argument("--min-chunk-size", type=int, default=25)
    parser.add_argument("--chunk-size", type=int, default=10000)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("model_dir")
    parser.add_argument("rspecifier")
    parser.add_argument("wspecifier")
    args = parser.parse_args(argv)

    trainer = load_mt_trainer(args.model_dir, args.node, args.device)
    writer = ArkScpWriter(args.wspecifier, kind="vec")
    count = 0
    for key, feature in read_mat_rspec(args.rspecifier):
        T = feature.shape[0]
        if T < args.min_chunk_size:
            logging.info("Key %s too short (%d), skip.", key, T)
            continue
        if T > args.chunk_size:
            # 50%-overlap chunking + length-weighted average (extract.py:69-87).
            half = args.chunk_size // 2
            num_chunks = int(np.ceil(float(T - args.chunk_size) / half)) + 1
            embs, lens = [], []
            for i in range(num_chunks):
                start = i * half
                n = args.chunk_size if T - start > args.chunk_size else T - start
                embs.append(trainer.predict_speaker(feature[start : start + n].astype(np.float32)))
                lens.append(n)
            embs = np.stack(embs)
            lens = np.asarray(lens, np.float64)[:, None]
            embedding = np.sum(embs * lens, axis=0) / np.sum(lens)
        else:
            embedding = trainer.predict_speaker(feature.astype(np.float32))
        if args.normalize:
            embedding = embedding / np.sqrt(np.sum(np.square(embedding)))
        writer.write(key, embedding.astype(np.float32))
        count += 1
    writer.close()
    logging.info("Extracted %d embeddings.", count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
