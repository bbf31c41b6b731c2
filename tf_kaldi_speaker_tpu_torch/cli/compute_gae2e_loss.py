"""Offline loss sanity check on dumped embeddings.

Counterpart of ``tf_kaldi_speaker_tpu/cli/compute_gae2e_loss.py``
(reference misc/tools/compute_gae2e_loss.py): load embeddings + labels and
evaluate the GE2E-style or angular-triplet loss outside training (useful to
compare checkpoints or sanity-check a batch composition), on ``--device``
(``cuda`` unless ``--device cpu``; raises without a card).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.compute_gae2e_loss \
        --loss e2e --num-segments 4 embeddings.scp utt2spk
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kio import read_vec_flt_scp
from ..losses import angular_triplet_loss, e2e_valid_loss
from ._frontend import device_or_raise


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--loss", choices=["e2e", "angular_triplet"], default="e2e")
    parser.add_argument("--num-segments", type=int, default=4)
    parser.add_argument("--margin", type=float, default=0.2)
    parser.add_argument("--loss-type", default="additive_margin_softmax")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("embeddings_scp")
    parser.add_argument("utt2spk")
    args = parser.parse_args(argv)
    device = device_or_raise(args.device)

    utt2spk = {}
    with open(args.utt2spk) as f:
        for line in f:
            u, s = line.split()[:2]
            utt2spk[u] = s
    by_spk = {}
    for key, vec in read_vec_flt_scp(args.embeddings_scp):
        by_spk.setdefault(utt2spk[key], []).append(np.asarray(vec, np.float32))

    # Speaker-major blocks of num_segments (GE2E layout).
    feats, labels = [], []
    keep = {s: v for s, v in by_spk.items() if len(v) >= args.num_segments}
    for i, (s, vs) in enumerate(sorted(keep.items())):
        feats.extend(vs[: args.num_segments])
        labels.extend([i] * args.num_segments)
    feats = torch.from_numpy(np.stack(feats)).to(device)
    labels = torch.from_numpy(np.asarray(labels, np.int32)).to(device)
    n_spk = len(keep)

    if args.loss == "e2e":
        loss, _ = e2e_valid_loss(feats, labels, n_spk, args.num_segments)
    else:
        loss, _ = angular_triplet_loss(
            feats, labels, args.margin, "all", args.loss_type
        )
    print("%s loss over %d speakers x %d segments: %f"
          % (args.loss, n_spk, args.num_segments, float(loss)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
