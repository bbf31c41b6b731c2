"""Training-egs feature prep: sliding CMVN + silence removal -> compressed arks.

Counterpart of ``tf_kaldi_speaker_tpu/cli/prepare_feats.py`` with the same
flags and outputs, plus ``--device`` (default ``cuda``). Features are read
on the host and taken ``BATCH_SIZE`` at a time in input order; sliding
CMVN (``ops.cmvn.sliding_cmvn_masked``, in float64 as numpy takes it) and
voiced-frame selection run on the device; compression stays on the host.
With --keep-silence no frame is dropped (multitask egs); with --no-cmvn
only silence is removed (bottleneck features).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.prepare_feats [--cmn-window 300] \
        [--keep-silence] [--no-cmvn] [--device cuda] data_dir out_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

import numpy as np
import torch

from ..kio import ark, read_mat_scp, read_vec_flt_scp
from ..ops.cmvn import sliding_cmvn_masked
from ._frontend import batches, device_or_raise, pad_rows

BATCH_SIZE = 64


def prep_batch(batch, device: torch.device, cmvn: bool, cmn_window: int):
    """[(utt, feats [T, D], vad [T] or None)] -> the float32 features after
    CMVN (if ``cmvn``) and voiced-frame selection (where a vad is given),
    computed on ``device``."""
    feats, lengths = pad_rows([m for _, m, _ in batch], np.float64)
    x = torch.from_numpy(feats).to(device)
    if cmvn:
        x = sliding_cmvn_masked(x, torch.from_numpy(lengths), window=cmn_window)
    keep = np.arange(feats.shape[1])[None, :] < lengths[:, None]
    for b, (_, _, vad) in enumerate(batch):
        if vad is not None:
            keep[b, :lengths[b]] &= np.asarray(vad) > 0.5
    keep_d = torch.from_numpy(keep).to(device)
    kept = x.to(torch.float32)[keep_d].cpu().numpy()
    counts = keep.sum(axis=1)
    return np.split(kept, np.cumsum(counts)[:-1])


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--cmn-window", type=int, default=300)
    parser.add_argument("--keep-silence", action="store_true")
    parser.add_argument("--no-cmvn", action="store_true",
                        help="skip sliding CMVN (bottleneck-feature prep)")
    parser.add_argument("--no-compress", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("data_dir")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)

    device = device_or_raise(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    vad = {}
    if not args.keep_silence:
        vad = dict(read_vec_flt_scp(os.path.join(args.data_dir, "vad.scp")))
    skipped = 0

    def items():
        nonlocal skipped
        for utt, feats in read_mat_scp(os.path.join(args.data_dir, "feats.scp")):
            if args.keep_silence:
                yield utt, feats, None
            elif utt not in vad:
                skipped += 1
            else:
                if feats.shape[0] != vad[utt].shape[0]:
                    raise ValueError("%s: features/vad length mismatch" % utt)
                yield utt, feats, vad[utt]

    ark_path = os.path.join(args.out_dir, "feats.ark")
    scp_lines, u2nf = [], []
    with open(ark_path, "wb") as f:
        for batch in batches(items(), BATCH_SIZE):
            out = prep_batch(batch, device, not args.no_cmvn, args.cmn_window)
            for (utt, _, _), feats in zip(batch, out):
                if feats.shape[0] == 0:
                    skipped += 1
                    continue
                pos = f.tell() + len(utt) + 1
                ark.write_mat(f, feats, key=utt, compress=not args.no_compress)
                scp_lines.append("%s %s:%d" % (utt, ark_path, pos))
                u2nf.append("%s %d" % (utt, feats.shape[0]))
    with open(os.path.join(args.out_dir, "feats.scp"), "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    with open(os.path.join(args.out_dir, "utt2num_frames"), "w") as f:
        f.write("\n".join(u2nf) + "\n")
    # carry over speaker maps
    for name in ("spk2utt", "utt2spk"):
        src = os.path.join(args.data_dir, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(args.out_dir, name))
    logging.info("Prepared %d utterances (%d skipped).", len(scp_lines), skipped)
    return 0


if __name__ == "__main__":
    sys.exit(main())
