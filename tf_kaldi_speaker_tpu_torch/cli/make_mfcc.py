"""MFCC extraction CLI: wav.scp -> feats.ark/scp + utt2num_frames.

Counterpart of ``tf_kaldi_speaker_tpu/cli/make_mfcc.py`` with the same
arguments and outputs, plus ``--device`` (default ``cuda``) and
``--batch-size``. Wavs are read on the host and taken ``--batch-size`` at
a time in input order; each batch is computed on the device by
``ops.mfcc.mfcc_torch`` in float64 and cast to float32, as the JAX CLI
computes in numpy float64. Utterance
``count`` (the ``count``-th one written) is dithered with
``np.random.RandomState(count).randn(F, n)``, drawn on the host exactly as
the JAX CLI draws it; skipped utterances (wrong rate, too short) do not
advance ``count``. The last log line gives the host's seconds spent
reading the wavs and drawing the dither.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.make_mfcc [--sample-rate 16000] \
        [--num-ceps 30] [--num-mel-bins 30] [--low-freq 20] [--high-freq 7600] \
        [--compress] [--device cuda] [--batch-size 32] wav_scp out_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from ..kio import ark, read_wav_scp
from ..ops.mfcc import MfccConfig, mfcc_torch, num_frames
from ._frontend import batches, device_or_raise, pad_rows


def _utterances(wav_scp: str, cfg: MfccConfig, host: dict):
    """(utt, samples, seed) of every utterance that gets features, in
    wav.scp order; the seed counts the utterances before it that did.
    Adds the seconds spent reading to ``host["read"]``."""
    count = 0
    wavs = iter(read_wav_scp(wav_scp))
    while True:
        t0 = time.perf_counter()
        item = next(wavs, None)
        host["read"] += time.perf_counter() - t0
        if item is None:
            return
        utt, samples, rate = item
        if rate != cfg.sample_rate:
            logging.warning("%s: rate %d != %d, skip", utt, rate, cfg.sample_rate)
            continue
        if samples.ndim > 1:
            samples = samples[:, 0]
        if num_frames(samples.shape[0], cfg) == 0:
            logging.warning("%s: too short, skip", utt)
            continue
        yield utt, samples, count
        count += 1


def mfcc_batch(batch, cfg: MfccConfig, device: torch.device, host: dict):
    """[(utt, samples, seed)] -> their float32 MFCC matrices, computed on
    ``device`` in float64. Adds the seconds spent drawing the dither to
    ``host["dither"]``."""
    wavs, lengths = pad_rows([s for _, s, _ in batch], np.float64)
    noise = None
    if cfg.dither > 0:
        t0 = time.perf_counter()
        noise = [np.random.RandomState(seed).randn(num_frames(s.shape[0], cfg),
                                                   cfg.frame_length)
                 for _, s, seed in batch]
        host["dither"] += time.perf_counter() - t0
    feats, counts = mfcc_torch(torch.from_numpy(wavs).to(device), torch.from_numpy(lengths),
                               cfg, noise)
    feats = feats.to(torch.float32).cpu().numpy()
    return [feats[b, :c] for b, c in enumerate(counts.tolist())]


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--num-ceps", type=int, default=30)
    parser.add_argument("--num-mel-bins", type=int, default=30)
    parser.add_argument("--low-freq", type=float, default=20.0)
    parser.add_argument("--high-freq", type=float, default=7600.0)
    parser.add_argument("--frame-length", type=float, default=25.0)
    parser.add_argument("--frame-shift", type=float, default=10.0)
    parser.add_argument("--dither", type=float, default=1.0)
    parser.add_argument("--compress", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("wav_scp")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)

    device = device_or_raise(args.device)
    cfg = MfccConfig(
        sample_rate=args.sample_rate,
        num_ceps=args.num_ceps,
        num_mel_bins=args.num_mel_bins,
        low_freq=args.low_freq,
        high_freq=args.high_freq,
        frame_length_ms=args.frame_length,
        frame_shift_ms=args.frame_shift,
        dither=args.dither,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    ark_path = os.path.join(args.out_dir, "feats.ark")
    scp_lines, u2nf = [], []
    host = dict(read=0.0, dither=0.0)
    with open(ark_path, "wb") as f:
        for batch in batches(_utterances(args.wav_scp, cfg, host), args.batch_size):
            for (utt, _, _), feats in zip(batch, mfcc_batch(batch, cfg, device, host)):
                pos = f.tell() + len(utt) + 1
                ark.write_mat(f, feats, key=utt, compress=args.compress)
                scp_lines.append("%s %s:%d" % (utt, ark_path, pos))
                u2nf.append("%s %d" % (utt, feats.shape[0]))
    with open(os.path.join(args.out_dir, "feats.scp"), "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    with open(os.path.join(args.out_dir, "utt2num_frames"), "w") as f:
        f.write("\n".join(u2nf) + "\n")
    logging.info("Extracted MFCC for %d utterances.", len(scp_lines))
    logging.info("host seconds: reading the wavs %.6f, drawing the dither %.6f",
                 host["read"], host["dither"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
