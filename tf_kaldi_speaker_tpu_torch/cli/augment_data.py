"""Offline dataset augmentation: reverb / noise / music / babble copies.

Counterpart of ``tf_kaldi_speaker_tpu/cli/augment_data.py`` with the same
arguments and outputs (the reference's MUSAN+RIRS stage,
egs/voxceleb/v1/run.sh:70-131): for each utterance make an augmented copy
with a suffix (-reverb/-noise/-music/-babble), writing new wavs + wav.scp +
utt2spk. Every random draw stays on the host, in the JAX CLI's order, so
the same seed picks the same sources, SNRs and offsets.

``--mode reverb`` convolves on ``--device`` (``cuda`` unless ``--device
cpu``): utterances are read in order, ``--batch-size`` at a time, and each
batch goes through one float64 FFT convolution (``reverberate_torch``).
Noise, music and babble are O(N) host passes whose draws depend on each
signal's length; they run the numpy copies.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.augment_data \
        --mode noise --aug-wav-scp musan_noise/wav.scp --snr 0:5:10:15 \
        data/train/wav.scp data/train/utt2spk out_dir
    (--mode reverb uses --aug-wav-scp as RIR list, no SNR)
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from ..data.augment import add_babble, add_noise, reverberate_torch
from ..kio.wav import read_wav, write_wav
from ._frontend import device_or_raise, pad_rows


def _mono(x: np.ndarray) -> np.ndarray:
    return x[:, 0] if x.ndim > 1 else x


def _reverb_batch(batch: List[Tuple[str, np.ndarray, int, np.ndarray]],
                  device: torch.device) -> List[np.ndarray]:
    """[(path, signal, rate, rir)] -> the reverberated signals, each at its
    own length, convolved in one call on ``device``."""
    sigs, sig_lens = pad_rows([b[1] for b in batch], np.float64)
    rirs, rir_lens = pad_rows([b[3] for b in batch], np.float64)
    out = reverberate_torch(
        torch.from_numpy(sigs).to(device), torch.from_numpy(sig_lens),
        torch.from_numpy(rirs).to(device), torch.from_numpy(rir_lens)).cpu().numpy()
    return [out[i, :n] for i, n in enumerate(sig_lens)]


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=["reverb", "noise", "music", "babble"], required=True)
    parser.add_argument("--aug-wav-scp", required=True, help="RIRs or noise sources")
    parser.add_argument("--snr", default="0:5:10:15", help="colon-separated SNR choices (dB)")
    parser.add_argument("--num-babble", type=int, default=4)
    parser.add_argument(
        "--num-babble-choices", default="",
        help="colon-separated babble source counts to sample from "
             "(reference --num-bg-noises 3:4:5:6:7); overrides --num-babble",
    )
    parser.add_argument(
        "--keep-frac", type=float, default=1.0,
        help="augment a random fraction of the input list (the reference "
             "subsamples the combined augmented list to ~1M of 4M, "
             "run.sh:120); applied per utterance with the CLI seed",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="where --mode reverb convolves (default cuda; every mode raises "
                             "without a card unless cpu)")
    parser.add_argument("--batch-size", type=int, default=64,
                        help="utterances per reverb convolution batch")
    parser.add_argument("wav_scp")
    parser.add_argument("utt2spk")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)
    device = device_or_raise(args.device)

    rng = np.random.RandomState(args.seed)
    snrs = [float(s) for s in args.snr.split(":") if s]
    suffix = "-" + args.mode

    aug_entries = []
    with open(args.aug_wav_scp) as f:
        for line in f:
            utt, rx = line.strip().split(" ", 1)
            aug_entries.append(rx)
    assert aug_entries, "empty --aug-wav-scp"

    def source(index: int) -> np.ndarray:
        return _mono(read_wav(aug_entries[index])[0])

    utt2spk = {}
    with open(args.utt2spk) as f:
        for line in f:
            u, s = line.split()[:2]
            utt2spk[u] = s

    wav_dir = os.path.join(args.out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    scp_lines, u2s_lines = [], []
    pending: List[Tuple[str, np.ndarray, int, np.ndarray]] = []
    audio_s, conv_s = 0.0, 0.0

    def flush() -> None:
        nonlocal conv_s
        t0 = time.perf_counter()
        outs = _reverb_batch(pending, device)
        conv_s += time.perf_counter() - t0
        for (path, _, rate, _), out in zip(pending, outs):
            write_wav(path, out, rate)
        pending.clear()

    babble_counts = [int(x) for x in args.num_babble_choices.split(":") if x]
    with open(args.wav_scp) as f:
        for line in f:
            utt, rx = line.strip().split(" ", 1)
            if args.keep_frac < 1.0 and rng.random_sample() >= args.keep_frac:
                continue
            sig, rate = read_wav(rx)
            sig = _mono(sig)
            audio_s += len(sig) / rate
            new_utt = utt + suffix
            path = os.path.join(wav_dir, new_utt + ".wav")
            if args.mode == "reverb":
                pending.append((path, sig, rate, source(rng.randint(len(aug_entries)))))
                if len(pending) == args.batch_size:
                    flush()
            else:
                if args.mode == "babble":
                    n_bab = (
                        int(rng.choice(babble_counts)) if babble_counts else args.num_babble
                    )
                    srcs = [source(rng.randint(len(aug_entries))) for _ in range(n_bab)]
                    out = add_babble(sig, srcs, snr_db=float(rng.choice(snrs)), rng=rng)
                else:  # noise / music: single source at a sampled SNR
                    s = source(rng.randint(len(aug_entries)))
                    out = add_noise(sig, s, snr_db=float(rng.choice(snrs)), rng=rng)
                write_wav(path, out, rate)
            scp_lines.append("%s %s" % (new_utt, path))
            u2s_lines.append("%s %s" % (new_utt, utt2spk.get(utt, utt)))
    if pending:
        flush()
    with open(os.path.join(args.out_dir, "wav.scp"), "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    with open(os.path.join(args.out_dir, "utt2spk"), "w") as f:
        f.write("\n".join(u2s_lines) + "\n")
    logging.info("Augmented %d utterances (%s).", len(scp_lines), args.mode)
    if args.mode == "reverb":
        logging.info("reverb: %.3f s of audio, %.6f s in the convolutions on %s "
                     "(copies in and out included)", audio_s, conv_s, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
