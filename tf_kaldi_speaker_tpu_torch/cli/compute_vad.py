"""Energy VAD CLI: feats.scp -> vad.ark/scp.

Counterpart of ``tf_kaldi_speaker_tpu/cli/compute_vad.py`` with the same
arguments and outputs, plus ``--device`` (default ``cuda``). Features are
read on the host and taken ``BATCH_SIZE`` at a time in input order; the
decisions are computed on the device by ``ops.vad.compute_vad_energy_masked``
in float64, as the numpy VAD takes its mean log-energy in float64.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.compute_vad [--vad-energy-threshold 5.5] \
        [--vad-energy-mean-scale 0.5] [--device cuda] feats_scp out_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from ..kio import ark, read_mat_scp
from ..ops.vad import compute_vad_energy_masked
from ._frontend import batches, device_or_raise, pad_rows

BATCH_SIZE = 64


def vad_batch(batch, device: torch.device, **kw):
    """[(utt, feats [T, D])] -> float32 0/1 decisions [T] each, computed
    on ``device`` in float64 from the log-energy column."""
    energy, lengths = pad_rows([np.asarray(m[:, :1], np.float64) for _, m in batch], np.float64)
    voiced = compute_vad_energy_masked(torch.from_numpy(energy).to(device),
                                       torch.from_numpy(lengths), **kw)
    voiced = voiced.to(torch.float32).cpu().numpy()
    return [voiced[b, :n] for b, n in enumerate(lengths)]


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--vad-energy-threshold", type=float, default=5.5)
    parser.add_argument("--vad-energy-mean-scale", type=float, default=0.5)
    parser.add_argument("--vad-frames-context", type=int, default=0)
    parser.add_argument("--vad-proportion-threshold", type=float, default=0.6)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("feats_scp")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)

    device = device_or_raise(args.device)
    kw = dict(energy_threshold=args.vad_energy_threshold,
              energy_mean_scale=args.vad_energy_mean_scale,
              frames_context=args.vad_frames_context,
              proportion_threshold=args.vad_proportion_threshold)
    os.makedirs(args.out_dir, exist_ok=True)
    ark_path = os.path.join(args.out_dir, "vad.ark")
    scp_lines = []
    with open(ark_path, "wb") as f:
        for batch in batches(read_mat_scp(args.feats_scp), BATCH_SIZE):
            for (utt, _), vad in zip(batch, vad_batch(batch, device, **kw)):
                pos = f.tell() + len(utt) + 1
                ark.write_vec_flt(f, vad, key=utt)
                scp_lines.append("%s %s:%d" % (utt, ark_path, pos))
    with open(os.path.join(args.out_dir, "vad.scp"), "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    logging.info("Computed VAD for %d utterances.", len(scp_lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
