"""Synthetic Kaldi data-directory generator for tests and smoke runs.

A copy of ``make_fake_data_dir`` from ``tf_kaldi_speaker_tpu/utils/testdata.py``
for the port's own codec: feats.scp/ark (compressed or not),
utt2num_frames, spk2utt, utt2spk and a spklist, byte for byte what the JAX
package writes with the same arguments (``tests/test_torch_pool.py``). The
VAD and alignment files of the multitask path are not copied: that path is
not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..kio import ark


def make_fake_data_dir(
    path: str,
    num_speakers: int = 5,
    utts_per_speaker: int = 4,
    dim: int = 24,
    min_len: int = 220,
    max_len: int = 480,
    compress: bool = True,
    seed: int = 0,
    spk_offset: int = 0,
    spk_scale: float = 2.0,
    chan_scale: float = 0.0,
) -> Dict[str, str]:
    """Create a synthetic Kaldi data dir; returns important file paths.

    Features for speaker s are drawn from N(mu_s + c_u, I): a per-speaker
    mean (scaled by ``spk_scale``) plus an optional per-utterance channel
    offset (``chan_scale``); utterance lengths are uniform in
    [min_len, max_len]."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    ark_path = os.path.join(path, "feats.ark")
    spk_means = rng.randn(num_speakers, dim) * spk_scale
    scp, u2nf, spk2utt, utt2spk = [], [], [], []
    with open(ark_path, "wb") as f:
        for s in range(num_speakers):
            spk = "spk%03d" % (s + spk_offset)
            utts = []
            for u in range(utts_per_speaker):
                utt = "%s_utt%03d" % (spk, u)
                n = int(rng.randint(min_len, max_len + 1))
                chan = rng.randn(dim) * chan_scale if chan_scale else 0.0
                feats = (spk_means[s] + chan + rng.randn(n, dim)).astype(np.float32)
                pos = f.tell() + len(utt) + 1
                ark.write_mat(f, feats, key=utt, compress=compress)
                scp.append("%s %s:%d" % (utt, ark_path, pos))
                u2nf.append("%s %d" % (utt, n))
                utts.append(utt)
                utt2spk.append("%s %s" % (utt, spk))
            spk2utt.append("%s %s" % (spk, " ".join(utts)))

    def _write(name, lines):
        p = os.path.join(path, name)
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        return p

    return {
        "data": path,
        "feats_scp": _write("feats.scp", scp),
        "utt2num_frames": _write("utt2num_frames", u2nf),
        "spk2utt": _write("spk2utt", spk2utt),
        "utt2spk": _write("utt2spk", utt2spk),
        "spklist": _write(
            "spklist",
            ["spk%03d %d" % (s + spk_offset, s) for s in range(num_speakers)],
        ),
    }
