"""Phone-frame sampling for the multitask phone loss.

A copy of ``tf_kaldi_speaker_tpu/multitask/common.py`` (reference
model/multitask_v1/common.py, ``make_phone_masks``): random frame indices
per utterance, sampled without replacement within each utterance's valid
length, as a rectangular [B, K] index array (K = ``num_frames_per_utt``).
With ``num_frames_per_utt == -1`` callers use all frames with a validity
mask instead of explicit indices. The draws from the caller's
``RandomState`` are the JAX package's, call for call.
"""

from __future__ import annotations

import numpy as np


def make_phone_masks(
    length: np.ndarray, resample: np.ndarray, num_frames_per_utt: int,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """[B, K] frame indices, each row sampled without replacement in
    [0, length[i]). ``resample`` is accepted for parity but unused — the
    reference's active branch always samples randomly (common.py:43-55)."""
    assert num_frames_per_utt > 0, "use a validity mask for -1 (all frames)"
    rng = rng or np.random
    b = length.shape[0]
    out = np.zeros((b, num_frames_per_utt), dtype=np.int32)
    for i in range(b):
        n = int(length[i])
        if n >= num_frames_per_utt:
            out[i] = rng.choice(n, size=num_frames_per_utt, replace=False)
        else:
            out[i] = rng.choice(max(n, 1), size=num_frames_per_utt, replace=True)
    return out
