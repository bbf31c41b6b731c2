"""Sliding-window cepstral mean normalization over a padded batch.

Counterpart of ``sliding_cmvn_jax_masked`` (``tf_kaldi_speaker_tpu/ops/
cmvn.py:89-122``), which replaces Kaldi's ``apply-cmvn-sliding``
(``--norm-vars=false --center=true``): a window of ``window`` frames
centred on each frame, shifted inward at the utterance's edges so that it
always holds min(window, T) frames.
"""

from __future__ import annotations

import torch


def sliding_cmvn_masked(
    feats: torch.Tensor, lengths: torch.Tensor, window: int = 300, center: bool = True
) -> torch.Tensor:
    """Mean-only sliding CMVN of [B, T, D] with per-row valid lengths [B].

    Row b is normalized on its first ``lengths[b]`` frames (window edges
    shift against lengths[b], not T). Frames at t >= lengths[b] must be zero
    on input; their output is garbage and must stay masked downstream."""
    b, T, d = feats.shape
    t = torch.arange(T, dtype=torch.int64, device=feats.device)[None, :]
    n = lengths.to(device=feats.device, dtype=torch.int64)[:, None]
    start = (t - window // 2) if center else (t - window + 1)
    start = start.expand(b, T)
    end = start + window
    shift_left = torch.clamp_min(-start, 0)
    start = start + shift_left
    end = end + shift_left
    shift_right = torch.clamp_min(end - n, 0)
    start = torch.clamp_min(start - shift_right, 0)
    end = end - shift_right
    # Padding rows (n == 0) and frames t >= n give degenerate windows; clamp
    # so the division is finite (the result is masked out anyway).
    end = torch.minimum(torch.clamp_min(end, 0), torch.clamp_min(n, 1))
    counts = torch.clamp_min(end - start, 1).to(feats.dtype)
    csum = torch.cat([feats.new_zeros((b, 1, d)), torch.cumsum(feats, dim=1)], dim=1)
    hi = torch.gather(csum, 1, end[:, :, None].expand(b, T, d))
    lo = torch.gather(csum, 1, start[:, :, None].expand(b, T, d))
    return feats - (hi - lo) / counts[:, :, None]
