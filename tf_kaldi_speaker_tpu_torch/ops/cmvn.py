"""Sliding-window cepstral mean (and variance) normalization.

Counterpart of ``tf_kaldi_speaker_tpu/ops/cmvn.py``, which replaces Kaldi's
``apply-cmvn-sliding`` (``--norm-vars=false --center=true``): a window of
``window`` frames centred on each frame, shifted inward at the utterance's
edges so that it always holds min(window, T) frames.

``_window_bounds`` and ``sliding_cmvn`` are the numpy code of the JAX
package, copied (``tests/test_torch_frontend.py`` holds them bit-equal);
``sliding_cmvn_masked`` is the counterpart of ``sliding_cmvn_jax_masked``,
over a padded batch on any device.
"""

from __future__ import annotations

import numpy as np
import torch


def _window_bounds(t: np.ndarray, num_frames: int, window: int, center: bool):
    if center:
        start = t - window // 2
    else:
        start = t - window + 1
    end = start + window
    # Shift inward at the edges (Kaldi SlidingWindowCmnInternal).
    shift_left = np.maximum(-start, 0)
    start = start + shift_left
    end = end + shift_left
    shift_right = np.maximum(end - num_frames, 0)
    start = np.maximum(start - shift_right, 0)
    end = end - shift_right
    return start, end


def sliding_cmvn(
    feats: np.ndarray,
    window: int = 300,
    center: bool = True,
    norm_vars: bool = False,
) -> np.ndarray:
    """Numpy sliding CMVN over [T, D] features. O(T·D) via cumulative sums."""
    feats = np.asarray(feats, dtype=np.float64)
    T = feats.shape[0]
    t = np.arange(T)
    start, end = _window_bounds(t, T, window, center)
    csum = np.concatenate([np.zeros((1, feats.shape[1])), np.cumsum(feats, axis=0)], 0)
    counts = (end - start).astype(np.float64)[:, None]
    mean = (csum[end] - csum[start]) / counts
    out = feats - mean
    if norm_vars:
        csq = np.concatenate(
            [np.zeros((1, feats.shape[1])), np.cumsum(feats**2, axis=0)], 0
        )
        var = (csq[end] - csq[start]) / counts - mean**2
        out = out / np.sqrt(np.maximum(var, 1e-10))
    return out.astype(np.float32)


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
