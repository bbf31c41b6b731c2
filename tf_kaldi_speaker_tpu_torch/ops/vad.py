"""Energy voice-activity detection and voiced-frame selection.

Counterpart of ``tf_kaldi_speaker_tpu/ops/vad.py``, which replaces Kaldi's
``compute-vad`` and ``select-voiced-frames``: frame t is voiced when
``log_energy(t) > threshold + mean_scale * mean(log_energy)``, with
optional voting over +-``frames_context`` frames. Log-energy is feature
column 0 (MFCC C0).

``compute_vad_energy`` and ``select_voiced_frames`` are the numpy code of
the JAX package, copied (``tests/test_torch_frontend.py`` holds them
bit-equal); ``compute_vad_energy_masked`` is the counterpart of
``compute_vad_energy_jax``, over a padded batch on any device.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_vad_energy(
    feats: np.ndarray,
    energy_threshold: float = 5.5,
    energy_mean_scale: float = 0.5,
    frames_context: int = 0,
    proportion_threshold: float = 0.6,
) -> np.ndarray:
    """Energy VAD over [T, D] features; returns float32 0/1 decisions [T]."""
    log_energy = np.asarray(feats, dtype=np.float64)[:, 0]
    T = log_energy.shape[0]
    cutoff = energy_threshold
    if energy_mean_scale != 0.0:
        cutoff = energy_threshold + energy_mean_scale * log_energy.sum() / T
    pass_mask = (log_energy > cutoff).astype(np.float64)
    if frames_context <= 0:
        return pass_mask.astype(np.float32)
    # Context voting: fraction of passing frames in [t-ctx, t+ctx].
    csum = np.concatenate([[0.0], np.cumsum(pass_mask)])
    t = np.arange(T)
    lo = np.maximum(t - frames_context, 0)
    hi = np.minimum(t + frames_context + 1, T)
    frac = (csum[hi] - csum[lo]) / (hi - lo)
    return (frac >= proportion_threshold).astype(np.float32)


def select_voiced_frames(feats: np.ndarray, vad: np.ndarray) -> np.ndarray:
    """Keep rows whose VAD decision is nonzero (select-voiced-frames)."""
    vad = np.asarray(vad)
    assert feats.shape[0] == vad.shape[0], "features/vad length mismatch"
    return feats[vad > 0.5]


def compute_vad_energy_masked(
    feats: torch.Tensor,
    lengths: torch.Tensor,
    energy_threshold: float = 5.5,
    energy_mean_scale: float = 0.5,
    frames_context: int = 0,
    proportion_threshold: float = 0.6,
) -> torch.Tensor:
    """Bool decisions [B, T] for [B, T, D] features with valid lengths [B]
    (False beyond lengths). The cutoff uses the mean log-energy of the
    valid frames only, in the features' dtype (float64 features reproduce
    :func:`compute_vad_energy`'s float64 cutoff); padding frames must be
    zero on input."""
    e = feats[:, :, 0]
    b, T = e.shape
    t = torch.arange(T, dtype=torch.int64, device=feats.device)[None, :]
    n = lengths.to(device=feats.device, dtype=torch.int64)[:, None]
    valid = t < n
    cutoff = torch.tensor(energy_threshold, dtype=e.dtype, device=feats.device)
    if energy_mean_scale != 0.0:
        mean_e = torch.sum(torch.where(valid, e, 0.0), dim=1) / torch.clamp_min(
            n[:, 0], 1).to(e.dtype)
        cutoff = cutoff + energy_mean_scale * mean_e[:, None]
    pass_mask = (e > cutoff) & valid
    if frames_context <= 0:
        return pass_mask
    csum = torch.cat([
        torch.zeros((b, 1), dtype=torch.float32, device=feats.device),
        torch.cumsum(pass_mask.to(torch.float32), dim=1)], dim=1)
    lo = torch.clamp_min(t - frames_context, 0).expand(b, T)
    hi = torch.minimum(t + frames_context + 1, torch.clamp_min(n, 1))
    hi = torch.maximum(hi.expand(b, T), lo + 1)
    frac = (torch.gather(csum, 1, hi) - torch.gather(csum, 1, lo)) / (hi - lo).to(torch.float32)
    return (frac >= proportion_threshold) & valid
