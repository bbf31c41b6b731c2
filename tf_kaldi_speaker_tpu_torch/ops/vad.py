"""Energy voice-activity detection over a padded batch.

Counterpart of ``compute_vad_energy_jax`` (``tf_kaldi_speaker_tpu/ops/
vad.py:50-92``), which replaces Kaldi's ``compute-vad``: frame t is voiced
when ``log_energy(t) > threshold + mean_scale * mean(log_energy)``, with
optional voting over +-``frames_context`` frames. Log-energy is feature
column 0 (MFCC C0).
"""

from __future__ import annotations

import torch


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
    valid frames only; padding frames must be zero on input."""
    e = feats[:, :, 0]
    b, T = e.shape
    t = torch.arange(T, dtype=torch.int64, device=feats.device)[None, :]
    n = lengths.to(device=feats.device, dtype=torch.int64)[:, None]
    valid = t < n
    cutoff = torch.tensor(energy_threshold, dtype=torch.float32, device=feats.device)
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
