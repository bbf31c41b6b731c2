"""Statistics pooling over a frame-validity mask.

Counterpart of the statistics branch of
``tf_kaldi_speaker_tpu/models/pooling.py`` (reference ``model/pooling.py:9-34``
and the masked ``multitask_v1/pooling.py:9-40``). A mask [B, L] makes padded
batches exact; mask=None means all frames are valid. The attention and
GhostVLAD poolings are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.pooling import masked_stats_pooling
from .layers import VAR2STD_EPSILON


def masked_moments(
    features: torch.Tensor, mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass mean and variance over the time axis, ignoring masked frames.

    features [B, L, D], mask [B, L] (float or bool) or None ->
    (mean [B, D], variance [B, D])."""
    if mask is None:
        mean = torch.mean(features, dim=1)
        var = torch.mean(torch.square(features - mean[:, None, :]), dim=1)
        return mean, var
    m = mask.to(features.dtype)[:, :, None]
    denom = torch.clamp_min(torch.sum(m, dim=1), 1.0)
    mean = torch.sum(features * m, dim=1) / denom
    var = torch.sum(torch.square(features - mean[:, None, :]) * m, dim=1) / denom
    return mean, var


def floor_sqrt(variance: torch.Tensor) -> torch.Tensor:
    """sqrt with the reference's epsilon flooring (pooling.py:28-30)."""
    return torch.sqrt(torch.where(variance <= VAR2STD_EPSILON, VAR2STD_EPSILON, variance))


class StatisticsPooling(nn.Module):
    """[mean || stddev] pooling; ``use_fused_pooling`` selects the one-pass
    kernel (ops/pooling.py) over the two-pass moments."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.fused = bool((config or {}).get("use_fused_pooling", False))

    def forward(
        self,
        features: torch.Tensor,
        endpoints: Dict[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.fused:
            if mask is None:
                mask = torch.ones(features.shape[:2], dtype=features.dtype,
                                  device=features.device)
            return masked_stats_pooling(features, mask)
        mean, var = masked_moments(features, mask)
        return torch.cat([mean, floor_sqrt(var)], dim=1)
