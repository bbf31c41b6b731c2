"""Sequence parallelism: one utterance's frame axis split over the data ranks.

Counterpart of ``tf_kaldi_speaker_tpu/parallel/sequence_parallel.py``
(``sp_embed``, ``:30-94``): statistics pooling is associative, so each
rank runs the frame-level TDNN on its chunk of the utterance (chunks
overlap by the receptive field, ``TDNN_TOTAL_CONTEXT``, so no halo is
exchanged), the masked sums of h and h² and the frame count are
all-reduced over the data group, and the utterance-level layers run
replicated. The pooling is the JAX function's: one-pass variance
``max(s2 / n - mean², 0)`` floored at ``VAR2STD_EPSILON`` before the
square root (not the fused pooling kernel's shifted sums).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.pooling import VAR2STD_EPSILON
from ..models.tdnn import TDNN, TDNN_TOTAL_CONTEXT, TDNNFrames, TDNNTail
from .mesh import Mesh


@torch.no_grad()
def sp_embed(tdnn: TDNN, config: Dict, feature: np.ndarray, mesh: Mesh,
             node: str = "tdnn6_dense", device: Optional[torch.device] = None) -> np.ndarray:
    """Embed one [L, D] utterance with its frame axis split over the mesh's
    data ranks (every rank calls it with the same utterance and gets the
    embedding). ``tdnn`` is the network's TDNN in eval mode, on
    ``device`` (its parameters' device when None)."""
    device = device or next(tdnn.parameters()).device
    n, i = mesh.data_size, mesh.data_rank
    ctx = TDNN_TOTAL_CONTEXT
    length, dim = feature.shape
    # Valid frame-level positions: L - ctx, an equal share a rank; chunk i
    # covers input rows [i * step, i * step + step + ctx).
    positions = length - ctx
    step = int(np.ceil(positions / n))
    chunk = np.zeros((step + ctx, dim), feature.dtype)
    s = i * step
    e = min(s + step + ctx, length)
    if e > s:
        chunk[:e - s] = feature[s:e]
    valid = max(min(step, positions - s), 0)
    tdnn = tdnn.eval()
    h = TDNNFrames(tdnn)(torch.from_numpy(chunk)[None].to(device))  # [1, step, W]
    m = (torch.arange(h.shape[1], device=device) < valid).to(h.dtype)[None, :, None]
    sums = torch.cat([torch.sum(h * m, dim=(0, 1)), torch.sum(torch.square(h) * m, dim=(0, 1)),
                      torch.sum(m[:, :, 0]).reshape(1)])
    if mesh.data_group is not None:
        dist.all_reduce(sums, group=mesh.data_group)
    w = h.shape[-1]
    s1, s2, cnt = sums[:w], sums[w:2 * w], sums[-1]
    mean = s1 / cnt
    var = torch.clamp_min(s2 / cnt - mean * mean, 0.0)
    std = torch.sqrt(torch.where(var <= VAR2STD_EPSILON, torch.full_like(var, VAR2STD_EPSILON),
                                 var))
    endpoints = TDNNTail(tdnn, config)(torch.cat([mean, std])[None])
    return endpoints[node][0].float().cpu().numpy()
