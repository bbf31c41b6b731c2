"""ECAPA-TDNN speaker encoder.

Counterpart of ``tf_kaldi_speaker_tpu/models/ecapa.py`` (Desplanques et al.,
Interspeech 2020): SE-Res2Net blocks with dilations 2, 3, 4, multi-layer
feature aggregation, and channel- and context-dependent attentive
statistics pooling.

- Convolutions with a kernel wider than one frame run on a [B, C, L] view
  with SAME zero padding (conv1 k5; the Res2Net convs k3 at the block's
  dilation); the 1x1 convolutions are products over the channel axis of the
  [B, L, C] batch (:class:`PointwiseConv`, JAX kernel layout [1, in, out]).
- Padded frames are re-zeroed wherever the JAX module does it, so a padded
  eval forward equals the unpadded one.
- BatchNorms keep flax's epsilon 1e-5 (the JAX module passes none).

Config keys (defaults = the 512-channel ECAPA of the paper):
``ecapa_channels`` (512), ``ecapa_mfa_channels`` (1536),
``ecapa_res2net_scale`` (8), ``ecapa_se_bottleneck`` (128),
``ecapa_att_bottleneck`` (128), ``ecapa_embedding_dim`` (192; falls back to
``num_nodes_last_layer``). Embedding node: ``ecapa_embedding`` (pre-BN:
``ecapa_embedding_dense``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FLAX_BN_EPSILON, VAR2STD_EPSILON, BatchNorm, init_affine_
from .pooling import floor_sqrt, masked_moments


def _bn(width: int, momentum: float) -> BatchNorm:
    return BatchNorm(width, momentum, FLAX_BN_EPSILON)


class PointwiseConv(nn.Module):
    """A kernel-1 convolution over the last axis of [..., C]: ``weight``
    [out, in, 1] as a Conv1d holds it, applied as a dense product."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


class SameConv1d(nn.Conv1d):
    """Conv1d over the time axis of a [B, L, C] batch with SAME zero padding
    at the given dilation (odd kernels pad symmetrically)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel, dilation=dilation,
                         padding=(kernel - 1) * dilation // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class SERes2NetBlock(nn.Module):
    """1x1 conv -> Res2Net dilated convs -> 1x1 conv -> SE, residual."""

    def __init__(self, channels: int, kernel: int, dilation: int, scale: int,
                 se_bottleneck: int, bn_momentum: float):
        super().__init__()
        C = channels
        self.scale = scale
        w = C // scale
        self.conv_in = PointwiseConv(C, C)
        self.bn_in = _bn(C, bn_momentum)
        for i in range(1, scale):
            setattr(self, "res2_conv%d" % i, SameConv1d(w, w, kernel, dilation))
            setattr(self, "res2_bn%d" % i, _bn(w, bn_momentum))
        self.conv_out = PointwiseConv(C, C)
        self.bn_out = _bn(C, bn_momentum)
        self.se_down = nn.Linear(C, se_bottleneck)
        self.se_up = nn.Linear(se_bottleneck, C)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in (self.conv_in, *(getattr(self, "res2_conv%d" % i) for i in range(1, self.scale)),
                  self.conv_out, self.se_down, self.se_up):
            init_affine_(m, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        residual = x
        m = mask[:, :, None]
        h = torch.relu(self.bn_in(self.conv_in(x)))
        # Re-zero padding frames before every dilated conv: the bias and the
        # BatchNorm's shift make them nonzero, and a k > 1 SAME conv would
        # carry that into valid boundary frames.
        h = h * m
        w = h.shape[-1] // self.scale
        outs = [h[..., :w]]
        prev = None
        for i in range(1, self.scale):
            g = h[..., i * w:(i + 1) * w]
            if prev is not None:
                g = g + prev
            g = getattr(self, "res2_conv%d" % i)(g)
            g = torch.relu(getattr(self, "res2_bn%d" % i)(g)) * m
            outs.append(g)
            prev = g
        h = torch.relu(self.bn_out(self.conv_out(torch.cat(outs, dim=-1))))
        # squeeze-excitation over the masked time mean
        s = torch.sum(h * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1), 1e-6)
        s = torch.sigmoid(self.se_up(torch.relu(self.se_down(s))))
        return h * s[:, None, :] + residual


class AttentiveStatsPooling(nn.Module):
    """Channel- and context-dependent attentive statistics (ECAPA §3.2):
    attention over time per channel from [x || mean || std], then the
    weighted mean || the weighted stddev (one-pass variance, floored)."""

    def __init__(self, channels: int, bottleneck: int):
        super().__init__()
        self.att_bottleneck = PointwiseConv(3 * channels, bottleneck)
        self.att_scores = PointwiseConv(bottleneck, channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_affine_(self.att_bottleneck, generator)
        init_affine_(self.att_scores, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        mean, var = masked_moments(x, mask)
        std = floor_sqrt(var)
        ctx = torch.cat([x, mean[:, None, :].expand(B, L, C), std[:, None, :].expand(B, L, C)],
                        dim=-1)
        a = self.att_scores(torch.tanh(self.att_bottleneck(ctx)))
        a = torch.where(mask[:, :, None] > 0, a, -1e30)
        a = torch.softmax(a, dim=1)
        mu = torch.sum(a * x, dim=1)
        var = torch.sum(a * torch.square(x), dim=1) - torch.square(mu)
        sg = torch.sqrt(torch.clamp_min(var, VAR2STD_EPSILON))
        return torch.cat([mu, sg], dim=1)


class ECAPA(nn.Module):
    """ECAPA-TDNN encoder; ``forward`` returns (embedding, endpoints)."""

    def __init__(self, config: Dict[str, Any], input_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        C = int(cfg.get("ecapa_channels", 512))
        mfa = int(cfg.get("ecapa_mfa_channels", 1536))
        scale = int(cfg.get("ecapa_res2net_scale", 8))
        se_bn = int(cfg.get("ecapa_se_bottleneck", 128))
        att_bn = int(cfg.get("ecapa_att_bottleneck", 128))
        emb_dim = int(cfg.get("ecapa_embedding_dim", cfg.get("num_nodes_last_layer", 192)))
        bn_mom = float(cfg.get("batchnorm_momentum", 0.99))
        self.conv1 = SameConv1d(input_dim, C, 5)
        self.bn1 = _bn(C, bn_mom)
        for i, dil in enumerate((2, 3, 4), start=1):
            setattr(self, "block%d" % i, SERes2NetBlock(C, 3, dil, scale, se_bn, bn_mom))
        self.mfa = PointwiseConv(3 * C, mfa)
        self.asp = AttentiveStatsPooling(mfa, att_bn)
        self.asp_bn = _bn(2 * mfa, bn_mom)
        self.embedding = nn.Linear(2 * mfa, emb_dim)
        self.embedding_bn = _bn(emb_dim, bn_mom)
        self.output_dim = emb_dim
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """glorot-uniform kernels and zero biases, drawn in layer order."""
        init_affine_(self.conv1, generator)
        for i in (1, 2, 3):
            getattr(self, "block%d" % i).reset_parameters(generator)
        init_affine_(self.mfa, generator)
        self.asp.reset_parameters(generator)
        init_affine_(self.embedding, generator)

    def forward(
        self, features: torch.Tensor, mask: Optional[torch.Tensor] = None,
        aux_features: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if aux_features:
            features = torch.cat([features] + [aux_features[k] for k in sorted(aux_features)],
                                 dim=-1)
        endpoints: Dict[str, torch.Tensor] = {}
        B, L, _ = features.shape
        if mask is None:
            mask = torch.ones((B, L), dtype=features.dtype, device=features.device)
        mask = mask.to(features.dtype)
        m = mask[:, :, None]
        x = torch.relu(self.bn1(self.conv1(features))) * m
        endpoints["ecapa_conv1"] = x
        block_outs = []
        for i in (1, 2, 3):
            x = getattr(self, "block%d" % i)(x, mask) * m
            endpoints["ecapa_block%d" % i] = x
            block_outs.append(x)
        h = torch.relu(self.mfa(torch.cat(block_outs, dim=-1))) * m
        endpoints["ecapa_mfa"] = h
        pooled = self.asp_bn(self.asp(h, mask))
        endpoints["ecapa_pooling"] = pooled
        emb = self.embedding(pooled)
        endpoints["ecapa_embedding_dense"] = emb
        emb = self.embedding_bn(emb)
        endpoints["ecapa_embedding"] = emb
        return emb, endpoints
