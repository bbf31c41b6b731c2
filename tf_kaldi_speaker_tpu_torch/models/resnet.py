"""ResNet34 speaker encoder (the 2-D "r-vector" trunk).

Counterpart of ``tf_kaldi_speaker_tpu/models/resnet.py``: features [B, L, F]
become an image [B, L, F, 1]; 3x3 2-D convolutions with explicit (1, 1)
padding and no bias, time and frequency halved at each stride-2 stage entry
(output frame i centred on input frame 2i, so the frame mask becomes
``mask[:, ::2]``); padded frames re-zeroed after every block, so a padded
eval forward equals the unpadded one. The trunk's [B, L', F', C] is
flattened to [B, L', F'·C] for the shared pooling registry, then the
``embedding`` dense layer and ``embedding_bn``.

Activations stay in the JAX layout [B, L, F, C]; each convolution sees it
as an NCHW tensor in channels-last memory (a permuted view, no copy), and
each BatchNorm normalizes the last axis with flax's epsilon 1e-5, its
train-mode statistics taken over every other axis. Conv weights are
torch's [out, in, kh, kw]; ``convert.py`` maps flax's [kh, kw, in, out].

Config keys: ``resnet_base_channels`` (32; stage widths x1/x2/x4/x8),
``resnet_layers`` ([3, 4, 6, 3]), ``resnet_embedding_dim`` (256; falls back
to ``num_nodes_last_layer``), ``pooling_type``. Embedding node:
``resnet_embedding`` (pre-BN: ``resnet_embedding_dense``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FLAX_BN_EPSILON, BatchNorm, init_affine_
from .pooling import make_pooling

STAGE_STRIDES = (1, 2, 2, 2)


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, bias=False)


def _apply_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d on [B, L, F, C]: the NCHW view of x is channels-last."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class StridedProjection(nn.Module):
    """The shortcut's 1x1 convolution with stride s and no padding on
    [B, L, F, C]: every s-th position in time and frequency through a dense
    product. ``weight`` is [out, in, 1, 1] as a Conv2d holds it. (PyTorch's
    CPU convolution crashes on a strided 1x1 over channels-last input of
    even height and width; this form has no such case.)"""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        return F.linear(x[:, ::s, ::s, :], self.weight[:, :, 0, 0])


def _init_conv_(conv: nn.Module, generator: Optional[torch.Generator]) -> None:
    """glorot-uniform over the JAX package's fans (channels x kernel area)."""
    w = conv.weight
    receptive = w[0, 0].numel()
    limit = (6.0 / ((w.shape[0] + w.shape[1]) * receptive)) ** 0.5
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (ResNet v1 basic)."""

    def __init__(self, in_channels: int, channels: int, stride: int, bn_momentum: float):
        super().__init__()
        self.conv1 = _conv(in_channels, channels, 3, stride)
        self.bn1 = BatchNorm(channels, bn_momentum, FLAX_BN_EPSILON)
        self.conv2 = _conv(channels, channels, 3)
        self.bn2 = BatchNorm(channels, bn_momentum, FLAX_BN_EPSILON)
        if stride != 1 or in_channels != channels:
            self.proj = StridedProjection(in_channels, channels, stride)
            self.proj_bn = BatchNorm(channels, bn_momentum, FLAX_BN_EPSILON)

    def convs(self):
        return [self.conv1, self.conv2] + ([self.proj] if hasattr(self, "proj") else [])

    def forward(self, x: torch.Tensor, mask_out: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(_apply_conv(self.conv1, x)))
        # Re-zero padding frames before the second conv: the BatchNorm
        # shifts them off zero and the 3x3 would carry that into valid
        # boundary frames.
        h = h * mask_out[:, :, None, None]
        h = self.bn2(_apply_conv(self.conv2, h))
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x))
        return torch.relu(h + x)


class ResNet34(nn.Module):
    """r-vector trunk + pooling + embedding; ``forward`` returns
    (embedding, endpoints). ``input_dim`` (the feature dim F, plus the
    widths of the aux streams concatenated on the frequency axis) sets the
    flattened width F'·C that the pooling and the embedding layer take."""

    def __init__(self, config: Dict[str, Any], input_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        base = int(cfg.get("resnet_base_channels", 32))
        layers = list(cfg.get("resnet_layers", [3, 4, 6, 3]))
        emb_dim = int(cfg.get("resnet_embedding_dim", cfg.get("num_nodes_last_layer", 256)))
        bn_mom = float(cfg.get("batchnorm_momentum", 0.99))
        self.stem = _conv(1, base, 3)
        self.stem_bn = BatchNorm(base, bn_mom, FLAX_BN_EPSILON)
        self.stages = []  # [(stage, [(block name, stride)])]
        ch_in, freq = base, int(input_dim)
        for stage, (n_blocks, stride) in enumerate(zip(layers, STAGE_STRIDES), start=1):
            ch = base * (2 ** (stage - 1))
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                name = "stage%d_block%d" % (stage, b)
                setattr(self, name, BasicBlock(ch_in, ch, s, bn_mom))
                blocks.append((name, s))
                ch_in = ch
                if s != 1:
                    freq = (freq + 1) // 2
            self.stages.append((stage, blocks))
        frames_width = freq * ch_in
        self.pooling_type = cfg.get("pooling_type", "statistics_pooling")
        pooling = make_pooling(cfg, frames_width, {"resnet_frames": frames_width})
        self.add_module(self.pooling_type, pooling)
        self.embedding = nn.Linear(pooling.output_dim, emb_dim)
        self.embedding_bn = BatchNorm(emb_dim, bn_mom, FLAX_BN_EPSILON)
        self.output_dim = emb_dim
        self.reset_parameters(generator)

    @property
    def pooling(self) -> nn.Module:
        return getattr(self, self.pooling_type)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """glorot-uniform kernels and zero biases, drawn in layer order."""
        _init_conv_(self.stem, generator)
        for _, blocks in self.stages:
            for name, _ in blocks:
                for conv in getattr(self, name).convs():
                    _init_conv_(conv, generator)
        if hasattr(self.pooling, "reset_parameters"):
            self.pooling.reset_parameters(generator)
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
        x = features[:, :, :, None] * mask[:, :, None, None]
        x = torch.relu(self.stem_bn(_apply_conv(self.stem, x))) * mask[:, :, None, None]
        endpoints["resnet_stem"] = x
        for stage, blocks in self.stages:
            for name, s in blocks:
                if s != 1:
                    mask = mask[:, ::2]
                x = getattr(self, name)(x, mask) * mask[:, :, None, None]
            endpoints["resnet_stage%d" % stage] = x
        b, l, f, c = x.shape
        x = x.reshape(b, l, f * c)
        endpoints["resnet_frames"] = x
        pooled = self.pooling(x, endpoints, mask=mask)
        endpoints["pooling"] = pooled
        emb = self.embedding(pooled)
        endpoints["resnet_embedding_dense"] = emb
        emb = self.embedding_bn(emb)
        endpoints["resnet_embedding"] = emb
        return emb, endpoints
