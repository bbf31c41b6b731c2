"""Shared building blocks for [B, L, C] time-major batches.

Counterpart of ``tf_kaldi_speaker_tpu/models/layers.py`` (reference
``model/common.py``): the activation factory, glorot-uniform init with zero
bias, BatchNorm over the last axis (train and eval mode) and L2 re-scaling.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

VAR2STD_EPSILON = 1e-12

# tf.layers.batch_normalization default (the reference never overrides it).
TF_BN_EPSILON = 1e-3


class PReLU(nn.Module):
    """Parametric ReLU with per-channel alpha (reference common.py:27-42)."""

    def __init__(self, width: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((width,), 0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(x, 0) + self.alpha * torch.clamp_max(x, 0)


def get_relu(params: Dict[str, Any]) -> Callable[[int], nn.Module]:
    """Activation selected by ``network_relu_type`` (relu/prelu/lrelu).

    Returns a factory ``f(width) -> module``; PReLU has per-channel
    parameters, so each use site makes its own."""
    kind = params.get("network_relu_type", "relu")
    if kind == "prelu":
        return PReLU
    if kind == "lrelu":
        return lambda width: nn.LeakyReLU(0.01)
    return lambda width: nn.ReLU()


def init_affine_(layer: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """TF's tf.layers defaults, in place: a glorot-uniform kernel (dense
    [out, in] or conv [out, in, k]; fans are channels x kernel width, as in
    the JAX package's initializer) and a zero bias."""
    w = layer.weight
    receptive = w[0, 0].numel()
    limit = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * receptive))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)
        layer.bias.zero_()


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of [..., C], as flax ``nn.BatchNorm``
    (0.12) computes it with the reference's epsilon 1e-3:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``. Parameter and buffer
    names follow the JAX package (scale, bias, mean, var).

    Eval mode normalizes with the running statistics. Train mode takes the
    batch's over every axis but the last, in float32 whatever x's dtype,
    with flax's fast variance max(E[x²] - E[x]², 0); it normalizes in
    float32, rounds to x's dtype, and updates the running statistics in
    place as ``r = momentum * r + (1 - momentum) * batch`` with the biased
    batch variance (not torch's BatchNorm convention, whose momentum is the
    complement and whose running variance is unbiased)."""

    def __init__(self, width: int, momentum: float = 0.99):
        super().__init__()
        self.momentum = float(momentum)
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("mean", torch.zeros(width))
        self.register_buffer("var", torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.var + TF_BN_EPSILON) * self.scale
            return (x - self.mean) * mul + self.bias
        xf = x.to(torch.float32)
        dims = tuple(range(x.dim() - 1))
        mean = torch.mean(xf, dim=dims)
        var = torch.clamp_min(torch.mean(xf * xf, dim=dims) - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        mul = torch.rsqrt(var + TF_BN_EPSILON) * self.scale.to(torch.float32)
        return ((xf - mean) * mul + self.bias.to(torch.float32)).to(x.dtype)


def l2_scaling(x: torch.Tensor, scaling_factor: float, epsilon: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis then scale (common.py:45-58)."""
    square_sum = torch.sum(x * x, dim=-1, keepdim=True)
    return x * (torch.rsqrt(torch.clamp_min(square_sum, epsilon)) * scaling_factor)

