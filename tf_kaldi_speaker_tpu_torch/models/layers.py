"""Shared building blocks for [B, L, C] time-major batches.

Counterpart of ``tf_kaldi_speaker_tpu/models/layers.py`` (reference
``model/common.py``): the activation factory, glorot-uniform init with zero
bias, BatchNorm over the last axis (train and eval mode), L2 re-scaling,
the all-pairs distances and cosines of the triplet losses, the dense
[+ bn] [+ activation] block and the head split/merge helpers.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..ops.batchnorm import batch_norm_train
from ..parallel.mesh import all_reduce

VAR2STD_EPSILON = 1e-12

# tf.layers.batch_normalization default (the reference never overrides it);
# the TDNN, its poolings and DenseBlock use it.
TF_BN_EPSILON = 1e-3
# flax's nn.BatchNorm default, which ECAPA and ResNet34 keep.
FLAX_BN_EPSILON = 1e-5


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
    (0.12) computes it: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``,
    with ``epsilon`` the reference's 1e-3 (TDNN) unless the module says
    otherwise (ECAPA and ResNet34 keep flax's 1e-5). Parameter and buffer
    names follow the JAX package (scale, bias, mean, var).

    Eval mode normalizes with the running statistics. Train mode takes the
    batch's over every axis but the last, in float32 (float64 for a float64
    x, as flax promotes), with flax's fast variance max(E[x²] - E[x]², 0);
    it normalizes in that type, rounds to x's dtype, and updates the running statistics in
    place as ``r = momentum * r + (1 - momentum) * batch`` with the biased
    batch variance (not torch's BatchNorm convention, whose momentum is the
    complement and whose running variance is unbiased).

    With ``group`` (the data group, set by ``parallel.shard_model``) the
    batch is the global one, as under pjit: the per-channel sums of x and
    x² and the row count are all-reduced over the group (a gradient
    all-reduces back the same way), so every rank normalizes with, and
    moves its running statistics by, the same global statistics.

    On a card, train mode runs the same arithmetic, ``group`` included, in
    hand-written kernels (``ops/batchnorm.py``), which take a bf16 or
    float32 x and raise for anything else; the sums are taken in another
    order, the rest rounds as here. The train-mode code below is the
    CPU's."""

    def __init__(self, width: int, momentum: float = 0.99, epsilon: float = TF_BN_EPSILON):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.group = None
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("mean", torch.zeros(width))
        self.register_buffer("var", torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.var + self.epsilon) * self.scale
            return (x - self.mean) * mul + self.bias
        if x.device.type != "cpu":
            return batch_norm_train(x, self.scale, self.bias, self.mean, self.var,
                                    self.momentum, self.epsilon, self.group)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(x.dim() - 1))
        if self.group is None:
            mean = torch.mean(xf, dim=dims)
            var = torch.clamp_min(torch.mean(xf * xf, dim=dims) - mean * mean, 0.0)
        else:
            c = xf.shape[-1]
            sums = all_reduce(torch.cat([torch.sum(xf, dim=dims), torch.sum(xf * xf, dim=dims),
                                         xf.new_full((1,), xf.numel() // c)]), self.group)
            mean = sums[:c] / sums[-1]
            var = torch.clamp_min(sums[c:2 * c] / sums[-1] - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.to(xf.dtype)
        return ((xf - mean) * mul + self.bias.to(xf.dtype)).to(x.dtype)


def l2_scaling(x: torch.Tensor, scaling_factor: float, epsilon: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis then scale (common.py:45-58)."""
    square_sum = torch.sum(x * x, dim=-1, keepdim=True)
    return x * (torch.rsqrt(torch.clamp_min(square_sum, epsilon)) * scaling_factor)


def pairwise_euc_distances(embeddings: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """All-pairs (squared) euclidean distances (common.py:61-94). The floor
    at 0 is ``torch.maximum``, whose gradient splits a tie as
    ``jnp.maximum``'s does; exact zeros get no sqrt gradient."""
    dot = embeddings @ embeddings.t()
    sq = torch.diagonal(dot)
    d = sq[:, None] - 2.0 * dot + sq[None, :]
    d = torch.maximum(d, torch.zeros_like(d))
    if not squared:
        mask = (d == 0.0).to(d.dtype)
        d = torch.sqrt(d + mask * 1e-16) * (1.0 - mask)
    return d


def pairwise_cos_similarity(embeddings: torch.Tensor, epsilon: float = 1e-12) -> torch.Tensor:
    """All-pairs cosine similarity, clipped to [-1, 1] as ``jnp.clip`` clips
    (common.py:97-110)."""
    dot = embeddings @ embeddings.t()
    sq = torch.sum(embeddings * embeddings, dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp_min(sq, epsilon))
    cos = dot * (inv @ inv.t())
    return torch.minimum(torch.maximum(cos, torch.full_like(cos, -1.0)), torch.full_like(cos, 1.0))


class DenseBlock(nn.Module):
    """dense [+ bn] [+ activation], recording endpoints under the block's
    name (reference common.py:113-223). ``activation``: None | "relu" |
    "tanh"; "relu" is the config's ``network_relu_type`` through
    ``relu_factory``. Submodules carry the JAX names: ``affine``, ``bn``,
    ``<name>_prelu``."""

    def __init__(self, name: str, in_features: int, features: int,
                 activation: Optional[str] = "relu", use_bn: bool = False,
                 bn_momentum: float = 0.99,
                 relu_factory: Optional[Callable[[int], nn.Module]] = None):
        super().__init__()
        self.block_name = name
        self.activation = activation
        self.affine = nn.Linear(in_features, features)
        if use_bn:
            self.bn = BatchNorm(features, bn_momentum)
        if activation == "relu":
            self.add_module(name + "_prelu", (relu_factory or get_relu({}))(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_affine_(self.affine, generator)

    def forward(self, x: torch.Tensor, endpoints: Dict[str, torch.Tensor]) -> torch.Tensor:
        name = self.block_name
        x = self.affine(x)
        endpoints[name + "_dense"] = x
        bn = getattr(self, "bn", None)
        if bn is not None:
            x = bn(x)
            endpoints[name + "_bn"] = x
        if self.activation == "relu":
            x = getattr(self, name + "_prelu")(x)
            endpoints[name + "_relu"] = x
        elif self.activation == "tanh":
            x = torch.tanh(x)
            endpoints[name + "_tanh"] = x
        return x


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, C] -> [B, H, L, C/H] (common.py:244-253)."""
    b, l, c = x.shape
    if c % num_heads:
        raise ValueError("width %d does not split into %d heads" % (c, num_heads))
    return x.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def combine_last_two_dimensions(x: torch.Tensor) -> torch.Tensor:
    """[..., a, b] -> [..., a*b] (common.py:256-265)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
