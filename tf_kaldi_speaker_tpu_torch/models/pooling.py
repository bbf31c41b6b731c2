"""Pooling zoo over a frame-validity mask: statistics, multi-head
self-attention and (Ghost)NetVLAD.

Counterpart of ``tf_kaldi_speaker_tpu/models/pooling.py`` (reference
``model/pooling.py:9-277`` and the masked ``multitask_v1/pooling.py:9-40``).
A mask [B, L] makes padded batches exact; mask=None means all frames are
valid.

torch builds parameters at construction, so each pooling is given the width
of its input (``width``) and of every endpoint a config may tap
(``endpoint_widths``), and reports its output width as ``output_dim``.
Parameter and submodule names are the JAX package's (``query``,
``att_key0/affine``, ``vlad_centers``, ``vlad_weight_affine``, ...). The
plain matrix products are torch ``einsum``s, as the JAX package computes
them outside any kernel; the statistics pooling's ``use_fused_pooling``
selects the CUDA kernel (``ops/pooling.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import pooling as fused_pooling
from .layers import (
    VAR2STD_EPSILON,
    BatchNorm,
    DenseBlock,
    combine_last_two_dimensions,
    get_relu,
    init_affine_,
    split_heads,
)


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

    def __init__(self, config: Optional[Dict[str, Any]] = None, width: int = 0,
                 endpoint_widths: Optional[Mapping[str, int]] = None):
        super().__init__()
        self.fused = bool((config or {}).get("use_fused_pooling", False))
        self.output_dim = 2 * width

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
            return fused_pooling.masked_stats_pooling(features, mask)
        mean, var = masked_moments(features, mask)
        return torch.cat([mean, floor_sqrt(var)], dim=1)


# att_key_network_type / att_value_network_type -> (activation, BatchNorm) of
# the stack's last layer: 0 affine, 1 +relu, 2 affine+bn+relu, 3 affine+tanh
_LAST_LAYER = {0: (None, False), 1: ("relu", False), 2: ("relu", True), 3: ("tanh", False)}


def _dense_stack(module: nn.Module, prefix: str, width: int, nodes, last_type: Optional[int],
                 bn_momentum: float, relu_factory) -> Tuple[list, int]:
    """Add DenseBlocks ``<prefix>0..`` to ``module``: every layer affine + bn
    + relu, except the last when ``last_type`` is given. Returns the blocks
    in order and the output width."""
    blocks = []
    for idx, n in enumerate(nodes):
        act, bn = ("relu", True)
        if last_type is not None and idx == len(nodes) - 1:
            act, bn = _LAST_LAYER[last_type]
        block = DenseBlock(prefix + str(idx), width, n, act, use_bn=bn,
                           bn_momentum=bn_momentum, relu_factory=relu_factory)
        module.add_module(prefix + str(idx), block)
        blocks.append(block)
        width = n
    return blocks, width


class SelfAttentionPooling(nn.Module):
    """Multi-head attentive statistics pooling (reference pooling.py:37-192).

    Key and value are tapped from ``endpoints`` by config name; a learned
    query per head attends over time; the output is the weighted mean ||
    weighted stddev. The head-diversity penalty
    ``att_penalty_term * ||W W^T - I||^2 / B`` lands in
    ``endpoints["attention_penalty"]`` (the trainer adds it to the loss)."""

    def __init__(self, config: Dict[str, Any], width: int = 0,
                 endpoint_widths: Optional[Mapping[str, int]] = None):
        super().__init__()
        cfg = config
        widths = dict(endpoint_widths or {})
        relu_factory = get_relu(cfg)
        bn_momentum = cfg.get("batchnorm_momentum", 0.99)
        self.value_input, self.key_input = cfg["att_value_input"], cfg["att_key_input"]
        self.key_blocks, key_width = _dense_stack(
            self, "att_key", widths[self.key_input], list(cfg["att_key_num_nodes"]),
            cfg["att_key_network_type"], bn_momentum, relu_factory)
        value_nodes = list(cfg.get("att_value_num_nodes", []))
        self.value_blocks, value_width = _dense_stack(
            self, "att_value", widths[self.value_input], value_nodes,
            cfg["att_value_network_type"] if value_nodes else None, bn_momentum, relu_factory)
        self.num_heads = n_heads = int(cfg["att_num_heads"])
        self.split_key = bool(cfg.get("att_split_key", False))
        if value_width % n_heads or (self.split_key and key_width % n_heads):
            raise ValueError("key width %d / value width %d do not split into %d heads"
                             % (key_width, value_width, n_heads))
        dk = key_width // n_heads if self.split_key else key_width
        # 1/sqrt(dk) in float32, as the JAX module computes it
        self.scale = (float(np.float32(1.0) / np.sqrt(np.float32(dk)))
                      if cfg.get("att_use_scale", False) else None)
        self.query = nn.Parameter(torch.empty(n_heads, dk))
        self.nonlinear = bool(cfg.get("att_apply_nonlinear", False))
        self.output_dim = 2 * value_width
        if self.nonlinear:
            self.att_post_bn = BatchNorm(self.output_dim, bn_momentum)
            self.att_post_prelu = relu_factory(self.output_dim)
        self.penalty_term = float(cfg.get("att_penalty_term", 0.0))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """glorot-uniform dense kernels, zero biases, and the query from a
        normal truncated at two standard deviations of 0.1."""
        for block in self.key_blocks + self.value_blocks:
            block.reset_parameters(generator)
        with torch.no_grad():
            nn.init.trunc_normal_(self.query, std=0.1, a=-0.2, b=0.2, generator=generator)

    def forward(
        self,
        features: torch.Tensor,
        endpoints: Dict[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        value, key = endpoints[self.value_input], endpoints[self.key_input]
        for block in self.key_blocks:
            key = block(key, endpoints)
        for block in self.value_blocks:
            value = block(value, endpoints)
        value = split_heads(value, self.num_heads)  # [B, H, L, dv]
        if self.split_key:
            logits = torch.einsum("bhld,hd->blh", split_heads(key, self.num_heads), self.query)
        else:
            logits = torch.einsum("bld,hd->blh", key, self.query)
        if self.scale is not None:
            logits = logits * self.scale
        if mask is not None:
            logits = torch.where(mask[:, :, None] > 0, logits, -1e30)
        weights = torch.softmax(logits.transpose(1, 2), dim=-1)  # [B, H, L]
        endpoints["attention_weights"] = weights

        att_mean = torch.einsum("bhld,bhl->bhd", value, weights)
        att_var = torch.einsum("bhld,bhl->bhd", torch.square(value - att_mean[:, :, None, :]),
                               weights)
        att = torch.cat([combine_last_two_dimensions(att_mean),
                         floor_sqrt(combine_last_two_dimensions(att_var))], dim=1)
        endpoints["att_output_before_nonlinear"] = att
        if self.nonlinear:
            att = self.att_post_bn(att)
            endpoints["att_post_bn"] = att
            att = self.att_post_prelu(att)
            endpoints["att_post_relu"] = att

        eye = torch.eye(self.num_heads, dtype=torch.float32, device=weights.device)
        gram = torch.einsum("bhl,bkl->bhk", weights, weights) - eye
        endpoints["attention_penalty"] = self.penalty_term * (
            torch.sum(torch.square(gram)) / features.shape[0])
        return att


class GhostVLAD(nn.Module):
    """NetVLAD / GhostVLAD aggregation (reference pooling.py:195-277): soft
    assignment of each frame to ``vlad_num_centers`` + ``vlad_num_ghosts``
    centers, residuals summed per center (two matmuls, no [B, L, C, D]
    intermediate), the ghosts dropped, each center's residual L2-normalized
    (norms floored at 1e-12), and optionally the whole vector."""

    def __init__(self, config: Dict[str, Any], width: int = 0,
                 endpoint_widths: Optional[Mapping[str, int]] = None):
        super().__init__()
        cfg = config
        widths = dict(endpoint_widths or {})
        relu_factory = get_relu(cfg)
        bn_momentum = cfg.get("batchnorm_momentum", 0.99)
        self.num_centers = int(cfg["vlad_num_centers"])
        self.num_ghosts = int(cfg.get("vlad_num_ghosts", 0))
        self.value_input, self.key_input = cfg["vlad_value_input"], cfg["vlad_key_input"]
        self.value_blocks, value_width = _dense_stack(
            self, "vlad_value", widths[self.value_input], list(cfg.get("vlad_value_num_nodes", [])),
            None, bn_momentum, relu_factory)
        self.key_blocks, key_width = _dense_stack(
            self, "vlad_key", widths[self.key_input], list(cfg.get("vlad_key_num_nodes", [])),
            None, bn_momentum, relu_factory)
        total = self.num_centers + self.num_ghosts
        self.vlad_weight_affine = nn.Linear(key_width, total)
        self.vlad_centers = nn.Parameter(torch.empty(total, value_width))
        self.final_l2_norm = bool(cfg.get("vlad_final_l2_norm", False))
        self.output_dim = self.num_centers * value_width
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """glorot-uniform kernels and centers, zero biases."""
        for block in self.value_blocks + self.key_blocks:
            block.reset_parameters(generator)
        init_affine_(self.vlad_weight_affine, generator)
        c = self.vlad_centers
        limit = float(np.sqrt(6.0 / (c.shape[0] + c.shape[1])))
        with torch.no_grad():
            c.uniform_(-limit, limit, generator=generator)

    def forward(
        self,
        features: torch.Tensor,
        endpoints: Dict[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        value, key = endpoints[self.value_input], endpoints[self.key_input]
        for block in self.value_blocks:
            value = block(value, endpoints)
        for block in self.key_blocks:
            key = block(key, endpoints)
        logits = self.vlad_weight_affine(key)
        assign = torch.softmax(logits, dim=-1)  # [B, L, C+G]
        if mask is not None:
            assign = assign * mask.to(logits.dtype)[:, :, None]  # masked frames join no center
        endpoints["vlad_weights"] = assign
        clusters = self.vlad_centers
        av = torch.einsum("blc,bld->bcd", assign, value)
        res = av - torch.sum(assign, dim=1)[:, :, None] * clusters[None, :, :]
        res = res[:, :self.num_centers, :]
        res = res / torch.clamp_min(torch.linalg.vector_norm(res, dim=-1, keepdim=True), 1e-12)
        output = res.reshape(res.shape[0], -1)
        if self.final_l2_norm:
            output = output / torch.clamp_min(
                torch.linalg.vector_norm(output, dim=-1, keepdim=True), 1e-12)
        endpoints["vlad_value"] = value
        endpoints["vlad_key"] = logits
        endpoints["vlad_centers_value"] = clusters
        return output


POOLING_REGISTRY = {
    "statistics_pooling": StatisticsPooling,
    "self_attention": SelfAttentionPooling,
    "ghost_vlad": GhostVLAD,
}


def make_pooling(config: Dict[str, Any], width: int,
                 endpoint_widths: Mapping[str, int]) -> nn.Module:
    """The config's ``pooling_type`` (default statistics pooling) over a
    ``width``-wide input; raises for a type the registry lacks."""
    pooling_type = config.get("pooling_type", "statistics_pooling")
    if pooling_type not in POOLING_REGISTRY:
        raise NotImplementedError("Not implement %s pooling" % pooling_type)
    return POOLING_REGISTRY[pooling_type](config, width, endpoint_widths)
