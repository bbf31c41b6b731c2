"""Fused masked statistics pooling on the GPU.

Counterpart of ``tf_kaldi_speaker_tpu/ops/pooling_pallas.py``. The forward
reads the activations once and derives the masked mean and the floored
standard deviation from one pass of sums (CUDA kernel
``csrc/stats_pooling.cu``); the backward is the analytic formula of the JAX
custom VJP, in plain PyTorch as it is plain jnp there.
"""

from __future__ import annotations

import collections

import torch

from ..models.layers import VAR2STD_EPSILON
from . import _build


def masked_stats_pooling_plain(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain two-pass version: [B, L, D], [B, L] -> [B, 2D] in x's dtype.

    Sums are taken in float32 whatever x's dtype, as the kernel takes them."""
    xf = x.to(torch.float32)
    m = mask.to(torch.float32)[:, :, None]
    denom = torch.clamp_min(torch.sum(m, dim=1), 1.0)
    mean = torch.sum(xf * m, dim=1) / denom
    var = torch.sum(torch.square(xf - mean[:, None, :]) * m, dim=1) / denom
    std = torch.sqrt(torch.where(var <= VAR2STD_EPSILON, VAR2STD_EPSILON, var))
    return torch.cat([mean, std], dim=1).to(x.dtype)


_KERNELS = {
    torch.float32: "tfks_stats_pooling_f32",
    torch.bfloat16: "tfks_stats_pooling_bf16",
}


def _stats_cuda(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError("masked_stats_pooling: x (%s) and mask (%s) must be "
                         "on one CUDA device" % (x.device, mask.device))
    if x.dtype not in _KERNELS or mask.dtype != torch.float32:
        raise TypeError("masked_stats_pooling: needs float32 or bfloat16 x and "
                        "a float32 mask, got %s and %s" % (x.dtype, mask.dtype))
    if x.dim() != 3:
        raise ValueError("masked_stats_pooling: x must be [B, L, D], got %s"
                         % tuple(x.shape))
    b, l, d = x.shape
    if tuple(mask.shape) != (b, l):
        raise ValueError("masked_stats_pooling: mask must be [%d, %d], got %s"
                         % (b, l, tuple(mask.shape)))
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("masked_stats_pooling: inputs must be contiguous")
    if b > 65535:
        raise ValueError("masked_stats_pooling: at most 65535 rows, got %d" % b)
    out = torch.empty((b, 2 * d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _KERNELS[x.dtype])(
            x.data_ptr(), mask.data_ptr(), out.data_ptr(), b, l, d, stream)
    _build.check(err, "masked_stats_pooling")
    masked_stats_pooling.launches += 1
    masked_stats_pooling.shapes[(b, l, d), str(x.dtype)[6:]] += 1
    return out


class MaskedStatsPooling(torch.autograd.Function):
    """Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Backward: d mean/dx = m/n, d std/dx = m (x - mean) / (n std),
    zero where the variance was floored (pooling_pallas.py:100-116)."""

    @staticmethod
    def forward(ctx, x, mask):
        if x.device.type == "cpu" and mask.device.type == "cpu":
            out = masked_stats_pooling_plain(x, mask)
        else:
            out = _stats_cuda(x, mask)
        ctx.save_for_backward(x, mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, out = ctx.saved_tensors
        d = x.shape[-1]
        mean, std = out[:, None, :d], out[:, None, d:]
        g_mean, g_std = g[:, None, :d], g[:, None, d:]
        m = mask[:, :, None].to(x.dtype)
        inv_n = 1.0 / torch.clamp_min(torch.sum(m, dim=1, keepdim=True), 1.0)
        floored = (std * std <= VAR2STD_EPSILON * (1 + 1e-6)).to(x.dtype)
        gx = m * inv_n * g_mean
        gx = gx + m * inv_n * (x - mean) / std * (g_std * (1.0 - floored))
        return gx, None


def masked_stats_pooling(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, D], [B, L] -> [B, 2D] (mean || floored stddev), differentiable
    in x. The mask is cast to a contiguous float32 tensor first, as the JAX
    wrapper casts it for its kernel."""
    return MaskedStatsPooling.apply(x, mask.to(torch.float32).contiguous())


# Kernel launches, and launches by ((B, L, D), dtype name), counted where
# the kernel is launched; chip_smoke.py reads both after the main path.
masked_stats_pooling.launches = 0
masked_stats_pooling.shapes = collections.Counter()
