"""Fused masked statistics pooling on the GPU, forward and backward.

Counterpart of ``tf_kaldi_speaker_tpu/ops/pooling_pallas.py``. The forward
reads the activations once and derives the masked mean and the floored
standard deviation from one pass of sums (CUDA kernel
``csrc/stats_pooling.cu``). The backward is the analytic formula of the JAX
custom VJP (``_bwd``, jnp there); here it is a CUDA kernel too
(``csrc/stats_pooling_bwd.cu``), which reads x once and writes the
gradient once, from a persistent grid whose plan :func:`backward_plan`
computes.
"""

from __future__ import annotations

import collections
import ctypes

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


def masked_stats_pooling_backward_plain(
    x: torch.Tensor, mask: torch.Tensor, out: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Plain version of the backward (pooling_pallas.py:100-116): d mean/dx
    = m/n, d std/dx = m (x - mean) / (n std), zero where the variance was
    floored. In float32 whatever x's dtype, as the kernel computes it, and
    rounded to x's dtype once."""
    d = x.shape[-1]
    of, gf = out.to(torch.float32), g.to(torch.float32)
    mean, std = of[:, None, :d], of[:, None, d:]
    g_mean, g_std = gf[:, None, :d], gf[:, None, d:]
    m = mask.to(torch.float32)[:, :, None]
    inv_n = 1.0 / torch.clamp_min(torch.sum(m, dim=1, keepdim=True), 1.0)
    floored = (std * std <= VAR2STD_EPSILON * (1 + 1e-6)).to(torch.float32)
    gx = m * inv_n * g_mean
    gx = gx + m * inv_n * (x.to(torch.float32) - mean) / std * (g_std * (1.0 - floored))
    return gx.to(x.dtype)


_KERNELS = {
    torch.float32: "tfks_stats_pooling_f32",
    torch.bfloat16: "tfks_stats_pooling_bf16",
}
_BWD_KERNELS = {
    torch.float32: "tfks_stats_pooling_bwd_f32",
    torch.bfloat16: "tfks_stats_pooling_bwd_bf16",
}


# A split row's ranges hold this many ring stages of every warp.
BWD_ITEM_STAGES = 3

BackwardPlan = collections.namedtuple(
    "BackwardPlan", "blocks items frames_per_item tiles splits")
# What the kernel reports of itself on a device (csrc/stats_pooling_bwd.cu,
# tfks_stats_pooling_bwd_geometry): columns of an item's tile, frames of a
# stage of its ring of copies (every warp's: 32 in bf16, 16 in float32),
# the device's SMs and the blocks it keeps resident on each.
BackwardGeometry = collections.namedtuple(
    "BackwardGeometry", "cols stage_frames sms blocks_per_sm")


def backward_plan(b: int, l: int, d: int, geometry: BackwardGeometry) -> BackwardPlan:
    """The backward kernel's grid for x [b, l, d] on a device where the
    kernel has ``geometry``.

    Items are (row, tile, range) with the tile fastest, then the frame
    range: item k is tile k % tiles, range (k // tiles) % splits and row
    k // (tiles * splits); range s holds frames [s * frames_per_item,
    min(l, (s + 1) * frames_per_item)), and none is empty. ``blocks`` (all
    resident: at most sms x blocks_per_sm, at most items) blocks run; block
    i takes items i, i + blocks, ...

    A row stays one range where rows x tiles give at least two items a
    block. Otherwise its ranges are BWD_ITEM_STAGES ring stages of every
    warp long (96 frames in bf16, 48 in float32): each item costs its
    warps a round trip for its factors and the row's mask sum before they
    use their first copies, and on the card shorter items lost more to it
    than they gained in blocks that end together, while longer ones left
    the last blocks to finish alone (PERF.md, the backward's redesign)."""
    cols, stage_frames, sms, blocks_per_sm = geometry
    tiles = -(-d // cols)
    if b * l * d == 0:
        return BackwardPlan(0, 0, 0, tiles, 0)
    cap = sms * blocks_per_sm
    if cap < 1:
        raise ValueError("backward_plan: no resident block (%d SMs, %d a SM)"
                         % (sms, blocks_per_sm))
    rows = b * tiles
    frames = l if rows >= 2 * cap else min(l, BWD_ITEM_STAGES * stage_frames)
    splits = -(-l // frames)
    items = rows * splits
    return BackwardPlan(min(cap, items), items, frames, tiles, splits)


def backward_geometry(dtype: torch.dtype) -> BackwardGeometry:
    """The backward kernel's geometry for x of ``dtype`` on the current
    CUDA device, as the kernel's library reports it (cached there)."""
    geo = (ctypes.c_int * 4)()
    err = _build.load().tfks_stats_pooling_bwd_geometry(int(dtype == torch.bfloat16), geo)
    _build.check(err, "masked_stats_pooling_backward")
    return BackwardGeometry(*geo)


def _check_inputs(what, x, mask, kernels):
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError("%s: x (%s) and mask (%s) must be on one CUDA device"
                         % (what, x.device, mask.device))
    if x.dtype not in kernels or mask.dtype != torch.float32:
        raise TypeError("%s: needs float32 or bfloat16 x and a float32 mask, "
                        "got %s and %s" % (what, x.dtype, mask.dtype))
    if x.dim() != 3:
        raise ValueError("%s: x must be [B, L, D], got %s" % (what, tuple(x.shape)))
    b, l, d = x.shape
    if tuple(mask.shape) != (b, l):
        raise ValueError("%s: mask must be [%d, %d], got %s"
                         % (what, b, l, tuple(mask.shape)))
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("%s: inputs must be contiguous" % what)
    if b > 65535:
        raise ValueError("%s: at most 65535 rows, got %d" % (what, b))
    return b, l, d


def _stats_cuda(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    b, l, d = _check_inputs("masked_stats_pooling", x, mask, _KERNELS)
    out = torch.empty((b, 2 * d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _KERNELS[x.dtype])(
            x.data_ptr(), mask.data_ptr(), out.data_ptr(), b, l, d, stream)
    _build.check(err, "masked_stats_pooling")
    _build.count_launch(masked_stats_pooling, (b, l, d), str(x.dtype)[6:])
    return out


def masked_stats_pooling_backward(
    x: torch.Tensor, mask: torch.Tensor, out: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Gradient of the pooling with respect to x: x [B, L, D], mask [B, L],
    the forward's out [B, 2D] and the incoming gradient g [B, 2D] ->
    [B, L, D] in x's dtype.

    CPU tensors take :func:`masked_stats_pooling_backward_plain`; CUDA
    tensors launch the kernel, and anything it does not take raises."""
    if all(t.device.type == "cpu" for t in (x, mask, out, g)):
        return masked_stats_pooling_backward_plain(x, mask, out, g)
    what = "masked_stats_pooling_backward"
    b, l, d = _check_inputs(what, x, mask, _BWD_KERNELS)
    for name, t in (("out", out), ("g", g)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("%s: %s must be %s on %s like x, got %s on %s"
                            % (what, name, x.dtype, x.device, t.dtype, t.device))
        if tuple(t.shape) != (b, 2 * d) or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous [%d, %d], got %s"
                             % (what, name, b, 2 * d, tuple(t.shape)))
    gx = torch.empty_like(x)
    if gx.numel() == 0:
        return gx
    lib = _build.load()
    with torch.cuda.device(x.device):
        plan = backward_plan(b, l, d, backward_geometry(x.dtype))
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _BWD_KERNELS[x.dtype])(
            x.data_ptr(), mask.data_ptr(), out.data_ptr(), g.data_ptr(), gx.data_ptr(),
            b, l, d, plan.blocks, plan.items, plan.frames_per_item, stream)
    _build.check(err, what)
    _build.count_launch(masked_stats_pooling_backward, (b, l, d), str(x.dtype)[6:])
    return gx


class MaskedStatsPooling(torch.autograd.Function):
    """The forward and backward kernels for CUDA tensors, the plain
    versions for CPU tensors."""

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
        return masked_stats_pooling_backward(x, mask, out, g.contiguous()), None


def masked_stats_pooling(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, D], [B, L] -> [B, 2D] (mean || floored stddev), differentiable
    in x. The mask is cast to a contiguous float32 tensor first, as the JAX
    wrapper casts it for its kernel."""
    return MaskedStatsPooling.apply(x, mask.to(torch.float32).contiguous())


# Kernel launches, and launches by ((B, L, D), dtype name), counted where
# each kernel is launched; chip_smoke.py reads them after the main path.
masked_stats_pooling.launches = 0
masked_stats_pooling.shapes = collections.Counter()
masked_stats_pooling_backward.launches = 0
masked_stats_pooling_backward.shapes = collections.Counter()
