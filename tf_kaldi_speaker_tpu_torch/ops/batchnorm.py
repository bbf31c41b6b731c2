"""Train-mode BatchNorm on the GPU: the batch statistics and the normalize
pass forward, the analytic backward in two passes.

No TPU kernel corresponds: the JAX package's BatchNorm is flax's
``nn.BatchNorm``, plain jnp that XLA fuses on the TPU. Here the arithmetic
of ``models/layers.py``'s :class:`BatchNorm` (flax's: float32 statistics,
the fast variance max(E[x²] - E[x]², 0), ``(x - mean) * (rsqrt(var + eps)
* scale) + bias`` rounded to x's dtype once, the running statistics moved
as ``r = m * r + (1 - m) * batch``) runs in CUDA kernels
(``csrc/batchnorm.cu``) instead of some twenty PyTorch launches a
direction over float32 copies, two passes over the activations each way:
forward, the sums of x and x² (then a small kernel that finishes each
channel's statistics) and the normalize pass; backward, the sums of g
and g (x - mean) (then the finish: dscale, dbias and dx's coefficients)
and the pass that writes dx.

They take x in two layouts, through its strides and without a copy:
``rows`` (x contiguous: dense layers, ResNet34's channels-last maps) and
``channels_first`` (the [B, ..., C] view of a contiguous [B, C, ...]: the
TDNN's and ECAPA's convolutions); :func:`batch_norm_train` copies x of
other strides into rows first. Over a data group (the module's ``group``)
the sums of each direction are all-reduced between its passes, so every
rank normalizes with the global batch's statistics. The module trains
every BatchNorm of a card through :func:`batch_norm_train`, and keeps its
plain code for CPU tensors. :func:`batch_norm_train_plain` and
:func:`batch_norm_train_backward_plain` are the plain versions of the
kernels' arithmetic, which the CPU tests hold against autograd of the
module's plain forward and the card's tests hold the kernels against.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import _build

ROWS, CHANNELS_FIRST = "rows", "channels_first"
# csrc/batchnorm.cu's blocks: 512 threads; rows: `tile` vector columns (a
# power of 2 up to MAX_TILE) by 512 / tile rows; channels-first: one
# channel a warp, WARP_CHANNELS a block.
THREADS, MAX_TILE, WARP_CHANNELS = 512, 128, 16
# Blocks the splits aim for on each SM: the kernels keep two of 512
# threads resident.
BLOCKS_PER_SM = 2
# The fewest passes of a block's rows a split of the rows layout takes, so
# that a small batch ([256, 512]) is a few blocks.
MIN_PASSES = 4

# units: the grid's first axis (rows: tiles; channels-first: groups of
# WARP_CHANNELS channels); splits: rows (or runs) ranges, one block of each
# unit each; per_split: rows (or runs) a range holds; tile: see above (1
# for channels-first, where it is not read).
Plan = collections.namedtuple("Plan", "units splits per_split tile")

_DTYPES = (torch.bfloat16, torch.float32)


def layout(x: torch.Tensor) -> Optional[str]:
    """``rows`` for a contiguous x, ``channels_first`` for the [B, ..., C]
    view of a contiguous [B, C, ...], else None."""
    if x.is_contiguous():
        return ROWS
    if x.dim() >= 3 and x.movedim(-1, 1).is_contiguous():
        return CHANNELS_FIRST
    return None


def vector_width(esize: int, ptrs, multiple_of: int) -> int:
    """Elements an access of the kernels moves: 16 bytes, else 8, else one
    element, the widest for which every address in ``ptrs`` is aligned and
    ``multiple_of`` (C for rows, the element count for channels-first) is a
    multiple of it."""
    for nbytes in (16, 8):
        ve = nbytes // esize
        if multiple_of % ve == 0 and all(p % nbytes == 0 for p in ptrs):
            return ve
    return 1


def plan(lay: str, outer: int, c: int, ve: int, sms: int) -> Plan:
    """The kernels' grid for ``outer`` rows (rows) or runs (channels-first)
    of ``c`` channels, ``ve`` elements an access, on a device of ``sms``
    SMs: about BLOCKS_PER_SM blocks an SM, no range empty, none under
    MIN_PASSES passes of a block's rows."""
    if lay == CHANNELS_FIRST:
        units, tile, least = -(-c // WARP_CHANNELS), 1, 1
    else:
        w = c // ve
        tile = min(MAX_TILE, 1 << (w - 1).bit_length())
        units, least = -(-w // tile), MIN_PASSES * (THREADS // tile)
    splits = max(1, min(round(BLOCKS_PER_SM * sms / units), -(-outer // least), 65535))
    per = -(-outer // splits)
    return Plan(units, -(-outer // per), per, tile)


def _fusable(x, scale, bias, running_mean, running_var) -> bool:
    c = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or x.dim() < 2 or x.numel() == 0 or layout(x) is None:
        return False
    if scale.dtype not in _DTYPES or bias.dtype != scale.dtype:
        return False
    for t, dtype in ((scale, None), (bias, None), (running_mean, torch.float32),
                     (running_var, torch.float32)):
        if (t.device != x.device or tuple(t.shape) != (c,) or not t.is_contiguous()
                or dtype is not None and t.dtype != dtype):
            return False
    return True


def batch_norm_train_plain(x, scale, bias, running_mean, running_var, momentum: float,
                           eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels: y, and ``stat`` [4, C] (mean,
    inv = rsqrt(var + eps), mul = inv * scale, and 1 where E[x²] - mean² >=
    0, else 0) in float32 (float64 for a float64 x); moves the running
    statistics in place. The same operations as the module's plain
    forward, so the same numbers."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(x.dim() - 1))
    mean = torch.mean(xf, dim=dims)
    raw = torch.mean(xf * xf, dim=dims) - mean * mean
    var = torch.clamp_min(raw, 0.0)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    inv = torch.rsqrt(var + eps)
    mul = inv * scale.to(xf.dtype)
    y = ((xf - mean) * mul + bias.to(xf.dtype)).to(x.dtype)
    return y, torch.stack([mean, inv, mul, (raw >= 0).to(xf.dtype)])


def batch_norm_train_backward_plain(x: torch.Tensor, g: torch.Tensor, stat: torch.Tensor,
                                    param_dtype: torch.dtype
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dx, dscale, dbias) from x,
    the incoming gradient g and the forward's ``stat``. With n rows a
    channel, sg = sum(g) and sgx = sum(g (x - mean)):
    dx = mul g + k2 (x - mean) + k3, k2 = -mul inv² sgx / n where the
    clamp let the variance through (else 0), k3 = -mul sg / n;
    dscale = sgx inv, dbias = sg, rounded to ``param_dtype``. In stat's
    dtype, dx rounded to x's once."""
    xf, gf = x.to(stat.dtype), g.to(stat.dtype)
    mean, inv, mul, flow = stat.unbind(0)
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    d = xf - mean
    sg = torch.sum(gf, dim=dims)
    sgx = torch.sum(gf * d, dim=dims)
    k2 = torch.where(flow != 0, -(mul * inv * inv) * (sgx / n), torch.zeros_like(sgx))
    k3 = -mul * (sg / n)
    dx = (mul * gf + k2 * d + k3).to(x.dtype)
    return dx, (sgx * inv).to(param_dtype), sg.to(param_dtype)


# ---------------------------------------------------------------------------
# The kernels

_sms: Dict[int, int] = {}


class _Launch:
    """One call's geometry on x's device: layout, outer, inner, C, the
    vector width over ``ptrs``, the plan, and the workspace of the blocks'
    sums."""

    def __init__(self, x: torch.Tensor, ptrs):
        c = x.shape[-1]
        self.cf = layout(x) == CHANNELS_FIRST
        n = x.numel() // c
        self.c = c
        self.outer = x.shape[0] if self.cf else n
        self.inner = n // self.outer if self.cf else 1
        self.bf16 = int(x.dtype == torch.bfloat16)
        self.ve = vector_width(x.element_size(), ptrs, x.numel() if self.cf else c)
        dev = x.device.index
        if dev not in _sms:
            _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        self.plan = plan(CHANNELS_FIRST if self.cf else ROWS, self.outer, c, self.ve, _sms[dev])
        self.stream = torch.cuda.current_stream(x.device).cuda_stream
        # 1 / n as torch.mean scales its sum: C / numel in float32
        self.factor = float(np.float32(c) / np.float32(x.numel()))
        self.partial = torch.empty(self.plan.splits * 2 * c, dtype=torch.float32,
                                   device=x.device)
        self.key = ((x.shape[0], n // x.shape[0], c),
                    str(x.dtype)[6:] + (".channels_first" if self.cf else ""))

    def geometry(self):
        return (self.outer, self.inner, self.c, self.plan.splits, self.plan.per_split,
                self.plan.tile)


def _stats(x, scale, running_mean, running_var, stat, momentum, eps, launch):
    err = _build.load().tfks_bn_train_stats(
        launch.bf16, int(launch.cf), launch.ve, x.data_ptr(), scale.data_ptr(),
        int(scale.dtype == torch.bfloat16), running_mean.data_ptr(), running_var.data_ptr(),
        stat.data_ptr(), launch.partial.data_ptr(), *launch.geometry(), launch.factor, eps,
        momentum, 1.0 - momentum, launch.stream)
    _build.check(err, "batch_norm_train (statistics)")


def _normalize(x, y, stat, bias, launch):
    err = _build.load().tfks_bn_train_normalize(
        launch.bf16, int(launch.cf), launch.ve, x.data_ptr(), y.data_ptr(), stat.data_ptr(),
        bias.data_ptr(), int(bias.dtype == torch.bfloat16), *launch.geometry(), launch.stream)
    _build.check(err, "batch_norm_train (normalize)")


def _grad_stats(x, g, stat, coef, dscale, dbias, launch):
    err = _build.load().tfks_bn_train_grad_stats(
        launch.bf16, int(launch.cf), launch.ve, x.data_ptr(), g.data_ptr(), stat.data_ptr(),
        coef.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
        int(dscale.dtype == torch.bfloat16), launch.partial.data_ptr(), *launch.geometry(),
        launch.factor, launch.stream)
    _build.check(err, "batch_norm_train_backward (sums)")


def _sums(x, g, stat, totals, copy, launch):
    """A group's pass: the sums of x and x² (g None) or of g and
    g (x - mean) into ``totals`` [2, C] (and ``copy``)."""
    grad = g is not None
    err = _build.load().tfks_bn_train_sums(
        launch.bf16, int(launch.cf), launch.ve, int(grad), x.data_ptr(),
        (g if grad else x).data_ptr(), stat.data_ptr() if grad else None,
        launch.partial.data_ptr(), totals.data_ptr(), copy.data_ptr() if grad else None,
        *launch.geometry(), launch.stream)
    _build.check(err, "batch_norm_train%s (group sums)" % ("_backward" if grad else ""))


def _grad(x, g, dx, stat, coef, launch):
    err = _build.load().tfks_bn_train_grad(
        launch.bf16, int(launch.cf), launch.ve, x.data_ptr(), g.data_ptr(), dx.data_ptr(),
        stat.data_ptr(), coef.data_ptr(), *launch.geometry(), launch.stream)
    _build.check(err, "batch_norm_train_backward (dx)")


def _forward_cuda(x, scale, bias, running_mean, running_var, momentum, eps, group=None):
    """y and ``stat``; with ``group``, also the group's row count (a float32
    [1] on the device), else None."""
    if not (x.device.type == "cuda" and _fusable(x, scale, bias, running_mean, running_var)):
        raise ValueError(
            "batch_norm_train: the kernels need a CUDA x in bf16 or float32, contiguous or "
            "channels-first, with [C] scale and bias of one dtype and float32 running "
            "statistics on its device; got x %s %s %s strides %s, scale %s, running %s"
            % (x.device, x.dtype, tuple(x.shape), x.stride(), scale.dtype, running_mean.dtype))
    c = x.shape[-1]
    y = torch.empty_like(x)
    stat = torch.empty((4, c), dtype=torch.float32, device=x.device)
    count = None
    with torch.cuda.device(x.device):
        launch = _Launch(x, (x.data_ptr(), y.data_ptr()))
        if group is None:
            _stats(x, scale, running_mean, running_var, stat, float(momentum), float(eps),
                   launch)
        else:
            # the rank's sums and its rows, all-reduced: the global batch's
            totals = torch.full((2 * c + 1,), float(x.numel() // c), dtype=torch.float32,
                                device=x.device)
            _sums(x, None, None, totals, None, launch)
            dist.all_reduce(totals, group=group)
            count = totals[2 * c:]
            err = _build.load().tfks_bn_train_finish(
                totals.data_ptr(), count.data_ptr(), c, scale.data_ptr(),
                int(scale.dtype == torch.bfloat16), running_mean.data_ptr(),
                running_var.data_ptr(), stat.data_ptr(), float(eps), float(momentum),
                1.0 - float(momentum), launch.stream)
            _build.check(err, "batch_norm_train (group finish)")
        _normalize(x, y, stat, bias, launch)
    _build.count_launch(batch_norm_train, *launch.key)
    return y, stat, count


def batch_norm_train_backward(x: torch.Tensor, g: torch.Tensor, stat: torch.Tensor,
                              param_dtype: torch.dtype, need_dx: bool = True, group=None,
                              count: Optional[torch.Tensor] = None
                              ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of the train-mode BatchNorm from a CUDA x, the
    incoming gradient g and the forward's ``stat``; dx None unless
    ``need_dx``. g is first copied into x's layout where its strides
    differ; anything the kernels do not take raises. With ``group`` (and
    the forward's ``count``), dx takes the group's sums of g and
    g (x - mean); dscale and dbias are the rank's own."""
    c = x.shape[-1]
    if (x.device.type != "cuda" or layout(x) is None or x.dtype not in _DTYPES
            or param_dtype not in _DTYPES
            or stat.dtype != torch.float32 or tuple(stat.shape) != (4, c)
            or not stat.is_contiguous() or stat.device != x.device):
        raise ValueError("batch_norm_train_backward: needs a bf16 or float32 CUDA x, rows or "
                         "channels-first, and its float32 [4, C] statistics")
    if g.dtype != x.dtype or g.stride() != x.stride() or g.device != x.device:
        g = torch.empty_like(x).copy_(g)
    coef = torch.empty((2, c), dtype=torch.float32, device=x.device)
    dscale = torch.empty(c, dtype=param_dtype, device=x.device)
    dbias = torch.empty(c, dtype=param_dtype, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    with torch.cuda.device(x.device):
        ptrs = (x.data_ptr(), g.data_ptr()) + ((dx.data_ptr(),) if need_dx else ())
        launch = _Launch(x, ptrs)
        if group is None or not need_dx:
            _grad_stats(x, g, stat, coef, dscale, dbias, launch)
        else:
            local = torch.empty(2 * c, dtype=torch.float32, device=x.device)
            totals = torch.empty_like(local)
            _sums(x, g, stat, local, totals, launch)
            dist.all_reduce(totals, group=group)
            err = _build.load().tfks_bn_train_grad_finish(
                totals.data_ptr(), local.data_ptr(), count.data_ptr(), c, stat.data_ptr(),
                coef.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                int(param_dtype == torch.bfloat16), launch.stream)
            _build.check(err, "batch_norm_train_backward (group finish)")
        if need_dx:
            _grad(x, g, dx, stat, coef, launch)
    _build.count_launch(batch_norm_train_backward, *launch.key)
    return dx, dscale, dbias


class BatchNormTrain(torch.autograd.Function):
    """The kernels. The running statistics move in place in the forward;
    x, ``stat`` (and a group's row count) are saved for the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, momentum, eps, group):
        y, stat, count = _forward_cuda(x, scale, bias, running_mean, running_var, momentum, eps,
                                       group)
        ctx.save_for_backward(x, stat, count)
        ctx.param_dtype = scale.dtype
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, g):
        x, stat, count = ctx.saved_tensors
        dx, dscale, dbias = batch_norm_train_backward(x, g, stat, ctx.param_dtype,
                                                      ctx.needs_input_grad[0], ctx.group, count)
        return dx, dscale, dbias, None, None, None, None, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, momentum: float,
                     eps: float, group=None) -> torch.Tensor:
    """Train-mode BatchNorm over the last axis of a CUDA x, differentiable
    in x, scale and bias; moves ``running_mean`` and ``running_var`` in
    place; with ``group``, over the group's whole batch. y has x's strides
    (rows where x's are neither layout's: x is copied into them) and
    dtype; anything else the kernels do not take raises."""
    if layout(x) is None:
        x = x.contiguous()
    return BatchNormTrain.apply(x, scale, bias, running_mean, running_var, momentum, eps, group)


# Launches of the forward's two kernels and of the backward's, by ((B, L,
# C), dtype name), L the elements between the first axis and the last, the
# name ending in ".channels_first" for that layout; chip_smoke.py reads
# them after a main path.
batch_norm_train.launches = 0
batch_norm_train.shapes = collections.Counter()
batch_norm_train_backward.launches = 0
batch_norm_train_backward.shapes = collections.Counter()
